from .aggregation import ConcatFeatures, StackFeatures, sequence_mean, sequence_sum
from .block import Block
from .combinators import ParallelBlock, SequentialBlock
from .device import resolve_device
from .encoder import Encoder, TopKEncoder
from .types import ModelContext, Prediction, SequenceFeature, TopKPrediction

__all__ = [
    "Block", "ConcatFeatures", "Encoder", "ModelContext", "ParallelBlock",
    "Prediction", "SequenceFeature", "SequentialBlock", "StackFeatures", "TopKEncoder",
    "TopKPrediction", "resolve_device", "sequence_mean", "sequence_sum",
]
