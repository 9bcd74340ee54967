from .aggregation import (ConcatFeatures, SequenceAggregator, SequenceLast, SequenceMax,
                          SequenceMean, SequenceMin, SequenceSum, StackFeatures, sequence_last,
                          sequence_max, sequence_mean, sequence_min, sequence_sum)
from .block import Block
from .combinators import ParallelBlock, SequentialBlock
from .device import resolve_device
from .encoder import EmbeddingEncoder, Encoder, TopKEncoder
from .types import MASK_KEY, ModelContext, Prediction, SequenceFeature, TopKPrediction

__all__ = [
    "Block", "ConcatFeatures", "EmbeddingEncoder", "Encoder", "MASK_KEY", "ModelContext", "ParallelBlock",
    "Prediction", "SequenceAggregator", "SequenceFeature", "SequenceLast", "SequenceMax",
    "SequenceMean", "SequenceMin", "SequenceSum", "SequentialBlock", "StackFeatures",
    "TopKEncoder", "TopKPrediction", "resolve_device", "sequence_last", "sequence_max",
    "sequence_mean", "sequence_min", "sequence_sum",
]
