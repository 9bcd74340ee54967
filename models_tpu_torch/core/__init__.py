from .aggregation import (ConcatFeatures, CosineSimilarity, ElementwiseMultiply, ElementwiseSum,
                          ElementwiseSumItemMulti, MaskedMean, SequenceAggregator, SequenceLast,
                          SequenceMax, SequenceMean, SequenceMin, SequenceSum, StackFeatures,
                          SumResidual, TabularAggregation, sequence_last, sequence_max,
                          sequence_mean, sequence_min, sequence_sum)
from .block import Block, Debug, Lambda, NoOp, as_block, call_block, fresh_copy, iter_blocks
from .combinators import (AsTabular, Cond, Filter, MapValues, ParallelBlock, ResidualBlock,
                          SequentialBlock, WithShortcut)
from .device import resolve_device
from .encoder import EmbeddingEncoder, Encoder, TopKEncoder
from .types import (MASK_KEY, ModelContext, Prediction, SequenceFeature, TopKPrediction,
                    prediction_mask_from_targets)

__all__ = [
    "AsTabular", "Block", "ConcatFeatures", "Cond", "CosineSimilarity", "Debug",
    "ElementwiseMultiply", "ElementwiseSum", "ElementwiseSumItemMulti", "EmbeddingEncoder",
    "Encoder", "Filter", "Lambda", "MASK_KEY", "MapValues", "MaskedMean", "ModelContext", "NoOp",
    "ParallelBlock", "Prediction", "ResidualBlock", "SequenceAggregator", "SequenceFeature",
    "SequenceLast", "SequenceMax", "SequenceMean", "SequenceMin", "SequenceSum",
    "SequentialBlock", "StackFeatures", "SumResidual", "TabularAggregation", "TopKEncoder",
    "TopKPrediction", "WithShortcut", "as_block", "call_block", "fresh_copy", "iter_blocks",
    "prediction_mask_from_targets", "resolve_device", "sequence_last", "sequence_max",
    "sequence_mean", "sequence_min", "sequence_sum",
]
