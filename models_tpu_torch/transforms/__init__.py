from .bias import PopularityLogitsCorrection
from .features import (BroadcastToSequence, CategoryEncoding, ExpandDims, HashedCross,
                       HashedCrossAll, PrepareFeatures, ToTarget)
from .noise import StochasticSwapNoise
from .negative_sampling import InBatchNegatives
from .regularization import L2Norm
from .sequence import (ExtractMaskFromTargets, ReplaceMaskedEmbeddings, SequenceMaskLast,
                       SequenceMaskLastInference, SequenceMaskRandom, SequencePredictLast,
                       SequencePredictNext, SequencePredictRandom, SequenceTargetAsInput,
                       SequenceTransform)

__all__ = ["BroadcastToSequence", "CategoryEncoding", "ExpandDims", "HashedCross",
           "HashedCrossAll", "PrepareFeatures", "StochasticSwapNoise", "ToTarget",
           "ExtractMaskFromTargets", "InBatchNegatives", "L2Norm", "PopularityLogitsCorrection", "ReplaceMaskedEmbeddings", "SequenceMaskLast",
           "SequenceMaskLastInference", "SequenceMaskRandom", "SequencePredictLast",
           "SequencePredictNext", "SequencePredictRandom", "SequenceTargetAsInput",
           "SequenceTransform"]
