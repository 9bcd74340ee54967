from .bias import PopularityLogitsCorrection
from .negative_sampling import InBatchNegatives
from .regularization import L2Norm
from .sequence import (ExtractMaskFromTargets, ReplaceMaskedEmbeddings, SequenceMaskLast,
                       SequenceMaskLastInference, SequenceMaskRandom, SequencePredictLast,
                       SequencePredictNext, SequencePredictRandom, SequenceTargetAsInput,
                       SequenceTransform)

__all__ = ["ExtractMaskFromTargets", "InBatchNegatives", "L2Norm", "PopularityLogitsCorrection", "ReplaceMaskedEmbeddings", "SequenceMaskLast",
           "SequenceMaskLastInference", "SequenceMaskRandom", "SequencePredictLast",
           "SequencePredictNext", "SequencePredictRandom", "SequenceTargetAsInput",
           "SequenceTransform"]
