from .sequence import (ExtractMaskFromTargets, ReplaceMaskedEmbeddings, SequenceMaskLast,
                       SequenceMaskLastInference, SequenceMaskRandom, SequencePredictLast,
                       SequencePredictNext, SequencePredictRandom, SequenceTargetAsInput,
                       SequenceTransform)

__all__ = ["ExtractMaskFromTargets", "ReplaceMaskedEmbeddings", "SequenceMaskLast",
           "SequenceMaskLastInference", "SequenceMaskRandom", "SequencePredictLast",
           "SequencePredictNext", "SequencePredictRandom", "SequenceTargetAsInput",
           "SequenceTransform"]
