from .base import (BinaryOutput, CategoricalOutput, CategoricalTarget, ColumnBasedSampleWeight,
                   LogitsTemperatureScaler, ModelOutput, OutputBlock, RegressionOutput)
from .contrastive import ContrastiveOutput
from .sampling import Candidate, CandidateSampler, InBatchSampler
from .topk import BruteForce, TopKOutput

__all__ = [
    "BinaryOutput", "BruteForce", "Candidate", "CandidateSampler", "CategoricalOutput",
    "CategoricalTarget", "ColumnBasedSampleWeight", "ContrastiveOutput", "InBatchSampler",
    "LogitsTemperatureScaler", "ModelOutput", "OutputBlock", "RegressionOutput", "TopKOutput",
]
