from .base import (BinaryOutput, CategoricalOutput, CategoricalTarget, ColumnBasedSampleWeight,
                   EmbeddingTablePrediction, LogitsTemperatureScaler, ModelOutput, OutputBlock,
                   RegressionOutput)
from .contrastive import ContrastiveOutput
from .sampling import Candidate, CandidateSampler, InBatchSampler, PopularityBasedSampler
from .topk import BruteForce, TopKOutput

__all__ = [
    "BinaryOutput", "BruteForce", "Candidate", "CandidateSampler", "CategoricalOutput",
    "CategoricalTarget", "ColumnBasedSampleWeight", "ContrastiveOutput",
    "EmbeddingTablePrediction", "InBatchSampler", "LogitsTemperatureScaler", "ModelOutput",
    "OutputBlock", "PopularityBasedSampler", "RegressionOutput", "TopKOutput",
]
