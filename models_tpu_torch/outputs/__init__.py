from .base import LogitsTemperatureScaler, ModelOutput
from .contrastive import ContrastiveOutput
from .sampling import Candidate, CandidateSampler, InBatchSampler
from .topk import BruteForce, TopKOutput

__all__ = [
    "BruteForce", "Candidate", "CandidateSampler", "ContrastiveOutput", "InBatchSampler",
    "LogitsTemperatureScaler", "ModelOutput", "TopKOutput",
]
