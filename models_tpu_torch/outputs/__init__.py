from .base import (BinaryOutput, CategoricalOutput, CategoricalTarget, ColumnBasedSampleWeight,
                   DotProduct, EmbeddingTablePrediction, LogitsTemperatureScaler, ModelOutput,
                   OutputBlock, RegressionOutput)
from .contrastive import ContrastiveOutput, ContrastiveSampleWeight
from .queue import CachedCrossBatchSampler, FIFOQueue
from .sampling import Candidate, CandidateSampler, InBatchSampler, PopularityBasedSampler
from .tasks import NextItemPredictionTask, ParallelPredictionBlock, PredictionTasks
from .topk import BruteForce, TopKLayer, TopKOutput

# V1-style task names (reference tf/prediction_tasks/*): the same heads
from .base import BinaryOutput as BinaryClassificationTask
from .base import CategoricalOutput as MultiClassClassificationTask
from .base import RegressionOutput as RegressionTask
from .contrastive import ContrastiveOutput as ItemRetrievalTask

__all__ = [
    "BinaryOutput", "BruteForce", "CachedCrossBatchSampler", "Candidate", "CandidateSampler",
    "CategoricalOutput", "CategoricalTarget", "ColumnBasedSampleWeight", "ContrastiveOutput",
    "ContrastiveSampleWeight", "DotProduct", "EmbeddingTablePrediction", "FIFOQueue",
    "InBatchSampler", "LogitsTemperatureScaler", "ModelOutput", "NextItemPredictionTask",
    "OutputBlock", "ParallelPredictionBlock", "PopularityBasedSampler", "PredictionTasks",
    "RegressionOutput", "TopKLayer", "TopKOutput", "BinaryClassificationTask",
    "MultiClassClassificationTask", "RegressionTask", "ItemRetrievalTask",
]
