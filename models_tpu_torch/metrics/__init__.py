from .base import (AUC, MAE, RMSE, BinaryAccuracy, LogLoss, MeanMetric, Metric, Precision,
                   Recall)
from .evaluation import ItemCoverageAt, NoveltyAt, PopularityBiasAt
from .topk import (
    AvgPrecisionAt,
    MRRAt,
    NDCGAt,
    PrecisionAt,
    RecallAt,
    TopKMetric,
    TopKMetricsAggregator,
    average_precision_at,
    dcg_at,
    extract_topk,
    mrr_at,
    ndcg_at,
    precision_at,
    recall_at,
)

__all__ = [
    "AUC", "AvgPrecisionAt", "BinaryAccuracy", "ItemCoverageAt", "LogLoss", "MAE", "MRRAt",
    "MeanMetric", "Metric", "NDCGAt", "NoveltyAt", "PopularityBiasAt", "Precision", "PrecisionAt", "RMSE", "Recall", "RecallAt", "TopKMetric",
    "TopKMetricsAggregator", "average_precision_at", "dcg_at", "extract_topk", "mrr_at",
    "ndcg_at", "precision_at", "recall_at",
]
