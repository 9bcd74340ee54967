from .base import Metric
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
    "AvgPrecisionAt", "MRRAt", "Metric", "NDCGAt", "PrecisionAt", "RecallAt", "TopKMetric",
    "TopKMetricsAggregator", "average_precision_at", "dcg_at", "extract_topk", "mrr_at",
    "ndcg_at", "precision_at", "recall_at",
]
