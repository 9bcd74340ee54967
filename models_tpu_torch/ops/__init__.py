from .topk import (
    NEG_INF,
    binned_rescore,
    binned_rescore_plain,
    binned_topk,
    blockwise_topk,
    streaming_topk,
    streaming_topk_plain,
    topk_route,
    topk_scores,
)

__all__ = [
    "NEG_INF", "binned_rescore", "binned_rescore_plain", "binned_topk",
    "blockwise_topk", "streaming_topk", "streaming_topk_plain", "topk_route",
    "topk_scores",
]
