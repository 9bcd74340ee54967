"""Top-k ranking metrics (``models_tpu/metrics/topk.py``).

The functional forms (:func:`recall_at`, :func:`precision_at`,
:func:`average_precision_at`, :func:`ndcg_at`, :func:`mrr_at`) take a
relevance matrix already sorted by score, so that one sort serves every
metric (:class:`TopKMetricsAggregator`). ``num_relevant`` is an explicit
argument: corpus evaluation cuts the targets to the top k, and recall must
divide by the true number of relevant items (``label_relevant_counts``).
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Tuple

import torch

from ..ops.topk import stable_topk
from ..registry import metric_registry
from .base import Metric

_MASK32 = 0xFFFFFFFF


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor taken modulo 2**32 into int32's range, as JAX's int32
    sums wrap."""
    return ((x + 2**31) & _MASK32) - 2**31


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer mix (xor-shift-multiply) of int64 values in
    [0, 2**32); each product stays below 2**63."""
    x = x & _MASK32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x27D4EB2D) & _MASK32
    return x ^ (x >> 16)


def _column_permutation(scores: torch.Tensor, targets: torch.Tensor, seed: int) -> torch.Tensor:
    """A permutation of the columns, drawn on the device from a salt of the
    batch's bits: the sum of the scores' low 23 bits (wrapping as int32)
    xor the bits of the targets' rank-weighted sum, the JAX package's salt.
    The permutation is the stable argsort of a 32-bit hash of (column, salt,
    seed); it is not JAX's (``jax.random.permutation`` draws from the TPU's
    key), and both are uniform for practical purposes."""
    C = scores.shape[-1]
    tgt = targets.to(torch.float32)
    ranks = torch.arange(1, C + 1, dtype=torch.float32, device=scores.device)
    low = (scores.to(torch.float32).contiguous().view(torch.int32) & 0x7FFFFF).sum()
    weighted = (tgt * ranks).sum().view(torch.int32).to(torch.int64)
    salt = (_wrap_int32(low) ^ weighted) & _MASK32
    key = _hash32(salt + _hash32(torch.full((), seed, dtype=torch.int64, device=scores.device)))
    cols = torch.arange(C, dtype=torch.int64, device=scores.device)
    return torch.argsort(_hash32(cols * 0x9E3779B1 + key), stable=True)


def extract_topk(
    k: int,
    scores: torch.Tensor,
    targets: torch.Tensor,
    shuffle_ties: bool = True,
    seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Select once: the top-k scores (B, k), the targets' relevance at those
    positions (B, k) f32, and the positions (B, k) int64. ``k`` is clamped to
    the number of columns.

    The selection ranks by (score descending, position ascending), as
    ``lax.top_k`` (:func:`~models_tpu_torch.ops.topk.stable_topk`). With
    ``shuffle_ties`` the columns are first permuted (see
    :func:`_column_permutation`), so that equal scores rank in a random order
    and metrics on constant scores are unbiased. The tie
    order is random here as in the JAX package, but not the same order:
    results agree with JAX's exactly where no two scores of a row tie."""
    if shuffle_ties:
        perm = _column_permutation(scores, targets, seed)
        s, pidx = stable_topk(scores[:, perm], k)
        idx = perm[pidx]
    else:
        s, idx = stable_topk(scores, k)
    rel = torch.gather(targets.to(torch.float32), -1, idx)
    return s, rel, idx


def _ranks(k: int, device) -> torch.Tensor:
    return torch.arange(1, k + 1, dtype=torch.float32, device=device)


def _discounts(k: int, device) -> torch.Tensor:
    return 1.0 / torch.log2(torch.arange(2, k + 2, dtype=torch.float32, device=device))


def recall_at(k: int, rel: torch.Tensor, num_relevant: torch.Tensor) -> torch.Tensor:
    # the divisor is clipped to k: hits against the relevant items that k
    # positions can hold
    return rel[:, :k].sum(dim=1) / torch.clamp(num_relevant, 1.0, float(k))


def precision_at(k: int, rel: torch.Tensor, num_relevant: torch.Tensor) -> torch.Tensor:
    return rel[:, :k].sum(dim=1) / float(k)


def average_precision_at(k: int, rel: torch.Tensor, num_relevant: torch.Tensor) -> torch.Tensor:
    r = rel[:, :k]
    prec_at_i = torch.cumsum(r, dim=1) / _ranks(k, rel.device)
    return (prec_at_i * r).sum(dim=1) / torch.clamp_min(
        torch.clamp_max(num_relevant, float(k)), 1.0)


def dcg_at(k: int, rel: torch.Tensor, num_relevant: torch.Tensor) -> torch.Tensor:
    return (rel[:, :k] * _discounts(k, rel.device)).sum(dim=1)


def ndcg_at(k: int, rel: torch.Tensor, num_relevant: torch.Tensor) -> torch.Tensor:
    discounts = _discounts(k, rel.device)
    dcg = (rel[:, :k] * discounts).sum(dim=1)
    # ideal DCG: the first min(num_relevant, k) positions relevant
    pos = torch.arange(k, dtype=torch.float32, device=rel.device)
    hits = pos[None, :] < torch.clamp_max(num_relevant, float(k))[:, None]
    idcg = (hits * discounts[None, :]).sum(dim=1)
    return dcg / torch.clamp_min(idcg, 1e-9)


def mrr_at(k: int, rel: torch.Tensor, num_relevant: torch.Tensor) -> torch.Tensor:
    return (rel[:, :k] / _ranks(k, rel.device)).amax(dim=1)


_TOPK_FNS = {
    "recall_at": recall_at,
    "precision_at": precision_at,
    "map_at": average_precision_at,
    "ndcg_at": ndcg_at,
    "mrr_at": mrr_at,
}


def _weighted(vals: torch.Tensor, sample_weight) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of vals * w, sum of w), w = 1 without sample weights. No tensor
    is copied from the host (a training chunk is captured as a CUDA graph)."""
    if sample_weight is None:
        return vals.sum(), vals.new_full((), float(vals.shape[0]))
    w = sample_weight.reshape(-1).to(vals.dtype)
    return (vals * w).sum(), w.sum()


class TopKMetric(Metric):
    """One top-k metric; on unsorted scores it sorts them itself."""

    metric_fn_name: str = "recall_at"

    def __init__(self, k: int = 10, name: Optional[str] = None, pre_sorted: bool = False):
        self.k = k
        self.pre_sorted = pre_sorted
        self.clamped_k: Optional[int] = None
        self._clamp_warned = False
        super().__init__(name or f"{self.metric_fn_name}_{k}")

    @property
    def reported_name(self) -> str:
        """The log key. Over fewer candidates than ``k`` the metric is taken
        at that width and the key says so: ``recall_at_10`` over 8 candidates
        logs as ``recall_at_10_clamped_at_8``."""
        if self.clamped_k is not None:
            return f"{self.name}_clamped_at_{self.clamped_k}"
        return self.name

    def init_state(self, device=None):
        return {"total": torch.zeros((), device=device), "count": torch.zeros((), device=device)}

    def _compute(self, rel, num_relevant):
        k = min(self.k, rel.shape[1])
        if k < self.k:
            self.clamped_k = k
            if not self._clamp_warned:
                warnings.warn(f"{self.name}: only {rel.shape[1]} candidates available — "
                              f"computing @{k}; logged as {self.reported_name}", stacklevel=3)
                self._clamp_warned = True
        return _TOPK_FNS[self.metric_fn_name](k, rel, num_relevant)

    def update(self, state, outputs, targets, sample_weight=None, label_relevant_counts=None):
        if self.pre_sorted:
            if label_relevant_counts is None:
                # the top-k-cut relevance counts only the hits
                raise ValueError(f"{self.name}: pre_sorted=True requires label_relevant_counts "
                                 "(the top-k-truncated relevance cannot recover the total "
                                 "number of relevant items)")
            rel, num_rel = targets, label_relevant_counts
        else:
            _, rel, _ = extract_topk(self.k, outputs, targets)
            num_rel = (label_relevant_counts if label_relevant_counts is not None
                       else targets.to(torch.float32).sum(dim=-1))
        total, count = _weighted(self._compute(rel, num_rel), sample_weight)
        return {"total": state["total"] + total, "count": state["count"] + count}

    def result(self, state):
        return state["total"] / torch.clamp_min(state["count"], 1e-9)


@metric_registry.register("recall_at")
class RecallAt(TopKMetric):
    metric_fn_name = "recall_at"


@metric_registry.register("precision_at")
class PrecisionAt(TopKMetric):
    metric_fn_name = "precision_at"


@metric_registry.register("map_at")
class AvgPrecisionAt(TopKMetric):
    metric_fn_name = "map_at"


@metric_registry.register("ndcg_at")
class NDCGAt(TopKMetric):
    metric_fn_name = "ndcg_at"


@metric_registry.register("mrr_at")
class MRRAt(TopKMetric):
    metric_fn_name = "mrr_at"


class TopKMetricsAggregator(Metric):
    """Several top-k metrics from ONE shared sort."""

    def __init__(self, *metrics: TopKMetric, name: str = "topk_aggregator"):
        super().__init__(name)
        if not metrics:
            raise ValueError("TopKMetricsAggregator needs at least one metric")
        self.metrics = list(metrics)
        self.max_k = max(m.k for m in self.metrics)

    @classmethod
    def default(cls, k: int = 10) -> "TopKMetricsAggregator":
        """The reference's default evaluation metrics: recall, mrr, ndcg, map
        and precision @k."""
        return cls(RecallAt(k), MRRAt(k), NDCGAt(k), AvgPrecisionAt(k), PrecisionAt(k))

    @property
    def names(self) -> List[str]:
        return [m.name for m in self.metrics]

    def init_state(self, device=None):
        return {m.name: m.init_state(device) for m in self.metrics}

    def update(self, state, outputs, targets, sample_weight=None, label_relevant_counts=None):
        _, rel, _ = extract_topk(self.max_k, outputs, targets)
        num_rel = (label_relevant_counts if label_relevant_counts is not None
                   else targets.to(torch.float32).sum(dim=-1))
        new_state = {}
        for m in self.metrics:
            total, count = _weighted(m._compute(rel, num_rel), sample_weight)
            s = state[m.name]
            new_state[m.name] = {"total": s["total"] + total, "count": s["count"] + count}
        return new_state

    def result(self, state):
        # the state is keyed by the construction-time name, the log by the
        # reported one, which carries the clamp
        return {m.reported_name: m.result(state[m.name]) for m in self.metrics}
