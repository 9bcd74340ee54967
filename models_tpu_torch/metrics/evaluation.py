"""Beyond-accuracy metrics of recommended top-k lists
(``models_tpu/metrics/evaluation.py``): novelty, popularity bias and catalog
coverage. Each takes the (B, >= k) recommended ids as its ``targets`` and an
item-frequency table given at construction; an id of -1 (a top-k list's
padding where k exceeds the valid candidates) counts for nothing."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..registry import metric_registry
from .base import Metric


class _TopKIdMetric(Metric):
    def __init__(self, item_frequencies, k: int = 10, name: Optional[str] = None):
        super().__init__(name)
        freqs = torch.as_tensor(np.asarray(item_frequencies, np.float32))
        self.probs = freqs / torch.clamp_min(freqs.sum(), 1.0)
        self.num_items = int(freqs.shape[0])
        self.k = k

    def _ids(self, targets) -> torch.Tensor:
        return targets.to(torch.int64)[:, : self.k]

    def _probs(self, ids: torch.Tensor) -> torch.Tensor:
        probs = self.probs.to(ids.device)
        return probs[ids.clamp(0, self.num_items - 1)]

    def init_state(self, device=None):
        return {"total": torch.zeros((), device=device), "count": torch.zeros((), device=device)}

    def _per_row(self, ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def update(self, state, outputs, targets, sample_weight=None, **kwargs):
        ids = self._ids(targets)
        valid = (ids >= 0).to(torch.float32)
        per = self._per_row(ids, valid)
        w = torch.ones_like(per) if sample_weight is None else (
            sample_weight.reshape(-1).to(torch.float32))
        return {"total": state["total"] + (per * w).sum(), "count": state["count"] + w.sum()}

    def result(self, state):
        return state["total"] / torch.clamp_min(state["count"], 1e-9)


@metric_registry.register("novelty_at")
class NoveltyAt(_TopKIdMetric):
    """Mean ``-log2`` popularity of the recommended items (higher: less
    obvious recommendations)."""

    name = "novelty_at"

    def _per_row(self, ids, valid):
        per = -torch.log2(torch.clamp_min(self._probs(ids), 1e-12)) * valid
        return per.sum(dim=1) / torch.clamp_min(valid.sum(dim=1), 1.0)


@metric_registry.register("popularity_bias_at")
class PopularityBiasAt(_TopKIdMetric):
    """Mean popularity of the recommended items."""

    name = "popularity_bias_at"

    def _per_row(self, ids, valid):
        return (self._probs(ids) * valid).sum(dim=1) / torch.clamp_min(valid.sum(dim=1), 1.0)


@metric_registry.register("item_coverage_at")
class ItemCoverageAt(_TopKIdMetric):
    """The share of the catalog recommended at least once. Its state is a
    seen-map of ``num_items + 1`` slots, the last taking the -1 padding."""

    name = "item_coverage_at"

    def init_state(self, device=None):
        return {"seen": torch.zeros(self.num_items + 1, dtype=torch.bool, device=device)}

    def update(self, state, outputs, targets, sample_weight=None, **kwargs):
        ids = self._ids(targets).reshape(-1)
        idx = torch.where((ids >= 0) & (ids < self.num_items), ids, self.num_items)
        seen = state["seen"].clone()
        seen[idx] = True
        return {"seen": seen}

    def result(self, state):
        return state["seen"][: self.num_items].to(torch.float32).mean()
