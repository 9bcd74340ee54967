"""Metric protocol (``models_tpu/metrics/base.py``): streaming metrics with an
explicit state, and the binary, regression and mean metrics of the ranking
heads.

A metric owns a small dictionary of tensors, its ``state``: ``init_state``
makes it on a device, ``update`` returns the next one from a batch's outputs
and targets without reading anything back to the host (so that a training
chunk captured as a CUDA graph replays it), and ``result`` gives the final
value as a tensor. The engine copies every result of an epoch to the host
at once. The binary metrics take logits and apply the sigmoid themselves.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from ..registry import metric_registry


class Metric:
    name: str = "metric"

    def __init__(self, name: Optional[str] = None):
        if name:
            self.name = name

    def init_state(self, device=None):
        raise NotImplementedError

    def update(self, state, outputs, targets, sample_weight=None):
        raise NotImplementedError

    def result(self, state):
        raise NotImplementedError

    @staticmethod
    def parse(m: Union[str, "Metric"]) -> "Metric":
        if isinstance(m, Metric):
            return m
        return metric_registry.parse(m)


def _zeros(device, *shape):
    return torch.zeros(shape, device=device)


def _flat_w(values: torch.Tensor, sample_weight) -> torch.Tensor:
    if sample_weight is None:
        return torch.ones_like(values)
    w = sample_weight.to(values.dtype)
    return w.reshape(w.shape + (1,) * (values.ndim - w.ndim)).expand(values.shape)


def _row_w(probs: torch.Tensor, sample_weight) -> torch.Tensor:
    return torch.ones_like(probs) if sample_weight is None else (
        sample_weight.reshape(-1).to(torch.float32))


class MeanMetric(Metric):
    """Weighted running mean of a per-example function."""

    def __init__(self, fn: Optional[Callable] = None, name: str = "mean"):
        super().__init__(name)
        self._fn = fn

    def init_state(self, device=None):
        return {"total": _zeros(device), "count": _zeros(device)}

    def per_example(self, outputs, targets):
        return outputs if self._fn is None else self._fn(outputs, targets)

    def update(self, state, outputs, targets, sample_weight=None):
        vals = self.per_example(outputs, targets)
        w = _flat_w(vals, sample_weight)
        return {"total": state["total"] + (vals * w).sum(), "count": state["count"] + w.sum()}

    def result(self, state):
        return state["total"] / state["count"].clamp_min(1e-9)


@metric_registry.register("binary_accuracy")
class BinaryAccuracy(MeanMetric):
    name = "binary_accuracy"

    def __init__(self, threshold: float = 0.5, name: str = "binary_accuracy"):
        super().__init__(name=name)
        self.threshold = threshold

    def per_example(self, outputs, targets):
        preds = (torch.sigmoid(outputs).reshape(-1) >= self.threshold).float()
        return (preds == targets.reshape(-1).float()).float()


class _Confusion(Metric):
    """Weighted counts of two cells of the confusion matrix at ``threshold``."""

    cells = ()

    def __init__(self, threshold: float = 0.5, name: Optional[str] = None):
        super().__init__(name)
        self.threshold = threshold

    def init_state(self, device=None):
        return {c: _zeros(device) for c in self.cells}

    def update(self, state, outputs, targets, sample_weight=None):
        probs = torch.sigmoid(outputs).reshape(-1)
        pred = probs >= self.threshold
        y = targets.reshape(-1) > 0.5
        w = _row_w(probs, sample_weight)
        masks = {"tp": pred & y, "fp": pred & ~y, "fn": ~pred & y}
        return {c: state[c] + (w * masks[c]).sum() for c in self.cells}


@metric_registry.register("precision")
class Precision(_Confusion):
    name = "precision"
    cells = ("tp", "fp")

    def result(self, state):
        return state["tp"] / (state["tp"] + state["fp"]).clamp_min(1e-9)


@metric_registry.register("recall")
class Recall(_Confusion):
    name = "recall"
    cells = ("tp", "fn")

    def result(self, state):
        return state["tp"] / (state["tp"] + state["fn"]).clamp_min(1e-9)


def auc_thresholds(num: int, eps: float = 1e-7) -> np.ndarray:
    """``jnp.linspace(-eps, 1 + eps, num)`` in float32 bit for bit as a
    jitted JAX step computes it (a probability on a threshold would flip a
    count if the two differed). JAX's formula is ``start * (1 - s) + stop * s``
    with ``s = i / (num - 1)``; XLA rewrites the division into a product with
    ``r = 1 / (num - 1)`` and ``stop * s`` into ``i * (stop * r)``, each
    operation rounded to float32, and appends ``stop`` itself."""
    f32 = np.float32
    start, stop = f32(0.0 - eps), f32(1.0 + eps)
    i = np.arange(num - 1, dtype=f32)
    r = f32(1) / f32(num - 1)
    out = start * (f32(1) - i * r) + i * (stop * r)
    return np.concatenate([out, [stop]]).astype(f32)


@metric_registry.register("auc")
class AUC(Metric):
    """Streaming ROC-AUC from threshold-bucketed confusion counts (200
    thresholds, trapezoid rule), Keras's approximation. The counts are
    float32 sums over the batch: exact while a threshold's weighted count
    stays below 2**24."""

    name = "auc"

    def __init__(self, num_thresholds: int = 200, name: str = "auc"):
        super().__init__(name)
        self.num_thresholds = num_thresholds
        self._thresholds: Dict[torch.device, torch.Tensor] = {}

    def thresholds(self, device) -> torch.Tensor:
        """The thresholds on ``device``, uploaded once (by ``init_state``,
        outside any captured graph)."""
        dev = torch.device(device if device is not None else "cpu")
        if dev not in self._thresholds:
            self._thresholds[dev] = torch.from_numpy(auc_thresholds(self.num_thresholds)).to(dev)
        return self._thresholds[dev]

    def init_state(self, device=None):
        self.thresholds(device)
        n = self.num_thresholds
        return {"tp": _zeros(device, n), "fp": _zeros(device, n), "pos": _zeros(device),
                "neg": _zeros(device)}

    def update(self, state, outputs, targets, sample_weight=None):
        probs = torch.sigmoid(outputs).reshape(-1)
        y = targets.reshape(-1).float()
        w = _row_w(probs, sample_weight)
        above = (probs[None, :] > self.thresholds(probs.device)[:, None]).float()  # (T, B)
        pos, neg = y * w, (1.0 - y) * w
        return {"tp": state["tp"] + (above * pos).sum(dim=1),
                "fp": state["fp"] + (above * neg).sum(dim=1),
                "pos": state["pos"] + pos.sum(), "neg": state["neg"] + neg.sum()}

    def result(self, state):
        tpr = state["tp"] / state["pos"].clamp_min(1e-9)
        fpr = state["fp"] / state["neg"].clamp_min(1e-9)
        # thresholds ascending: fpr descending
        return ((fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:]) / 2.0).sum()


@metric_registry.register("logloss")
class LogLoss(MeanMetric):
    """Binary cross-entropy of the logits, as a metric."""

    name = "logloss"

    def __init__(self, name: str = "logloss"):
        super().__init__(name=name)

    def per_example(self, outputs, targets):
        x = outputs.reshape(-1)
        y = targets.reshape(-1).float()
        return x.clamp_min(0) - x * y + torch.log1p(torch.exp(-x.abs()))


@metric_registry.register("rmse")
class RMSE(Metric):
    name = "rmse"

    def __init__(self, name: str = "rmse"):
        super().__init__(name)

    def init_state(self, device=None):
        return {"total": _zeros(device), "count": _zeros(device)}

    def update(self, state, outputs, targets, sample_weight=None):
        err = (outputs.reshape(-1) - targets.reshape(-1).float()).square()
        w = torch.ones_like(err) if sample_weight is None else sample_weight.reshape(-1)
        return {"total": state["total"] + (err * w).sum(), "count": state["count"] + w.sum()}

    def result(self, state):
        return torch.sqrt(state["total"] / state["count"].clamp_min(1e-9))


@metric_registry.register("mae")
class MAE(MeanMetric):
    name = "mae"

    def __init__(self, name: str = "mae"):
        super().__init__(name=name)

    def per_example(self, outputs, targets):
        return (outputs.reshape(-1) - targets.reshape(-1).float()).abs()
