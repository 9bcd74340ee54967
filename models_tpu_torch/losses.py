"""Loss functions (``models_tpu/losses.py``): the categorical cross-entropies
the contrastive head trains with, the binary cross-entropy of the binary head
and the mean squared and absolute errors of the regression head, under the
JAX package's names. Each takes (labels, logits, sample_weight) and returns a
scalar; the pairwise ranking losses are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F


def _weighted_mean(values: torch.Tensor, sample_weight: Optional[torch.Tensor]) -> torch.Tensor:
    if sample_weight is None:
        return values.mean()
    w = sample_weight.reshape(sample_weight.shape + (1,) * (values.ndim - sample_weight.ndim))
    w = w.expand(values.shape).to(values.dtype)
    return (values * w).sum() / w.sum().clamp_min(1e-9)


def categorical_crossentropy(labels, logits, sample_weight=None):
    """Dense (one-hot or soft) targets over the logits' last axis."""
    per = -(labels.to(logits.dtype) * F.log_softmax(logits, dim=-1)).sum(dim=-1)
    return _weighted_mean(per, sample_weight)


def sparse_categorical_crossentropy(labels, logits, sample_weight=None):
    """Integer class targets."""
    labels = labels.reshape(labels.shape[:1] + logits.shape[1:-1]).long()
    per = -F.log_softmax(logits, dim=-1).gather(-1, labels[..., None])[..., 0]
    return _weighted_mean(per, sample_weight)


def binary_crossentropy(labels, logits, sample_weight=None):
    """From logits, in a stable form (the JAX package's is ``max(x, 0) - x y
    + log1p(exp(-|x|))``; the two agree to the last bits). Its gradient is
    ``sigmoid(x) - y`` everywhere: torch would take that form's max and
    abs at x = 0 as 1 and 0 (a dead ReLU layer gives such logits), where
    JAX's max splits the tie."""
    labels = labels.reshape(logits.shape).to(logits.dtype)
    per = F.binary_cross_entropy_with_logits(logits, labels, reduction="none")
    return _weighted_mean(per, sample_weight)


def mean_squared_error(labels, logits, sample_weight=None):
    labels = labels.reshape(logits.shape).to(logits.dtype)
    return _weighted_mean((labels - logits).square(), sample_weight)


def mean_absolute_error(labels, logits, sample_weight=None):
    labels = labels.reshape(logits.shape).to(logits.dtype)
    return _weighted_mean((labels - logits).abs(), sample_weight)


_LOSSES = {
    "binary_crossentropy": binary_crossentropy,
    "bce": binary_crossentropy,
    "mse": mean_squared_error,
    "mean_squared_error": mean_squared_error,
    "mae": mean_absolute_error,
    "mean_absolute_error": mean_absolute_error,
    "categorical_crossentropy": categorical_crossentropy,
    "cce": categorical_crossentropy,
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "sparse_cce": sparse_categorical_crossentropy,
}


def get_loss(spec: Union[str, Callable]) -> Callable:
    if callable(spec):
        return spec
    if spec not in _LOSSES:
        raise NotImplementedError(
            f"loss {spec!r} is not ported yet (ROADMAP.md queue 1); ported: {sorted(_LOSSES)}")
    return _LOSSES[spec]
