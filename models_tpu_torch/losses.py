"""Loss functions (``models_tpu/losses.py``): the categorical cross-entropies
the contrastive head trains with. Each takes (labels, logits, sample_weight)
and returns a scalar; the other losses of the JAX package are not ported yet.
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


_LOSSES = {
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
