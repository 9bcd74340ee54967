"""Loss functions (``models_tpu/losses.py``): the categorical cross-entropies
the contrastive head trains with, the binary cross-entropy of the binary head,
the mean squared and absolute errors of the regression head and the pairwise
ranking losses (BPR, TOP1 and their variants, logistic, hinge), under the JAX
package's names. Each takes (labels, logits, sample_weight) and returns a
scalar.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F

from .parallel.collectives import weight_total


def _weighted_mean(values: torch.Tensor, sample_weight: Optional[torch.Tensor]) -> torch.Tensor:
    if sample_weight is None:
        return values.mean()
    if sample_weight.ndim == 2 and sample_weight.shape[1] > 1:
        if values.ndim == 1 and values.shape[0] == sample_weight.shape[0]:
            sample_weight = sample_weight[:, 0]
        elif (values.ndim == 2 and values.shape[0] == sample_weight.shape[0]
              and sample_weight.shape[1] == values.shape[1] + 1):
            sample_weight = sample_weight[:, :1] * sample_weight[:, 1:]
    w = sample_weight.reshape(sample_weight.shape + (1,) * (values.ndim - sample_weight.ndim))
    w = w.expand(values.shape).to(values.dtype)
    return (values * w).sum() / weight_total(w.sum()).clamp_min(1e-9)


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


def _pos_neg_distance(logits):
    """(positive - negatives (B, N), negatives (B, N)): column 0 is the
    positive, as the contrastive head lays its logits out."""
    negs = logits[:, 1:]
    return logits[:, :1] - negs, negs


def bpr_loss(labels, logits, sample_weight=None):
    dist, _ = _pos_neg_distance(logits)
    return _weighted_mean(-F.logsigmoid(dist), sample_weight)


def bpr_max_loss(labels, logits, sample_weight=None, reg: float = 1.0):
    """BPR-max as the JAX package takes it, per element:
    ``-log(sigmoid(dist_j) * w_j) + reg * w_j * neg_j**2`` over (B, N), ``w``
    the softmax of the negatives; the published row-wise form is
    :func:`bpr_max_paper_loss`."""
    dist, negs = _pos_neg_distance(logits)
    w = torch.softmax(negs, dim=-1)
    per = -torch.log(torch.sigmoid(dist) * w + 1e-24) + reg * w * negs.square()
    return _weighted_mean(per, sample_weight)


def bpr_max_paper_loss(labels, logits, sample_weight=None, reg: float = 1.0):
    """BPR-max as published, per row:
    ``-log(sum_j w_j sigmoid(dist_j)) + reg * sum_j w_j neg_j**2``."""
    dist, negs = _pos_neg_distance(logits)
    w = torch.softmax(negs, dim=-1)
    per = -torch.log((w * torch.sigmoid(dist)).sum(dim=-1) + 1e-12)
    if reg:
        per = per + reg * (w * negs.square()).sum(dim=-1)
    return _weighted_mean(per, sample_weight)


def top1_loss(labels, logits, sample_weight=None):
    dist, negs = _pos_neg_distance(logits)
    per = (torch.sigmoid(-dist) + torch.sigmoid(negs.square())).mean(dim=-1)
    return _weighted_mean(per, sample_weight)


def top1_v2_loss(labels, logits, sample_weight=None):
    """TOP1 less the positive's own squared term over N."""
    pos, negs = logits[:, :1], logits[:, 1:]
    n = negs.shape[-1]
    per = (torch.sigmoid(negs - pos) + torch.sigmoid(negs.square())).mean(dim=-1)
    per = per - torch.sigmoid(pos[:, 0].square()) / max(n, 1)
    return _weighted_mean(per, sample_weight)


def top1_max_loss(labels, logits, sample_weight=None):
    """TOP1-max as the JAX package takes it: the softmax-weighted (B, N)
    elements, their mean over all of them."""
    dist, negs = _pos_neg_distance(logits)
    w = torch.softmax(negs, dim=-1)
    per = w * (torch.sigmoid(-dist) + torch.sigmoid(negs.square()))
    return _weighted_mean(per, sample_weight)


def logistic_loss(labels, logits, sample_weight=None):
    dist, _ = _pos_neg_distance(logits)
    return _weighted_mean(torch.log1p(torch.exp(-dist)), sample_weight)


def hinge_loss(labels, logits, sample_weight=None):
    dist, _ = _pos_neg_distance(logits)
    return _weighted_mean(torch.clamp_min(1.0 - dist, 0.0), sample_weight)


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
    "bpr": bpr_loss,
    "bpr-max": bpr_max_loss,
    "bpr_max": bpr_max_loss,
    "bpr-max-paper": bpr_max_paper_loss,
    "bpr_max_paper": bpr_max_paper_loss,
    "top1": top1_loss,
    "top1_v2": top1_v2_loss,
    "top1-v2": top1_v2_loss,
    "top1_max": top1_max_loss,
    "top1-max": top1_max_loss,
    "logistic": logistic_loss,
    "hinge": hinge_loss,
}


def get_loss(loss: Union[str, Callable]) -> Callable:
    if callable(loss):
        return loss
    if loss not in _LOSSES:
        raise KeyError(f"Unknown loss {loss!r}; known: {sorted(_LOSSES)}")
    return _LOSSES[loss]
