"""Aggregations (``models_tpu/core/aggregation.py``): concatenation and
stacking of a dict of features, both in sorted key order, and the masked
mean and sum over a list column's axis 1."""

from __future__ import annotations

from typing import Union

import torch

from .block import Block
from .types import SequenceFeature, TensorDict


def _expand_2d(x: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 1) so scalars concatenate with embeddings."""
    return x[:, None] if x.ndim == 1 else x


class ConcatFeatures(Block):
    """Concatenate along the last axis, in SORTED key order (as the JAX
    package does, whatever order the producer built the dict in)."""

    def forward(self, inputs: TensorDict, **kwargs) -> torch.Tensor:
        vals = []
        for name in sorted(inputs):
            v = inputs[name]
            vals.append(_expand_2d(v.values if isinstance(v, SequenceFeature) else v))
        if len({v.ndim for v in vals}) > 1:
            raise ValueError("concat: mixed tensor ranks; pool sequence features first")
        return torch.cat(vals, dim=-1)


class StackFeatures(Block):
    """Stack equal-width features on a new axis (1: (B, F, D)), in SORTED
    key order; the input of the dot-product interaction."""

    def __init__(self, axis: int = 1):
        super().__init__()
        self.axis = axis

    def forward(self, inputs: TensorDict, **kwargs) -> torch.Tensor:
        vals = [v.values if isinstance(v, SequenceFeature) else v
                for v in (inputs[name] for name in sorted(inputs))]
        if len({v.ndim for v in vals}) > 1:
            raise ValueError("stack: mixed tensor ranks; pool sequence features first")
        return torch.stack(vals, dim=self.axis)


def sequence_mean(x: Union[torch.Tensor, SequenceFeature]) -> torch.Tensor:
    """Masked mean over axis 1; the count is clamped at 1 for empty rows."""
    if isinstance(x, SequenceFeature):
        m = x.mask[..., None].to(x.values.dtype)
        return (x.values * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
    return x.mean(dim=1)


def sequence_sum(x: Union[torch.Tensor, SequenceFeature]) -> torch.Tensor:
    """Masked sum over axis 1."""
    if isinstance(x, SequenceFeature):
        return (x.values * x.mask[..., None].to(x.values.dtype)).sum(dim=1)
    return x.sum(dim=1)


SEQUENCE_COMBINERS = {"mean": sequence_mean, "masked-mean": sequence_mean, "sum": sequence_sum}
