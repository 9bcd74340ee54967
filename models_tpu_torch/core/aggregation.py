"""Aggregations (``models_tpu/core/aggregation.py``): concatenation and
stacking of a dict of features, both in sorted key order, the masked mean,
sum, max, min and last value over a list column's axis 1, and the
sequence aggregators that pool every 3-D input by one of them and
concatenate."""

from __future__ import annotations

from typing import Union

import torch

from .block import Block
from .types import SequenceFeature, TensorDict


# the fill of the masked max and min: float32's lowest over 2, as the JAX
# module takes it (not core.constants.MIN_FLOAT, the logits' sentinel)
MIN_FLOAT = torch.finfo(torch.float32).min / 2.0


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


def sequence_max(x: Union[torch.Tensor, SequenceFeature]) -> torch.Tensor:
    """Masked max over axis 1 (``MIN_FLOAT`` for an empty row)."""
    if isinstance(x, SequenceFeature):
        return torch.where(x.mask[..., None], x.values, MIN_FLOAT).amax(dim=1)
    return x.amax(dim=1)


def sequence_min(x: Union[torch.Tensor, SequenceFeature]) -> torch.Tensor:
    """Masked min over axis 1 (``-MIN_FLOAT`` for an empty row)."""
    if isinstance(x, SequenceFeature):
        return torch.where(x.mask[..., None], x.values, -MIN_FLOAT).amin(dim=1)
    return x.amin(dim=1)


def sequence_last(x: Union[torch.Tensor, SequenceFeature]) -> torch.Tensor:
    """The value at each row's last valid position, ``lengths - 1`` (position
    0 for an empty row)."""
    if isinstance(x, SequenceFeature):
        idx = (x.lengths() - 1).clamp_min(0).long()
        return x.values[torch.arange(x.values.shape[0], device=idx.device), idx]
    return x[:, -1]


SEQUENCE_COMBINERS = {
    "mean": sequence_mean,
    "masked-mean": sequence_mean,
    "sum": sequence_sum,
    "max": sequence_max,
    "min": sequence_min,
    "last": sequence_last,
}


class SequenceAggregator(Block):
    """Pool every 3-D input over axis 1 by a named combiner, pass 2-D inputs
    as they are, and concatenate (:class:`ConcatFeatures`)."""

    def __init__(self, combiner: str = "mean"):
        super().__init__()
        if combiner not in SEQUENCE_COMBINERS:
            raise ValueError(f"Unknown combiner {combiner}; options {sorted(SEQUENCE_COMBINERS)}")
        self.combiner = combiner

    def forward(self, inputs: TensorDict, **kwargs) -> torch.Tensor:
        fn = SEQUENCE_COMBINERS[self.combiner]
        out = {}
        for name, v in inputs.items():
            arr = v.values if isinstance(v, SequenceFeature) else v
            out[name] = fn(v) if arr.ndim == 3 else arr
        return ConcatFeatures()(out)


class SequenceMean(SequenceAggregator):
    def __init__(self):
        super().__init__("mean")


class SequenceSum(SequenceAggregator):
    def __init__(self):
        super().__init__("sum")


class SequenceMax(SequenceAggregator):
    def __init__(self):
        super().__init__("max")


class SequenceMin(SequenceAggregator):
    def __init__(self):
        super().__init__("min")


class SequenceLast(SequenceAggregator):
    def __init__(self):
        super().__init__("last")
