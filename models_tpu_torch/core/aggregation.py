"""Aggregations (``models_tpu/core/aggregation.py``): dict -> tensor
merges, registered by name (``"concat"``, ``"stack"``, ``"sum"`` /
``"element-wise-sum"``, ``"sum-residual"``, ``"element-wise-multiply"``,
``"element-wise-sum-item-multi"``, ``"cosine"``, ``"masked_mean"``, the
``"sequence-*"`` aggregators) and parsed by
:meth:`TabularAggregation.parse`; the masked mean, sum, max, min and last
value over a list column's axis 1. Concatenation, stacking, sums and
products take the features in sorted key order, as the JAX package does
whatever order the producer built the dict in."""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..registry import aggregation_registry
from .block import Block
from .types import SequenceFeature, TensorDict


# the fill of the masked max and min: float32's lowest over 2, as the JAX
# module takes it (not core.constants.MIN_FLOAT, the logits' sentinel)
MIN_FLOAT = torch.finfo(torch.float32).min / 2.0


def _expand_2d(x: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 1) so scalars concatenate with embeddings."""
    return x[:, None] if x.ndim == 1 else x


def _as_array(v):
    return v.values if isinstance(v, SequenceFeature) else v


def _values(inputs: TensorDict) -> list:
    return [_as_array(inputs[k]) for k in sorted(inputs)]


class TabularAggregation(Block):
    """Base of the dict -> tensor aggregations."""

    @staticmethod
    def parse(agg) -> Optional[Block]:
        """None, a block (as it is) or a registered name (an instance)."""
        if agg is None or isinstance(agg, Block):
            return agg
        return aggregation_registry.parse(agg)


@aggregation_registry.register("concat")
class ConcatFeatures(TabularAggregation):
    """Concatenate along ``axis`` (the last), in SORTED key order; (B,)
    features as (B, 1). Where an input is a :class:`SequenceFeature` and
    the result is 3-D, it is a SequenceFeature with the mask of the first
    sequence input in sorted key order (the JAX block takes the first in its
    dict's order, which under ``jax.jit`` is the sorted one)."""

    def __init__(self, axis: int = -1):
        super().__init__()
        self.axis = axis

    def forward(self, inputs: TensorDict, **kwargs):
        mask = next((inputs[n].mask for n in sorted(inputs)
                     if isinstance(inputs[n], SequenceFeature)), None)
        vals = [_expand_2d(v) for v in _values(inputs)]
        if len({v.ndim for v in vals}) > 1:
            raise ValueError("concat: mixed tensor ranks; pool sequence features first")
        out = torch.cat(vals, dim=self.axis)
        if mask is not None and out.ndim == 3:
            return SequenceFeature(out, mask)
        return out


@aggregation_registry.register("stack")
class StackFeatures(TabularAggregation):
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


@aggregation_registry.register_with_multiple_names("sum", "element-wise-sum")
class ElementwiseSum(TabularAggregation):
    """The features' sum, (B,) features as (B, 1)."""

    def forward(self, inputs: TensorDict, **kwargs) -> torch.Tensor:
        vals = [_expand_2d(v) for v in _values(inputs)]
        out = vals[0]
        for v in vals[1:]:
            out = out + v
        return out


@aggregation_registry.register("sum-residual")
class SumResidual(TabularAggregation):
    """The sum over every feature but the shortcut of ``activation(feature +
    shortcut)``, in the dict's order."""

    def __init__(self, activation=None, shortcut_name: str = "shortcut"):
        super().__init__()
        self.activation = activation
        self.shortcut_name = shortcut_name

    def forward(self, inputs: TensorDict, **kwargs) -> torch.Tensor:
        from ..blocks.mlp import get_activation

        act = get_activation(self.activation)
        shortcut = _as_array(inputs[self.shortcut_name])
        out = None
        for name, v in inputs.items():
            if name == self.shortcut_name:
                continue
            v = _as_array(v) + shortcut
            if act is not None:
                v = act(v)
            out = v if out is None else out + v
        return out


@aggregation_registry.register("element-wise-multiply")
class ElementwiseMultiply(TabularAggregation):
    def forward(self, inputs: TensorDict, **kwargs) -> torch.Tensor:
        vals = _values(inputs)
        out = vals[0]
        for v in vals[1:]:
            out = out * v
        return out


@aggregation_registry.register("element-wise-sum-item-multi")
class ElementwiseSumItemMulti(TabularAggregation):
    """The one 3-D input (item embeddings over a sequence) plus the sum of
    the 2-D context features, broadcast over its axis 1."""

    def forward(self, inputs: TensorDict, **kwargs) -> torch.Tensor:
        seq = [_as_array(v) for v in inputs.values() if _as_array(v).ndim == 3]
        ctx = {k: v for k, v in inputs.items() if _as_array(v).ndim == 2}
        if len(seq) != 1:
            raise ValueError("element-wise-sum-item-multi expects exactly one 3-D input")
        item = seq[0]
        if ctx:
            item = item + ElementwiseSum()(ctx)[:, None, :]
        return item


@aggregation_registry.register("cosine")
class CosineSimilarity(TabularAggregation):
    """Row-wise cosine similarity of exactly two features, (B, 1)."""

    def forward(self, inputs: TensorDict, **kwargs) -> torch.Tensor:
        vals = _values(inputs)
        if len(vals) != 2:
            raise ValueError("cosine aggregation needs exactly 2 inputs")
        a, b = vals
        a = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-12)
        b = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True) + 1e-12)
        return (a * b).sum(dim=-1, keepdim=True)


@aggregation_registry.register("masked_mean")
class MaskedMean(TabularAggregation):
    """Each feature's masked mean over axis 1, concatenated."""

    def forward(self, inputs: TensorDict, **kwargs) -> torch.Tensor:
        return ConcatFeatures()({name: sequence_mean(v) for name, v in inputs.items()})


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


class SequenceAggregator(TabularAggregation):
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


@aggregation_registry.register("sequence-mean")
class SequenceMean(SequenceAggregator):
    def __init__(self):
        super().__init__("mean")


@aggregation_registry.register("sequence-sum")
class SequenceSum(SequenceAggregator):
    def __init__(self):
        super().__init__("sum")


@aggregation_registry.register("sequence-max")
class SequenceMax(SequenceAggregator):
    def __init__(self):
        super().__init__("max")


@aggregation_registry.register("sequence-min")
class SequenceMin(SequenceAggregator):
    def __init__(self):
        super().__init__("min")


@aggregation_registry.register("sequence-last")
class SequenceLast(SequenceAggregator):
    def __init__(self):
        super().__init__("last")
