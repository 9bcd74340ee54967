"""Feature transforms (``models_tpu/transforms/features.py``):
``PrepareFeatures``, ``ToTarget``, ``CategoryEncoding``, ``HashedCross``,
``HashedCrossAll``, ``BroadcastToSequence`` and ``ExpandDims``.

``CategoryEncoding`` gives the dense (B, sum of cardinalities) one-hot,
multi-hot or count encoding, as the JAX package does; the Wide&Deep model's
wide path (``models/ranking.py``) computes its linear function without it.
The crossed buckets are the JAX package's bit for bit: its uint32 hash,
computed in int64 with the top bits masked.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.block import Block
from ..core.types import SequenceFeature, TensorDict
from ..schema import ColumnSchema, Schema, Tags

_MASK32 = 0xFFFFFFFF
_CROSS_SEED = 0x811C9DC5


def _from_values_offsets(values, offsets, max_len: int) -> SequenceFeature:
    """Ragged (values, offsets) -> a padded (B, max_len) SequenceFeature,
    rows cut at ``max_len``."""
    values, offsets = torch.as_tensor(values), torch.as_tensor(offsets, dtype=torch.int64)
    lengths = (offsets[1:] - offsets[:-1]).clamp_max(max_len)
    pos = torch.arange(max_len, device=values.device)
    mask = pos[None, :] < lengths[:, None]
    idx = (offsets[:-1, None] + pos[None, :]).clamp_max(max(len(values) - 1, 0))
    out = torch.where(mask, values[idx], torch.zeros((), dtype=values.dtype)) if len(values) \
        else torch.zeros(mask.shape, dtype=values.dtype)
    return SequenceFeature(out, mask)


class PrepareFeatures(Block):
    """A raw batch's list columns as SequenceFeatures: a ``(values, offsets)``
    pair is padded to the column's max length, a 2-D tensor wrapped with a
    full mask; the rest passes."""

    def __init__(self, schema: Schema):
        super().__init__(schema=schema)

    def forward(self, inputs: TensorDict, **kwargs):
        out = dict(inputs)
        for col in self.schema:
            v = out.get(col.name)
            if v is None:
                continue
            if isinstance(v, tuple) and len(v) == 2:
                out[col.name] = _from_values_offsets(v[0], v[1], col.max_seq_length or 1)
            elif (col.is_list and not isinstance(v, SequenceFeature) and hasattr(v, "ndim")
                  and v.ndim >= 2):
                out[col.name] = SequenceFeature(v)
        return out


class ToTarget(Block):
    """Move columns (names, tags or column schemas) from the features to the
    targets (the context's ``targets`` becomes the dict of them)."""

    def __init__(self, schema: Schema, *columns: Union[str, Tags, ColumnSchema]):
        names: List[str] = []
        for c in columns:
            if isinstance(c, ColumnSchema):
                names.append(c.name)
            elif isinstance(c, Tags):
                names.extend(schema.select_by_tag(c).column_names)
            else:
                names.append(str(c))
        super().__init__(schema=schema.select_by_name(names))
        self.names = names

    def forward(self, inputs: TensorDict, *, context=None, targets=None, **kwargs):
        out = dict(inputs)
        new_targets = dict(targets) if isinstance(targets, dict) else {}
        for n in self.names:
            if n in out:
                new_targets[n] = out.pop(n)
        if context is not None:
            context.targets = new_targets
        return out

    def transform_schema(self, schema: Schema) -> Schema:
        return schema.map(lambda c: c.with_tags(Tags.TARGET) if c.name in self.names else c)


def _encode(ids: torch.Tensor, weight: torch.Tensor, card: int, binary: bool) -> torch.Tensor:
    """(B, n) ids with (B, n) weights -> (B, card): the weights summed at each
    id (capped at 1 where ``binary``); ids outside [0, card) count nowhere,
    as ``jax.nn.one_hot`` makes them zero rows."""
    ids = ids.to(torch.int64)
    valid = (ids >= 0) & (ids < card)
    out = torch.zeros(ids.shape[0], card, device=ids.device)
    out.scatter_add_(1, torch.where(valid, ids, 0), (weight * valid).to(out.dtype))
    return out.clamp_max(1.0) if binary else out


class CategoryEncoding(Block):
    """The categorical columns as dense one-hot / multi-hot / count
    encodings, concatenated: (B, sum of cardinalities). A list column counts
    its valid positions; ``multi_hot`` and ``one_hot`` cap each count at 1."""

    def __init__(self, schema: Schema, output_mode: str = "multi_hot"):
        super().__init__(schema=schema.categorical)
        if output_mode not in ("one_hot", "multi_hot", "count"):
            raise ValueError(f"Unknown output_mode {output_mode!r}")
        self.output_mode = output_mode
        self.cardinalities = {c.name: c.cardinality for c in self.schema}

    def _encode(self, col: ColumnSchema, v) -> torch.Tensor:
        card = self.cardinalities[col.name]
        binary = self.output_mode != "count"
        if isinstance(v, SequenceFeature):
            return _encode(v.values, v.mask.to(torch.float32), card, binary)
        ids = v.reshape(v.shape[0], -1)
        return _encode(ids, torch.ones(ids.shape, device=ids.device), card, binary)

    def forward(self, inputs: TensorDict, **kwargs) -> torch.Tensor:
        encoded = [self._encode(col, inputs[col.name]) for col in self.schema
                   if col.name in inputs]
        if not encoded:
            raise ValueError("CategoryEncoding found none of its columns in inputs")
        return torch.cat(encoded, dim=-1)


def _hash_combine(h: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``h ^ (v + 0x9E3779B9 + (h << 6) + (h >> 2))`` in uint32."""
    return h ^ ((v + 0x9E3779B9 + ((h << 6) & _MASK32) + (h >> 2)) & _MASK32)


def _cross_ids(values: Sequence[torch.Tensor], num_bins: int) -> torch.Tensor:
    """The bucket ids of the cross of ``values`` (one tensor a column, all
    of one shape): the columns hashed in order from the cross seed, in
    uint32, mod ``num_bins``; int64."""
    h = None
    for v in values:
        v = v.to(torch.int64) & _MASK32
        h = _hash_combine(torch.full_like(v, _CROSS_SEED) if h is None else h, v)
    return h % num_bins


class HashedCross(Block):
    """The hashed cross of the schema's categorical columns into
    ``num_bins`` buckets: int bucket ids (B,), or their one-hot. List
    columns cross position by position (a scalar broadcasts along the
    sequence) into a SequenceFeature whose mask is the inputs' AND; masked
    positions take bucket 0."""

    def __init__(self, schema: Schema, num_bins: int = 1000, output_mode: str = "int",
                 output_name: Optional[str] = None):
        super().__init__(schema=schema.categorical)
        self.num_bins = int(num_bins)
        self.output_mode = output_mode
        self.output_name = output_name or ("cross_" + "_".join(self.schema.column_names))

    def buckets(self, inputs: TensorDict):
        """(bucket ids (B,) or (B, L) int64, the mask or None)."""
        vals, mask, seq_len = [], None, None
        for col in self.schema:
            v = inputs[col.name]
            if isinstance(v, SequenceFeature):
                if seq_len is not None and v.values.shape[1] != seq_len:
                    raise ValueError("HashedCross list features must share one sequence length")
                seq_len = v.values.shape[1]
                mask = v.mask if mask is None else (mask & v.mask)
                v = v.values
            vals.append(v)
        if seq_len is not None:
            vals = [v[:, None].expand(v.shape[0], seq_len) if v.ndim == 1 else v for v in vals]
        bucket = _cross_ids(vals, self.num_bins)
        if mask is not None:
            bucket = torch.where(mask, bucket, 0)
        return bucket, (None if seq_len is None else
                        mask if mask is not None else torch.ones(bucket.shape, dtype=torch.bool,
                                                                 device=bucket.device))

    def forward(self, inputs: TensorDict, **kwargs):
        bucket, mask = self.buckets(inputs)
        out = (F.one_hot(bucket, self.num_bins).to(torch.float32)
               if self.output_mode == "one_hot" else bucket.to(torch.int32))
        return out if mask is None else SequenceFeature(out, mask)


class HashedCrossAll(Block):
    """Every cross of ``min_level`` to ``max_level`` of the schema's
    categorical columns (but ``ignore_combinations``), in
    ``itertools.combinations`` order: their one-hots concatenated, or their
    bucket ids stacked on the last axis. The columns are scalar: a cross of
    list columns is a :class:`HashedCross` of its own (the JAX package's
    concatenation of such crosses fails)."""

    def __init__(self, schema: Schema, num_bins: int = 1000, max_level: int = 2,
                 min_level: int = 2, output_mode: str = "one_hot",
                 ignore_combinations: Sequence[Sequence[str]] = ()):
        super().__init__(schema=schema.categorical)
        cols = self.schema.column_names
        ignore = {tuple(sorted(c)) for c in ignore_combinations}
        crosses = [HashedCross(schema.select_by_name(list(combo)), num_bins, output_mode)
                   for level in range(min_level, max_level + 1)
                   for combo in itertools.combinations(cols, level)
                   if tuple(sorted(combo)) not in ignore]
        self.crosses = nn.ModuleList(crosses)
        self.num_bins = int(num_bins)
        self.output_mode = output_mode
        self.list_columns = {c.name for x in crosses for c in x.schema if c.is_list}
        # for buckets(): each level's crosses (their positions) and columns
        self.levels = sorted({len(c.schema) for c in crosses})
        for level in self.levels:
            which = [i for i, c in enumerate(crosses) if len(c.schema) == level]
            self.register_buffer(f"which_{level}", torch.tensor(which), persistent=False)
            self.register_buffer(f"columns_{level}", torch.tensor(
                [[cols.index(n) for n in crosses[i].schema.column_names] for i in which]
            ).reshape(len(which), level), persistent=False)

    def buckets(self, inputs: TensorDict) -> torch.Tensor:
        """Every cross's bucket ids over scalar columns, (B, crosses) int64:
        the crosses of each level hashed together, one column of their
        (B, crosses) ids at a time, so that the work is a few tensor ops a
        level, not a few a cross."""
        if self.list_columns:
            raise ValueError(f"HashedCrossAll crosses scalar columns only, not the list "
                             f"columns {sorted(self.list_columns)} (HashedCross crosses them)")
        names = self.schema.column_names
        values = torch.stack([inputs[n].reshape(-1) for n in names], 1)
        out = torch.empty(values.shape[0], len(self.crosses), dtype=torch.int64,
                          device=values.device)
        for level in self.levels:
            cols = getattr(self, f"columns_{level}")  # (crosses, level)
            out[:, getattr(self, f"which_{level}")] = _cross_ids(
                [values[:, cols[:, k]] for k in range(level)], self.num_bins)
        return out

    def forward(self, inputs: TensorDict, **kwargs):
        ids = self.buckets(inputs)
        if self.output_mode == "one_hot":
            return F.one_hot(ids, self.num_bins).to(torch.float32).flatten(1)
        return ids.to(torch.int32)


class BroadcastToSequence(Block):
    """Context features (B,) or (B, D) as (B, L, D) SequenceFeatures, L and
    the mask taken from a sequence feature of ``sequence_schema``."""

    def __init__(self, context_schema: Schema, sequence_schema: Schema):
        super().__init__(schema=context_schema + sequence_schema)
        self.context_names = set(context_schema.column_names)
        self.sequence_names = set(sequence_schema.column_names)

    def forward(self, inputs: TensorDict, **kwargs):
        mask = next((inputs[n].mask for n in sorted(self.sequence_names)
                     if isinstance(inputs.get(n), SequenceFeature)), None)
        if mask is None:
            raise ValueError("BroadcastToSequence found no SequenceFeature to take length from")
        L = mask.shape[1]
        out = dict(inputs)
        for n in self.context_names:
            v = out.get(n)
            if v is None or isinstance(v, SequenceFeature):
                continue
            if v.ndim == 1:
                v = v[:, None]
            out[n] = SequenceFeature(v[:, None, :].expand(v.shape[0], L, v.shape[-1]), mask)
        return out


class ExpandDims(Block):
    """``unsqueeze(axis)`` of a tensor or of a dict's tensors (a
    SequenceFeature passes)."""

    def __init__(self, axis: int = -1):
        super().__init__()
        self.axis = axis

    def forward(self, inputs, **kwargs):
        if isinstance(inputs, dict):
            return {k: v if isinstance(v, SequenceFeature) else v.unsqueeze(self.axis)
                    for k, v in inputs.items()}
        return inputs.unsqueeze(self.axis)
