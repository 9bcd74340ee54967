"""Continuous features (``models_tpu/inputs/continuous.py``): the selection,
the soft embedding and the projection."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.aggregation import ConcatFeatures
from ..core.block import Block
from ..core.combinators import SequentialBlock
from ..core.types import SequenceFeature, TensorDict
from ..schema import Schema


class Continuous(Block):
    """Select the continuous columns and turn each (B,) column into (B, 1)
    float32, and each (B, L) list column into a :class:`SequenceFeature` of
    (B, L, 1) float32 values."""

    def __init__(self, schema: Optional[Schema] = None):
        if schema is not None and len(schema.continuous):
            schema = schema.continuous
        super().__init__(schema=schema, block_name="continuous")

    def forward(self, inputs: TensorDict, **kwargs):
        names = self.schema.column_names if self.schema is not None else list(inputs)
        out = {}
        for name in names:
            if name not in inputs:
                continue
            v = inputs[name]
            if isinstance(v, SequenceFeature):
                vals = v.values[..., None] if v.values.ndim == 2 else v.values
                out[name] = SequenceFeature(vals.to(torch.float32), v.mask)
            else:
                out[name] = (v[:, None] if v.ndim == 1 else v).to(torch.float32)
        return out


class ContinuousEmbedding(Block):
    """Soft embedding of continuous features: each scalar attends over a
    small learned table, ``softmax(x @ proj) @ table`` with ``proj`` (1, n)
    and ``table`` (n, dim), both drawn N(0, 0.05**2) from ``seed``."""

    def __init__(self, num_embeddings: int = 10, dim: int = 8, seed: int = 0, device=None):
        super().__init__(block_name="continuous_embedding")
        self.out_features = dim
        gen = torch.Generator(torch.device(device or "cpu")).manual_seed(seed)
        self.proj = nn.Parameter(
            torch.randn(1, num_embeddings, generator=gen, device=device) * 0.05)
        self.table = nn.Parameter(
            torch.randn(num_embeddings, dim, generator=gen, device=device) * 0.05)

    def _embed(self, x: torch.Tensor) -> torch.Tensor:
        x = x[:, None] if x.ndim == 1 else x
        return torch.softmax(x.float() @ self.proj, dim=-1) @ self.table

    def forward(self, inputs, **kwargs):
        if isinstance(inputs, dict):
            return {k: self._embed(v) for k, v in inputs.items()
                    if not isinstance(v, SequenceFeature)}
        return self._embed(inputs)


class ConcatDict(Block):
    """Concatenate a feature dict along the last axis, in sorted key order."""

    def forward(self, inputs, **kwargs):
        return ConcatFeatures()(inputs)


def ContinuousProjection(schema: Schema, projection: Block) -> SequentialBlock:
    """The continuous columns, concatenated, through ``projection`` (whose
    ``out_features`` the block takes)."""
    block = SequentialBlock([Continuous(schema), ConcatDict(), projection],
                            block_name="continuous_projection")
    block.out_features = projection.out_features
    return block
