"""Embedding tables and the schema-driven ``Embeddings()`` factory
(``models_tpu/inputs/embedding.py``, the plain single-device lookup).

Columns sharing an int-domain name share one table. A list column not tagged
``SEQUENCE`` is mean-pooled over its mask (multi-hot).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
from torch import nn

from ..core.aggregation import SEQUENCE_COMBINERS
from ..core.combinators import ParallelBlock
from ..core.block import Block
from ..core.types import SequenceFeature
from ..schema import ColumnSchema, Schema, Tags, infer_embedding_dim


class EmbeddingTable(Block):
    """One table, serving one or more columns of its domain.

    Rows are padded to a multiple of 8, as in the JAX package, so that its
    tables load whole; ids must stay below ``input_dim`` (a CUDA gather out
    of range is a device-side assert, where ``jnp.take`` would not fault).
    """

    def __init__(
        self,
        dim: int,
        col_schema: Union[ColumnSchema, Sequence[ColumnSchema]],
        sequence_combiner: Optional[str] = None,
        seed: int = 0,
        device=None,
    ):
        cols = [col_schema] if isinstance(col_schema, ColumnSchema) else list(col_schema)
        super().__init__(schema=Schema(cols), block_name=cols[0].domain_name)
        self.dim = int(dim)
        self.features = [c.name for c in cols]
        self.sequence_combiner = sequence_combiner
        card = cols[0].cardinality
        if card is None:
            raise ValueError(f"Column {cols[0].name} has no cardinality; cannot embed")
        if any(c.cardinality != card for c in cols[1:]):
            raise ValueError("Features sharing an embedding table must share its domain")
        self.input_dim = int(card)
        self.padded_rows = -(-self.input_dim // 8) * 8
        table = torch.empty(self.padded_rows, self.dim, device=device)
        gen = torch.Generator(table.device).manual_seed(seed)
        # truncated normal at 2 sigma, sigma 0.05 (the JAX initializer)
        nn.init.trunc_normal_(table, std=0.05, a=-0.1, b=0.1, generator=gen)
        self.table = nn.Parameter(table, requires_grad=False)

    @property
    def embeddings(self) -> torch.Tensor:
        return self.table[: self.input_dim]

    def _call_single(self, value):
        if isinstance(value, SequenceFeature):
            emb = self.table[value.values.long()]  # (B, L, D)
            seq = SequenceFeature(emb, value.mask)
            if self.sequence_combiner is None:
                return seq
            return SEQUENCE_COMBINERS[self.sequence_combiner](seq)
        return self.table[value.long()]

    def forward(self, inputs, **kwargs):
        if isinstance(inputs, dict):
            return {n: self._call_single(inputs[n]) for n in self.features if n in inputs}
        return self._call_single(inputs)

    def extra_repr(self) -> str:
        return f"{self.input_dim}x{self.dim}, features={self.features}"


def Embeddings(
    schema: Schema, dim: Optional[int] = None, seed: int = 0, device=None
) -> ParallelBlock:
    """One :class:`EmbeddingTable` per categorical domain, ``dim`` wide (or
    inferred from each domain's cardinality). ``SEQUENCE`` list columns stay
    3-D; other list columns are mean-pooled over their mask."""
    cat = schema.categorical
    if not len(cat):
        raise ValueError("Schema has no categorical columns")
    by_domain: Dict[str, list] = {}
    for col in cat:
        by_domain.setdefault(col.domain_name, []).append(col)

    def combiner_for(col: ColumnSchema) -> Optional[str]:
        if not col.is_list or col.has_tag(Tags.SEQUENCE):
            return None
        return "mean"

    tables = {}
    for i, (domain, cols) in enumerate(by_domain.items()):
        combiners = {combiner_for(c) for c in cols}
        tables[domain] = EmbeddingTable(
            dim if dim is not None else infer_embedding_dim(cols[0]), cols,
            sequence_combiner=next(iter(combiners)) if len(combiners) == 1 else None,
            seed=seed + i, device=device,
        )
    return ParallelBlock(tables, block_name="embeddings", schema=cat)
