"""Embedding tables and the schema-driven ``Embeddings()`` factory
(``models_tpu/inputs/embedding.py``, the plain single-device lookup).

Columns sharing an int-domain name share one table. A list column not tagged
``SEQUENCE`` is mean-pooled over its mask (multi-hot). Tables are float32 or,
at rest, bfloat16; lookups of a bf16 table are cast to the policy's compute
dtype (float32, or bf16 under ``mixed_bfloat16``: ``_cast_up``).

A table routed to the row-sparse optimizer (``sparse_routed``, set by
``Model.fit``) looks up from the detached table, in training, into float32
rows that are a leaf of the autograd graph: after the backward their
``.grad`` is the gradient of the gathered rows, whatever the table's dtype.
Each such lookup is recorded as ``(table, ids, rows)`` in the context's
``sparse_lookups``; a sequence column is recorded before its combiner, with
the padded (B, L) ids, as the JAX package taps it.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.aggregation import SEQUENCE_COMBINERS
from ..core.combinators import ParallelBlock
from ..core.policy import compute_dtype
from ..core.block import Block
from ..core.types import SequenceFeature
from ..schema import ColumnSchema, Schema, Tags, infer_embedding_dim


class SparseSlots(nn.Module):
    """The row-sparse optimizer's per-row state of one table (``acc``, or
    ``m`` and ``v``; none for sgd), float32 buffers of the table's shape.
    They move and copy with the model and outlive ``fit`` and ``compile``."""

    def __init__(self, slots: Dict[str, torch.Tensor]):
        super().__init__()
        for name, value in slots.items():
            self.register_buffer(name, value)

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._buffers[name]

    def keys(self):
        return list(self._buffers)


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
        dtype: torch.dtype = torch.float32,
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
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"embedding tables are float32 or bfloat16, not {dtype}")
        table = torch.empty(self.padded_rows, self.dim, device=device)
        gen = torch.Generator(table.device).manual_seed(seed)
        # truncated normal at 2 sigma, sigma 0.05 (the JAX initializer)
        nn.init.trunc_normal_(table, std=0.05, a=-0.1, b=0.1, generator=gen)
        # trained densely, the lookup's backward gives a (rows, D) gradient,
        # as the JAX package's dense optimizer sees it
        self.table = nn.Parameter(table.to(dtype))
        self.sparse_routed = False
        # the row-sparse optimizer's per-row state, created by its init_slots
        self.sparse_slots: Optional[SparseSlots] = None

    @property
    def embeddings(self) -> torch.Tensor:
        return self.table[: self.input_dim]

    def _lookup(self, ids, context):
        lookups = context.get("sparse_lookups") if context is not None else None
        if lookups is not None and self.sparse_routed:
            rows = F.embedding(ids.long(), self.table.detach()).float().requires_grad_()
            lookups.append((self, ids, rows))
            return rows
        # F.embedding, not table[ids]: its backward sums repeated ids by
        # sorting them, where the indexing backward serialises each repeated
        # row (genres: 21 rows take every list entry of a batch)
        return self._cast_up(F.embedding(ids.long(), self.table))

    @staticmethod
    def _cast_up(emb: torch.Tensor) -> torch.Tensor:
        """Rows of a bf16 table in the policy's compute dtype; float32 rows
        as they are. (The row-sparse lookup's rows are float32 leaves: the
        JAX package's float32 tap, added to them, makes them float32 too.)"""
        return emb if emb.dtype == torch.float32 else emb.to(compute_dtype())

    def _call_single(self, value, context):
        if isinstance(value, SequenceFeature):
            emb = self._lookup(value.values, context)  # (B, L, D)
            seq = SequenceFeature(emb, value.mask)
            if self.sequence_combiner is None:
                return seq
            return SEQUENCE_COMBINERS[self.sequence_combiner](seq)
        return self._lookup(value, context)

    def forward(self, inputs, context=None, **kwargs):
        if isinstance(inputs, dict):
            return {n: self._call_single(inputs[n], context) for n in self.features if n in inputs}
        return self._call_single(inputs, context)

    def extra_repr(self) -> str:
        return f"{self.input_dim}x{self.dim}, features={self.features}"


def Embeddings(
    schema: Schema, dim: Optional[int] = None, param_dtype: Optional[torch.dtype] = None,
    seed: int = 0, device=None
) -> ParallelBlock:
    """One :class:`EmbeddingTable` per categorical domain, ``dim`` wide (or
    inferred from each domain's cardinality). ``SEQUENCE`` list columns stay
    3-D; other list columns are mean-pooled over their mask.
    ``param_dtype=torch.bfloat16`` stores the tables bf16 at rest; they then
    train only through a row-sparse ``embedding_optimizer`` (stochastic-
    rounding writes)."""
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
            dtype=param_dtype or torch.float32, seed=seed + i, device=device,
        )
    return ParallelBlock(tables, block_name="embeddings", schema=cat)
