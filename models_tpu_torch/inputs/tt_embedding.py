"""Tensor-train embedding tables (``models_tpu/inputs/tt_embedding.py``,
TT-Rec): an (N, D) table as three cores, with N <= n1 n2 n3 and D = d1 d2 d3,

    emb[i] = G1[i1] . G2[i2] . G3[i3]

(i1, i2, i3) the mixed-radix digits of the row id, G1 (n1, 1, d1, r1), G2
(n2, r1, d2, r2), G3 (n3, r2, d3, 1). A lookup is three gathers and two
contractions, plain torch as the JAX package's are plain ``jnp``; the
cores train densely. The factorisations are the JAX package's, so that its
cores load one to one (``load_jax_params``); the initial draws differ.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..core.aggregation import SEQUENCE_COMBINERS
from ..core.block import Block
from ..core.device import resolve_device
from ..core.types import SequenceFeature
from ..schema import ColumnSchema, Schema


def _factorize3(n: int) -> Tuple[int, int, int]:
    """Three near-equal factors with product >= n (row ids padded up)."""
    c = int(math.ceil(n ** (1.0 / 3.0)))
    best = (c, c, c)
    best_cover = c * c * c
    for a in range(max(1, c - 2), c + 3):
        b = int(math.ceil(math.sqrt(n / a)))
        for bb in (max(1, b - 1), b, b + 1):
            cc = int(math.ceil(n / (a * bb)))
            cover = a * bb * cc
            if cover >= n and cover < best_cover:
                best, best_cover = (a, bb, cc), cover
    return best


def _factorize_dim(d: int) -> Tuple[int, int, int]:
    """Three factors with exact product d (any remainder in the last)."""
    a = 1
    for cand in range(int(math.isqrt(d)), 0, -1):
        if d % cand == 0:
            a = cand
            break
    rest = d // a
    b = 1
    for cand in range(int(math.isqrt(rest)), 0, -1):
        if rest % cand == 0:
            b = cand
            break
    return a, b, rest // b


class TTEmbeddingTable(Block):
    """A tensor-train table of ``ranks`` (r1, r2), a drop-in for an
    :class:`~models_tpu_torch.inputs.embedding.EmbeddingTable` on the input
    side (scalar ids, or list columns with a combiner), made on ``device``
    (default the card)."""

    def __init__(self, dim: int, col_schema: Union[ColumnSchema, Sequence[ColumnSchema]],
                 ranks: Union[int, Tuple[int, int]] = 16, sequence_combiner: Optional[str] = None,
                 l2_reg: float = 0.0, seed: int = 0, device=None):
        cols = [col_schema] if isinstance(col_schema, ColumnSchema) else list(col_schema)
        super().__init__(schema=Schema(cols), block_name=cols[0].domain_name)
        device = resolve_device(device)
        card = cols[0].cardinality
        if card is None:
            raise ValueError(f"Column {cols[0].name} has no cardinality; cannot embed")
        self.dim = int(dim)
        self.input_dim = int(card)
        self.features = [c.name for c in cols]
        self.sequence_combiner = sequence_combiner
        self.l2_reg = float(l2_reg)
        if isinstance(ranks, int):
            ranks = (ranks, ranks)
        r1, r2 = int(ranks[0]), int(ranks[1])
        n1, n2, n3 = _factorize3(self.input_dim)
        d1, d2, d3 = _factorize_dim(self.dim)
        self.shape_n, self.shape_d, self.ranks = (n1, n2, n3), (d1, d2, d3), (r1, r2)
        # the product of the cores near N(0, 0.05), as a plain table: the
        # scale spread over the three
        scale = 0.05 ** (1.0 / 3.0)
        gen = torch.Generator(device).manual_seed(seed + 77)

        def normal(shape, std):
            return nn.Parameter(torch.randn(shape, generator=gen, device=device) * std)

        self.core1 = normal((n1, 1, d1, r1), scale)
        self.core2 = normal((n2, r1, d2, r2), scale / math.sqrt(r1))
        self.core3 = normal((n3, r2, d3, 1), scale / math.sqrt(r2))

    @property
    def compression_ratio(self) -> float:
        return self.input_dim * self.dim / sum(c.numel() for c in (self.core1, self.core2,
                                                                    self.core3))

    def _digits(self, ids: torch.Tensor):
        n1, n2, n3 = self.shape_n
        ids = ids.to(torch.int64)
        i3 = ids % n3
        rest = ids // n3
        return (rest // n2).clamp(0, n1 - 1), rest % n2, i3

    def _lookup(self, ids: torch.Tensor) -> torch.Tensor:
        """(...,) ids -> (..., dim): three gathers, two contractions."""
        i1, i2, i3 = self._digits(ids.reshape(-1))
        g1, g2, g3 = self.core1[i1], self.core2[i2], self.core3[i3]
        left = torch.einsum("bxar,brcs->bacs", g1, g2)  # (B, d1, d2, r2)
        emb = torch.einsum("bacs,bsdy->bacd", left, g3)  # (B, d1, d2, d3)
        return emb.reshape(tuple(ids.shape) + (self.dim,))

    @property
    def embeddings(self) -> torch.Tensor:
        """The whole (N, D) table, materialised."""
        return self._lookup(torch.arange(self.input_dim, device=self.core1.device))

    def to_array(self) -> np.ndarray:
        return self.embeddings.detach().cpu().numpy()

    def _call_single(self, value):
        if isinstance(value, SequenceFeature):
            seq = SequenceFeature(self._lookup(value.values), value.mask)
            if self.sequence_combiner is None:
                return seq
            return SEQUENCE_COMBINERS[self.sequence_combiner](seq)
        return self._lookup(value)

    def forward(self, inputs, **kwargs):
        if isinstance(inputs, dict):
            return {n: self._call_single(inputs[n]) for n in self.features if n in inputs}
        return self._call_single(inputs)

    def regularization_loss(self) -> Optional[torch.Tensor]:
        if not self.l2_reg:
            return None
        return self.l2_reg * sum(c.square().sum() for c in (self.core1, self.core2, self.core3))

    def extra_repr(self) -> str:
        return (f"{self.input_dim}x{self.dim}, n={self.shape_n}, d={self.shape_d}, "
                f"ranks={self.ranks}")
