"""Feature-interaction blocks (``models_tpu/blocks/interaction.py``): the
pairwise dot products of the DLRM, the factorisation machine's terms and
the xDeepFM outer product, over a stacked (B, F, D) feature tensor.

The JAX package takes the dot interaction's upper triangle with a 0/1
selection product at ``HIGHEST`` precision, a TPU workaround for XLA's
gather gradient. The port takes the gram as one batched product (cuBLAS,
TF32 off) and indexes the flattened gram with the triangle's flat indices,
computed once with numpy: the selection is exact, and its gradient writes
each selected entry once.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..blocks.mlp import LazyMixin, _capturing
from ..core.aggregation import StackFeatures
from ..core.block import Block
from ..inputs.embedding import Embeddings
from ..schema import Schema, infer_embedding_dim


def triangle_indices(f: int, self_interaction: bool = False) -> np.ndarray:
    """Flat indices ``i * f + j`` of the pairs i < j (i <= j with
    ``self_interaction``) of an (f, f) matrix, row by row."""
    iu = np.triu_indices(f, k=0 if self_interaction else 1)
    return (iu[0] * f + iu[1]).astype(np.int64)


class DotProductInteraction(Block):
    """(B, F, D) -> (B, F (F - 1) / 2): the dot products of every pair of
    features, the upper triangle of the gram row by row
    (``self_interaction=True`` keeps the diagonal: F (F + 1) / 2)."""

    def __init__(self, self_interaction: bool = False):
        super().__init__()
        self.self_interaction = self_interaction
        # the triangle's flat indices by (F, device), uploaded at a first,
        # eager call (never inside a captured graph)
        self._index: Dict[Tuple[int, torch.device], torch.Tensor] = {}

    def forward(self, inputs: torch.Tensor, **kwargs):
        if inputs.ndim != 3:
            raise ValueError(
                f"DotProductInteraction expects stacked (B, F, D) input, got {tuple(inputs.shape)}")
        b, f, _ = inputs.shape
        key = (f, inputs.device)
        if key not in self._index:
            self._index[key] = torch.from_numpy(
                triangle_indices(f, self.self_interaction)).to(inputs.device)
        gram = torch.bmm(inputs, inputs.transpose(1, 2))  # (B, F, F)
        return gram.reshape(b, f * f).index_select(1, self._index[key])


class FMPairwiseInteraction(Block):
    """The factorisation machine's second-order term, ``0.5 ((sum_f v)^2 -
    sum_f v^2)``: (B, F, D) -> (B, D)."""

    def forward(self, inputs: torch.Tensor, **kwargs):
        if inputs.ndim != 3:
            raise ValueError(f"FMPairwiseInteraction expects (B, F, D), got {tuple(inputs.shape)}")
        return 0.5 * (inputs.sum(dim=1).square() - inputs.square().sum(dim=1))


class XDeepFmOuterProduct(LazyMixin, Block):
    """One CIN layer of xDeepFM: ``x_k[h] = sum_{i, j} W[h, i, j] (x_prev[i] *
    x0[j])``. JAX's ``kernel`` is (dim, H, F), glorot-uniform as flax draws
    it (fans over the last two axes times the first); the port's ``weight``
    is its transpose (F, H, dim), as for a Dense kernel. Without
    ``num_prev`` and ``num_fields`` it builds at its first call (the model's
    build pass) from the inputs' H and F, as the JAX package's does."""

    def __init__(self, dim: int, seed: int = 0, num_prev: Optional[int] = None,
                 num_fields: Optional[int] = None, device=None):
        super().__init__()
        self.dim = dim
        self.seed = seed
        self.register_parameter("weight", None)
        if num_prev is not None and num_fields is not None:
            self._build_shape(int(num_prev), int(num_fields), device)

    def _build_shape(self, num_prev: int, num_fields: int, device) -> None:
        bound = math.sqrt(6.0 / (self.dim * (num_prev + num_fields)))
        weight = torch.empty(num_fields, num_prev, self.dim, device=device)
        weight.uniform_(-bound, bound,
                        generator=torch.Generator(weight.device).manual_seed(self.seed))
        self.weight = nn.Parameter(weight)
        self.built = True

    @staticmethod
    def _split(inputs):
        return inputs if isinstance(inputs, (list, tuple)) else (inputs, inputs)

    def build(self, x, device=None) -> None:
        """Build on a sample ``(x_prev (B, H, D), x0 (B, F, D))`` (or one
        tensor for both), on its device."""
        x_prev, x0 = self._split(x)
        self._build_shape(int(x_prev.shape[1]), int(x0.shape[1]),
                          x_prev.device if device is None else device)

    def forward(self, inputs, **kwargs):
        """``(x_prev (B, H, D), x0 (B, F, D))``, or one tensor for both."""
        x_prev, x0 = self._split(inputs)
        if not self.built:
            if _capturing():
                raise RuntimeError("XDeepFmOuterProduct is not built. Run model.build(data) "
                                   "before capturing a graph.")
            self.build((x_prev, x0))
        outer = torch.einsum("bhd,bfd->bhfd", x_prev, x0)
        return torch.einsum("bhfd,fhk->bkd", outer, self.weight)


class FMBlock(Block):
    """A factorisation machine over the schema's categorical columns: a
    global bias, the first-order weights (1-wide embeddings, list columns
    summed) and the pairwise term of the ``latent_dim``-wide embeddings
    (list columns mean-pooled): (B, 1)."""

    def __init__(self, schema: Schema, latent_dim: Optional[int] = None, seed: int = 0,
                 device=None):
        super().__init__(schema=schema.categorical)
        cat = schema.categorical
        dim = latent_dim or max(infer_embedding_dim(c) for c in cat)
        self.out_features = 1
        self.latent = Embeddings(cat, dim=dim, sequence_combiner="mean", seed=seed, device=device)
        self.wide = Embeddings(cat, dim=1, sequence_combiner="sum", seed=seed + 7, device=device)
        self.bias = nn.Parameter(torch.zeros(1, device=device))
        self.stack = StackFeatures(axis=1)
        self.pairwise = FMPairwiseInteraction()

    def forward(self, inputs, **kwargs):
        latent = self.stack(self.latent(inputs, **kwargs))  # (B, F, D)
        second = self.pairwise(latent).sum(dim=-1, keepdim=True)  # (B, 1)
        first = sum(v.reshape(v.shape[0], -1).sum(dim=-1, keepdim=True)
                    for v in self.wide(inputs, **kwargs).values())
        return self.bias[None, :] + first + second
