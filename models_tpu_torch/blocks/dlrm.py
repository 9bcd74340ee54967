"""The DLRM block (``models_tpu/blocks/dlrm.py``).

continuous columns (concatenated in sorted name order) -> bottom MLP, to the
embedding width ‖ categorical columns -> equal-width embeddings (fused
tables, ``Embeddings(fused=True)``) -> stacked in sorted key order with the
bottom output as ``__bottom__`` (B, F + 1, D) -> pairwise dot products ->
the bottom output concatenated in front -> top MLP. The widths follow from
the schema: the top MLP takes ``D + (F + 1) F / 2`` (415 on Criteo at D =
64).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.aggregation import StackFeatures
from ..core.block import Block
from ..inputs.continuous import Continuous
from ..inputs.embedding import Embeddings
from ..schema import Schema, Tags
from .interaction import DotProductInteraction
from .mlp import MLPBlock


class DLRMBlock(Block):
    """``bottom_block`` and ``top_block`` are blocks with ``out_features``
    (the bottom one's must be ``embedding_dim``) or None: without a bottom
    block a schema with continuous columns takes ``MLPBlock((2 D, D))``;
    without a top block the block returns the interactions."""

    def __init__(self, schema: Schema, embedding_dim: int, bottom_block: Optional[Block] = None,
                 top_block: Optional[Block] = None, self_interaction: bool = False,
                 seed: int = 0, device=None):
        super().__init__(schema=schema.excluding_by_tag(Tags.TARGET))
        cat = self.schema.categorical
        cont = self.schema.continuous
        if not len(cat):
            raise ValueError("DLRM needs categorical features")
        self.embedding_dim = embedding_dim
        self.embeddings = Embeddings(cat, dim=embedding_dim, sequence_combiner="mean",
                                     seed=seed, fused=True, device=device)
        self.continuous = Continuous(cont) if len(cont) else None
        if self.continuous is not None and bottom_block is None:
            bottom_block = MLPBlock([embedding_dim * 2, embedding_dim], seed=seed,
                                    in_features=len(cont), device=device)
        if bottom_block is not None and bottom_block.out_features != embedding_dim:
            raise ValueError(f"bottom block output dim {bottom_block.out_features} != "
                             f"embedding_dim {embedding_dim}")
        # without continuous columns the bottom block never runs: the JAX
        # package's never builds, and holds no parameter
        self.bottom = bottom_block if self.continuous is not None else None
        self.interaction = DotProductInteraction(self_interaction=self_interaction)
        self.top = top_block
        self.stack = StackFeatures(axis=1)
        self.out_features = top_block.out_features if top_block is not None else (
            self.interaction_width(schema, embedding_dim, self_interaction))

    @staticmethod
    def interaction_width(schema: Schema, embedding_dim: int,
                          self_interaction: bool = False) -> int:
        """The width of what the top block takes: the bottom output (where
        the schema has continuous columns) and the pairwise products of the
        stacked features."""
        schema = schema.excluding_by_tag(Tags.TARGET)
        has_cont = len(schema.continuous) > 0
        f = len(schema.categorical) + has_cont
        pairs = f * (f + 1) // 2 if self_interaction else f * (f - 1) // 2
        return pairs + (embedding_dim if has_cont else 0)

    def forward(self, inputs, *, training=False, context=None, **kwargs):
        parts = dict(self.embeddings(inputs, training=training, context=context))
        bottom_out = None
        if self.continuous is not None:
            cont = self.continuous(inputs)
            x = torch.cat([v for _, v in sorted(cont.items())], dim=-1)
            bottom_out = self.bottom(x, training=training, context=context)
            parts["__bottom__"] = bottom_out
        interactions = self.interaction(self.stack(parts))
        if bottom_out is not None:
            interactions = torch.cat([bottom_out, interactions], dim=-1)
        if self.top is not None:
            return self.top(interactions, training=training, context=context)
        return interactions
