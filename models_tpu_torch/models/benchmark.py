"""The benchmark models (``models_tpu/models/benchmark.py``): NCF."""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from ..blocks.mlp import MLPBlock
from ..core.block import Block
from ..core.device import resolve_device
from ..inputs.embedding import EmbeddingTable
from ..schema import Schema, Tags, infer_embedding_dim
from .ranking import _model


class _NCFBody(Block):
    """Neural collaborative filtering: the GMF branch (user ⊙ item) ‖ the
    MLP branch (user, item concatenated -> MLP), each with its own user and
    item tables."""

    def __init__(self, schema: Schema, embedding_dim: int, mlp_block, seed: int, device):
        super().__init__(schema=schema.excluding_by_tag(Tags.TARGET))
        user_col, item_col = schema.user_id_column, schema.item_id_column
        self.user_name, self.item_name = user_col.name, item_col.name
        self.gmf_user = EmbeddingTable(embedding_dim, user_col, seed=seed, device=device)
        self.gmf_item = EmbeddingTable(embedding_dim, item_col, seed=seed + 1, device=device)
        self.mlp_user = EmbeddingTable(embedding_dim, user_col, seed=seed + 2, device=device)
        self.mlp_item = EmbeddingTable(embedding_dim, item_col, seed=seed + 3, device=device)
        if not isinstance(mlp_block, Block):
            mlp_block = MLPBlock(mlp_block, seed=seed, in_features=2 * embedding_dim, device=device)
        self.mlp = mlp_block
        self.out_features = embedding_dim + mlp_block.out_features

    def forward(self, inputs, **kwargs):
        u, i = inputs[self.user_name], inputs[self.item_name]
        gmf = self.gmf_user(u, **kwargs) * self.gmf_item(i, **kwargs)
        mlp_in = torch.cat([self.mlp_user(u, **kwargs), self.mlp_item(i, **kwargs)], dim=-1)
        return torch.cat([gmf, self.mlp(mlp_in, **kwargs)], dim=-1)


def NCFModel(
    schema: Schema,
    embedding_dim: Optional[int] = None,
    mlp_block: Union[Block, Sequence[int]] = (64, 32),
    prediction_tasks: Optional[Block] = None,
    seed: int = 0,
    device=None,
):
    dev = resolve_device(device)
    if embedding_dim is None:
        embedding_dim = infer_embedding_dim(schema.item_id_column)
    body = _NCFBody(schema, embedding_dim, mlp_block, seed, dev)
    return _model(body, schema, "ncf", prediction_tasks, dev)
