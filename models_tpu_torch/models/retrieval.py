"""The two-tower retrieval model, serving subset
(``models_tpu/models/retrieval.py``)."""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from ..blocks.mlp import MLPBlock
from ..core.block import Block
from ..core.combinators import SequentialBlock
from ..core.device import resolve_device
from ..core.encoder import Encoder, TopKEncoder
from ..data.dataset import Dataset
from ..inputs.base import InputBlockV2
from ..schema import Schema, Tags


class RetrievalModelV2(Block):
    """A query tower and a candidate tower. ``item_id_name`` names the column
    whose values become the index's ids."""

    def __init__(self, query: Block, candidate: Block, item_id_name: Optional[str],
                 schema: Optional[Schema] = None):
        super().__init__(schema=schema, block_name="two_tower")
        # the attribute names give the JAX package's parameter paths
        self._query = query
        self._candidate = candidate
        self.item_id_name = item_id_name

    @property
    def query_encoder(self) -> Block:
        return self._query

    @property
    def candidate_encoder(self) -> Block:
        return self._candidate

    def candidate_embeddings(self, dataset: Dataset, batch_size: int = 1024,
                             index: Union[str, Tags, None] = Tags.ITEM_ID,
                             device=None) -> Dataset:
        """Encode the catalog: one row per distinct item id (its first row in
        ``dataset``), as ``id`` + ``embedding``."""
        if dataset is None:
            raise ValueError("Two-tower candidate_embeddings needs an item dataset")
        if isinstance(index, Tags):
            sel = dataset.schema.select_by_tag(index)
            item_id = sel.first.name if len(sel) else None
        else:
            item_id = index
        if item_id is not None and item_id in dataset.schema:
            dataset = dataset.unique_by(item_id)
        return Encoder(self._candidate).encode(
            dataset, index=index, batch_size=batch_size, device=device
        )

    def to_top_k_encoder(self, candidates: Dataset, k: int = 10, batch_size: int = 1024,
                         candidate_dtype: Optional[torch.dtype] = None, device=None):
        """A servable brute-force top-k model over the encoded ``candidates``;
        ``candidate_dtype=torch.bfloat16`` stores the index half-width."""
        cand_ds = self.candidate_embeddings(candidates, batch_size=batch_size, device=device)
        return TopKEncoder(self._query, candidates=cand_ds, k=k,
                           item_id_name=self.item_id_name,
                           candidate_dtype=candidate_dtype, device=device)


def TwoTowerModel(
    schema: Schema,
    query_tower: Sequence[int] = (128, 64),
    embedding_dim: Optional[int] = None,
    seed: int = 0,
    device=None,
) -> RetrievalModelV2:
    """USER columns feed the query tower, ITEM columns the candidate tower;
    each is an input block and an MLP of ``query_tower`` widths whose last
    layer is linear. Weights are drawn from ``seed`` on ``device`` (default
    the card)."""
    dev = resolve_device(device)
    user_schema = schema.select_by_tag(Tags.USER)
    item_schema = schema.select_by_tag(Tags.ITEM)
    if not len(user_schema) or not len(item_schema):
        raise ValueError("TwoTowerModel needs USER- and ITEM-tagged columns")

    def build_tower(dims, tower_schema, tower_seed):
        inputs = InputBlockV2(tower_schema, dim=embedding_dim, seed=tower_seed, device=dev)
        mlp = MLPBlock(inputs.out_features, tuple(dims), no_activation_last_layer=True,
                       seed=tower_seed, device=dev)
        block = SequentialBlock([inputs, mlp])
        block.schema = tower_schema.excluding_by_tag(Tags.TARGET)
        return block

    query = build_tower(query_tower, user_schema, seed)
    candidate = build_tower(query_tower, item_schema, seed + 100)
    return RetrievalModelV2(query, candidate, schema.item_id_column.name, schema=schema)
