"""The two-tower retrieval model (``models_tpu/models/retrieval.py``):
serving, and training through its contrastive head."""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from ..blocks.mlp import MLPBlock
from ..core.block import Block
from ..core.combinators import ParallelBlock, SequentialBlock
from ..core.device import resolve_device
from ..core.encoder import Encoder, TopKEncoder
from ..data.dataset import Dataset
from ..inputs.base import InputBlockV2
from ..outputs.contrastive import ContrastiveOutput
from ..schema import Schema, Tags
from .base import Model


class RetrievalModelV2(Model):
    """A query tower and a candidate tower, run side by side into a
    :class:`ContrastiveOutput`. ``item_id_name`` names the column whose values
    become the index's ids."""

    def __init__(self, query: Block, candidate: Block, output: ContrastiveOutput,
                 schema: Optional[Schema] = None):
        # Model.__init__ would register ``blocks`` first; the towers come
        # first, so that ``named_parameters()`` (which names a shared module
        # by its first registration) gives the JAX package's paths
        Block.__init__(self, schema=schema, block_name="two_tower")
        self._query = query
        self._candidate = candidate
        self.blocks = nn.ModuleList(
            [ParallelBlock({"query": query, "candidate": candidate}), output])
        self._compiled = False

    @property
    def item_id_name(self) -> Optional[str]:
        return self.contrastive_output.item_id_name

    @property
    def contrastive_output(self) -> ContrastiveOutput:
        return self.blocks[-1]

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
    negative_samplers: Union[str, Sequence] = "in-batch",
    logits_temperature: float = 1.0,
    seed: int = 0,
    device=None,
) -> RetrievalModelV2:
    """USER columns feed the query tower, ITEM columns the candidate tower;
    each is an input block and an MLP of ``query_tower`` widths whose last
    layer is linear. The head trains on in-batch negatives. Weights are drawn
    from ``seed`` on ``device`` (default the card)."""
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
    output = ContrastiveOutput(schema.item_id_column, negative_samplers=negative_samplers,
                               logits_temperature=logits_temperature)
    return RetrievalModelV2(query, candidate, output, schema=schema)
