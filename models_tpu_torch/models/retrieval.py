"""Retrieval models (``models_tpu/models/retrieval.py``): the two-tower
model, served and trained through its contrastive head, and the
query-only form that a tied head completes (the session model)."""

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
    :class:`ContrastiveOutput`; or, with ``candidate=None``, the query tower
    alone into a head whose candidates are its tied table's rows.
    ``item_id_name`` names the column whose values become the index's ids."""

    def __init__(self, query: Block, candidate: Optional[Block], output: ContrastiveOutput,
                 schema: Optional[Schema] = None):
        # Model.__init__ would register ``blocks`` first; the towers come
        # first, so that ``named_parameters()`` (which names a shared module
        # by its first registration) gives the JAX package's paths
        Block.__init__(self, schema=schema, block_name="two_tower")
        self._query = query
        self._candidate = candidate
        encoder = query if candidate is None else ParallelBlock(
            {"query": query, "candidate": candidate})
        self.blocks = nn.ModuleList([encoder, output])
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

    def query_embeddings(self, dataset: Dataset, batch_size: int = 1024,
                         index: Union[str, Tags, None] = Tags.USER_ID, device=None) -> Dataset:
        """Encode the queries with the query tower, as ``id`` + ``embedding``."""
        return Encoder(self._query).encode(dataset, index=index, batch_size=batch_size,
                                           device=device)

    def candidate_embeddings(self, dataset: Optional[Dataset] = None, batch_size: int = 1024,
                             index: Union[str, Tags, None] = Tags.ITEM_ID,
                             device=None) -> Dataset:
        """Encode the catalog: one row per distinct item id (its first row in
        ``dataset``), as ``id`` + ``embedding``; with a tied head and no
        candidate tower, the tied table's rows."""
        if self._candidate is None:
            return self.contrastive_output.to_dataset()
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
        """A servable and evaluable brute-force top-k model over the encoded
        ``candidates``; ``candidate_dtype=torch.bfloat16`` stores the index
        half-width, ``torch.int8`` bin-quantized (a quarter)."""
        cand_ds = self.candidate_embeddings(candidates, batch_size=batch_size, device=device)
        return TopKEncoder(self._query, candidates=cand_ds, k=k,
                           item_id_name=self.item_id_name,
                           candidate_dtype=candidate_dtype, device=device)

    def evaluate(self, data, batch_size: Optional[int] = None, item_corpus=None, k: int = 10,
                 steps: Optional[int] = None, pre=None, device=None):
        """In-batch evaluation (:meth:`Model.evaluate`), or, with
        ``item_corpus`` (a Dataset of items), each query scored against the
        whole corpus: a brute-force fp32 index of the candidate tower's
        embeddings, then the top-k metrics of its ``k`` best."""
        if item_corpus is None:
            return super().evaluate(data, batch_size=batch_size, steps=steps, pre=pre,
                                    device=device)
        if pre is not None:
            raise NotImplementedError("evaluate(item_corpus=, pre=) is not ported yet "
                                      "(ROADMAP.md queue 1)")
        corpus = None if item_corpus is True else item_corpus
        topk = self.to_top_k_encoder(corpus, k=k, device=device)
        return topk.evaluate(data, batch_size=batch_size, steps=steps, device=device)


def TwoTowerModel(
    schema: Schema,
    query_tower: Sequence[int] = (128, 64),
    embedding_dim: Optional[int] = None,
    negative_samplers: Union[str, Sequence] = "in-batch",
    logits_temperature: float = 1.0,
    table_dtype: Optional[torch.dtype] = None,
    seed: int = 0,
    device=None,
) -> RetrievalModelV2:
    """USER columns feed the query tower, ITEM columns the candidate tower;
    each is an input block and an MLP of ``query_tower`` widths whose last
    layer is linear. The head trains on in-batch negatives. Weights are drawn
    from ``seed`` on ``device`` (default the card). ``table_dtype=
    torch.bfloat16`` stores the embedding tables bf16 at rest: train them with
    ``compile(embedding_optimizer=...)``."""
    dev = resolve_device(device)
    user_schema = schema.select_by_tag(Tags.USER)
    item_schema = schema.select_by_tag(Tags.ITEM)
    if not len(user_schema) or not len(item_schema):
        raise ValueError("TwoTowerModel needs USER- and ITEM-tagged columns")

    def build_tower(dims, tower_schema, tower_seed):
        inputs = InputBlockV2(tower_schema, dim=embedding_dim, param_dtype=table_dtype,
                              seed=tower_seed, device=dev)
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
