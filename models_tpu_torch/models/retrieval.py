"""Retrieval models (``models_tpu/models/retrieval.py``): the two-tower
model, the matrix factorization and the YouTube-DNN candidate generator,
each a :class:`RetrievalModelV2` trained through its contrastive head and
served through ``to_top_k_encoder``. A tied model (no candidate tower: the
head's item table is the catalog) indexes the table itself."""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from ..blocks.mlp import MLPBlock
from ..core.block import Block, fresh_copy
from ..core.combinators import ParallelBlock, SequentialBlock
from ..core.device import resolve_device
from ..core.encoder import EmbeddingEncoder, Encoder, TopKEncoder
from ..data.dataset import Dataset
from ..inputs.base import InputBlockV2
from ..inputs.embedding import EmbeddingTable
from ..outputs.contrastive import ContrastiveOutput
from ..outputs.sampling import PopularityBasedSampler
from ..schema import Schema, Tags, infer_embedding_dim
from ..transforms.regularization import L2Norm
from .base import Model


class RetrievalModelV2(Model):
    """A query tower and a candidate tower, run side by side into a
    :class:`ContrastiveOutput`; or, with ``candidate=None``, the query tower
    alone into a head whose candidates are its tied table's rows; or, given
    ``*blocks``, those blocks in a row (the query encoder the first).
    ``item_id_name`` names the column whose values become the index's ids."""

    def __init__(self, *blocks, query: Optional[Block] = None,
                 candidate: Optional[Block] = None, output: Optional[ContrastiveOutput] = None,
                 schema: Optional[Schema] = None, block_name: str = "two_tower"):
        if blocks:
            Model.__init__(self, *blocks, schema=schema)
            self.block_name = block_name
            self._query = None
            self._candidate = None
            return
        if query is None or output is None:
            raise ValueError("RetrievalModelV2 needs blocks, or query= and output=")
        # Model.__init__ would register ``blocks`` first; the towers come
        # first, so that ``named_parameters()`` (which names a shared module
        # by its first registration) gives the JAX package's paths
        Block.__init__(self, schema=schema, block_name=block_name)
        self._query = query
        self._candidate = candidate
        encoder = query if candidate is None else ParallelBlock(
            {"query": query, "candidate": candidate})
        self.blocks = nn.ModuleList([encoder, output])

    @property
    def item_id_name(self) -> Optional[str]:
        return self.contrastive_output.item_id_name

    @property
    def contrastive_output(self) -> ContrastiveOutput:
        for head in self.heads():
            if isinstance(head, ContrastiveOutput):
                return head
        raise ValueError("Model has no ContrastiveOutput head")

    @property
    def query_encoder(self) -> Block:
        return self._query if self._query is not None else self.blocks[0]

    @property
    def candidate_encoder(self) -> Block:
        return self._candidate

    def query_embeddings(self, dataset: Optional[Dataset] = None, batch_size: int = 1024,
                         index: Union[str, Tags, None] = Tags.USER_ID, device=None) -> Dataset:
        """Encode the queries with the query tower, as ``id`` + ``embedding``;
        with no dataset, an :class:`EmbeddingEncoder` query tower's table."""
        if dataset is None:
            if not isinstance(self.query_encoder, EmbeddingEncoder):
                raise ValueError("query_embeddings needs a dataset unless the query tower is "
                                 "an EmbeddingEncoder")
            return self.query_encoder.to_dataset()
        return Encoder(self.query_encoder).encode(dataset, index=index, batch_size=batch_size,
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

    def to_top_k_encoder(self, candidates: Optional[Dataset] = None, k: int = 10,
                         batch_size: int = 1024, mesh=None,
                         candidate_dtype: Optional[torch.dtype] = None, device=None):
        """A servable and evaluable brute-force top-k model over the encoded
        ``candidates`` (a tied model: its table, no dataset needed);
        ``candidate_dtype=torch.bfloat16`` stores the index half-width,
        ``torch.int8`` bin-quantized (a quarter). ``mesh`` splits the index
        by rows over the mesh's model axis (``outputs/topk.py``): every rank
        calls it, and every rank of a model line serves the same queries."""
        cand_ds = self.candidate_embeddings(candidates, batch_size=batch_size, device=device)
        return TopKEncoder(self.query_encoder, candidates=cand_ds, k=k,
                           item_id_name=self.item_id_name,
                           candidate_dtype=candidate_dtype, device=device, mesh=mesh)

    to_top_k_recommender = to_top_k_encoder

    def evaluate(self, data, batch_size: Optional[int] = None, item_corpus=None, k: int = 10,
                 mesh=None, steps: Optional[int] = None, pre=None, device=None):
        """In-batch evaluation (:meth:`Model.evaluate`), or, with
        ``item_corpus`` (a Dataset of items, or True for a tied model's
        table), each query scored against the whole corpus: a brute-force
        fp32 index of the candidate embeddings, then the top-k metrics of
        its ``k`` best; ``mesh`` splits that index over the mesh's model
        axis."""
        if item_corpus is None:
            return super().evaluate(data, batch_size=batch_size, steps=steps, pre=pre,
                                    device=device)
        if pre is not None:
            raise NotImplementedError("evaluate(item_corpus=, pre=): the JAX package fails on "
                                      "it too, and the port leaves it (ROADMAP.md queue 3)")
        corpus = None if item_corpus is True else item_corpus
        topk = self.to_top_k_encoder(corpus, k=k, device=device, mesh=mesh)
        return topk.evaluate(data, batch_size=batch_size, steps=steps, device=device)


def MatrixFactorizationModel(
    schema: Schema,
    dim: Optional[int] = None,
    negative_samplers: Union[str, Sequence] = "in-batch",
    logits_temperature: float = 1.0,
    logq_correction: bool = True,
    l2_reg: float = 0.0,
    post: Optional[Block] = None,
    table_dtype: Optional[torch.dtype] = None,
    seed: int = 0,
    device=None,
) -> RetrievalModelV2:
    """The user-id table's row against the item-id table's (an
    :class:`EmbeddingEncoder` query, a head tied to the item table), trained
    by the sampled softmax over ``negative_samplers`` (``"in-batch"``,
    ``"popularity"``, a :class:`~models_tpu_torch.outputs.queue.CachedCrossBatchSampler`,
    or a list of them). ``dim`` defaults to the larger inferred width of the
    two columns; ``table_dtype=torch.bfloat16`` stores both tables bf16 at
    rest (train them with ``compile(embedding_optimizer=...)``); ``l2_reg``
    regularises both tables. Weights from ``seed`` (the item table's from
    ``seed + 1``) on ``device`` (default the card)."""
    dev = resolve_device(device)
    user_col, item_col = schema.user_id_column, schema.item_id_column
    if dim is None:
        dim = max(infer_embedding_dim(user_col), infer_embedding_dim(item_col))
    tkw = dict(l2_reg=l2_reg, dtype=table_dtype or torch.float32, device=dev)
    user_table = EmbeddingTable(dim, user_col, seed=seed, **tkw)
    item_table = EmbeddingTable(dim, item_col, seed=seed + 1, **tkw)
    output = ContrastiveOutput(item_table, negative_samplers=negative_samplers,
                               logits_temperature=logits_temperature,
                               logq_sampling_correction=logq_correction, post=post)
    output.to(dev)
    return RetrievalModelV2(query=EmbeddingEncoder(user_table), output=output, schema=schema,
                            block_name="matrix_factorization")


MatrixFactorizationModelV2 = MatrixFactorizationModel


def TwoTowerModel(
    schema: Schema,
    query_tower: Union[Block, Sequence[int], None] = (128, 64),
    item_tower: Union[Block, Sequence[int], None] = None,
    embedding_dim: Optional[int] = None,
    negative_samplers: Union[str, Sequence] = "in-batch",
    logits_temperature: float = 1.0,
    l2_norm: bool = False,
    dropout: Optional[float] = None,
    post: Optional[Block] = None,
    table_dtype: Optional[torch.dtype] = None,
    seed: int = 0,
    device=None,
) -> RetrievalModelV2:
    """USER columns feed the query tower, ITEM columns the candidate tower.
    A tower given as widths is an input block and an MLP of those widths
    (its last layer linear, ``dropout`` after each layer where given); a
    tower given as a Block is used as it is (it takes the batch dict). The
    item tower defaults to the query tower's widths, or to a re-seeded copy
    of a query Block (:func:`~models_tpu_torch.core.block.fresh_copy`: one
    Block never serves both towers). ``l2_norm`` normalises both towers'
    outputs (cosine training); ``post`` goes to the contrastive head
    (:class:`~models_tpu_torch.outputs.contrastive.ContrastiveSampleWeight`).
    Weights are drawn from ``seed`` on ``device`` (default the card).
    ``table_dtype=torch.bfloat16`` stores the embedding tables bf16 at rest:
    train them with ``compile(embedding_optimizer=...)``."""
    dev = resolve_device(device)
    user_schema = schema.select_by_tag(Tags.USER)
    item_schema = schema.select_by_tag(Tags.ITEM)
    if not len(user_schema) or not len(item_schema):
        raise ValueError("TwoTowerModel needs USER- and ITEM-tagged columns")

    def build_tower(tower, tower_schema, tower_seed):
        if isinstance(tower, Block):
            return tower.to(dev)
        dims = tuple(tower) if tower is not None else (128, 64)
        inputs = InputBlockV2(tower_schema, dim=embedding_dim, param_dtype=table_dtype,
                              seed=tower_seed, device=dev)
        layers = [inputs, MLPBlock(dims, dropout=dropout, no_activation_last_layer=True,
                                   seed=tower_seed, in_features=inputs.out_features,
                                   device=dev)]
        if l2_norm:
            layers.append(L2Norm())
        block = SequentialBlock(layers)
        block.schema = tower_schema.excluding_by_tag(Tags.TARGET)
        return block

    query = build_tower(query_tower, user_schema, seed)
    if item_tower is None and isinstance(query_tower, Block):
        item_tower = fresh_copy(query_tower, 1)
    candidate = build_tower(item_tower if item_tower is not None else query_tower,
                            item_schema, seed + 100)
    output = ContrastiveOutput(schema.item_id_column, negative_samplers=negative_samplers,
                               logits_temperature=logits_temperature, post=post)
    output.to(dev)
    return RetrievalModelV2(query=query, candidate=candidate, output=output, schema=schema)


TwoTowerModelV2 = TwoTowerModel


def YoutubeDNNRetrievalModel(
    schema: Schema,
    top_block: Union[Block, Sequence[int]] = (64,),
    num_sampled: int = 100,
    embedding_dim: Optional[int] = None,
    logits_temperature: float = 1.0,
    seed: int = 0,
    device=None,
) -> RetrievalModelV2:
    """The YouTube-DNN candidate generator: every non-target column but the
    item id (an input block) through an MLP of ``top_block`` widths and the
    item table's width (its last layer linear), scored by the sampled
    softmax over the tied item table with ``num_sampled`` popularity-sampled
    negatives a step (logQ-corrected, the positive's too). The item table's
    width is ``embedding_dim`` or inferred from its cardinality. Weights
    from ``seed`` on ``device`` (default the card)."""
    dev = resolve_device(device)
    item_col = schema.item_id_column
    dim = embedding_dim or infer_embedding_dim(item_col)
    input_schema = schema.excluding_by_tag(Tags.TARGET)
    item_table = EmbeddingTable(dim, item_col, seed=seed, device=dev)
    rest = input_schema.excluding_by_name(item_col.name)
    inputs = (InputBlockV2(rest, dim=embedding_dim, seed=seed, device=dev)
              if len(rest.categorical) or len(input_schema.continuous) else None)
    if not isinstance(top_block, Block):
        if inputs is None:
            raise ValueError("YoutubeDNNRetrievalModel needs input columns besides the item id "
                             "to size its MLP (or a top_block Block)")
        top_block = MLPBlock(tuple(top_block) + (dim,), no_activation_last_layer=True,
                             seed=seed, in_features=inputs.out_features, device=dev)
    sampler = PopularityBasedSampler(max_num_samples=num_sampled,
                                     max_id=item_col.cardinality - 1, seed=seed)
    output = ContrastiveOutput(item_table, negative_samplers=[sampler],
                               logits_temperature=logits_temperature)
    output.to(dev)
    query = SequentialBlock(([inputs] if inputs is not None else []) + [top_block.to(dev)])
    return RetrievalModelV2(query=query, output=output, schema=schema, block_name="youtube_dnn")
