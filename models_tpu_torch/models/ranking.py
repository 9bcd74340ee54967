"""The ranking models (``models_tpu/models/ranking.py``): DLRM, DCN-v2,
DeepFM and Wide&Deep, each a body and the heads of the schema's TARGET
columns (:func:`~models_tpu_torch.outputs.base.OutputBlock`). Widths follow
from the schema at construction; weights are drawn from ``seed`` on
``device`` (default the card).

Wide&Deep's wide path is the JAX package's function, ``Dense(1)`` over the
concatenated multi-hot encoding of the categorical columns and the one-hot
hashed crosses of every pair of them (``transforms/features.py``), with that
``Dense``'s parameters. The JAX package materialises the (B, sum of widths)
input; on ``criteo-small`` (26 x 1000 ids, 325 x 1000 cross bins) that is
(B, 351,000) float32, 11.5 GB at batch 8192. The port computes the same
product as the sum of the kernel's entries at each column's ids (offset by
the column's start) plus the bias, and never makes the dense input
(:meth:`_WidePath.dense_forward` keeps the dense form as the plain version).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F

from ..blocks.cross import CrossBlock
from ..blocks.dlrm import DLRMBlock
from ..blocks.interaction import FMBlock
from ..blocks.mlp import Dense, MLPBlock
from ..core.aggregation import ConcatFeatures
from ..core.block import Block
from ..core.combinators import ParallelBlock, SequentialBlock
from ..core.device import resolve_device
from ..core.policy import cast_compute
from ..inputs.base import InputBlockV2
from ..outputs.base import OutputBlock
from ..schema import Schema, Tags
from .base import Model


def _model(body: Block, schema: Schema, name: str, prediction_tasks, dev) -> Model:
    heads = prediction_tasks if prediction_tasks is not None else OutputBlock(
        schema, in_features=body.out_features, device=dev)
    model = Model(body, heads)
    model.schema = schema
    model.block_name = name
    return model


def DLRMModel(
    schema: Schema,
    embedding_dim: int = 64,
    bottom_block: Union[Block, Sequence[int], None] = None,
    top_block: Union[Block, Sequence[int], None] = (256, 128),
    prediction_tasks: Optional[Block] = None,
    seed: int = 0,
    device=None,
) -> Model:
    """DLRM: ``bottom_block`` widths take ``embedding_dim`` as their last
    (``(256, 64)`` -> an MLP of 256, 64, 64 over the continuous columns);
    ``top_block`` widths are the top MLP's over the interactions."""
    dev = resolve_device(device)
    n_cont = len(schema.excluding_by_tag(Tags.TARGET).continuous)
    if isinstance(bottom_block, (list, tuple)):
        bottom_block = MLPBlock(list(bottom_block) + [embedding_dim], seed=seed,
                                in_features=n_cont, device=dev) if n_cont else None
    if isinstance(top_block, (list, tuple)):
        top_block = MLPBlock(top_block, seed=seed + 1,
                             in_features=DLRMBlock.interaction_width(schema, embedding_dim),
                             device=dev)
    body = DLRMBlock(schema, embedding_dim=embedding_dim, bottom_block=bottom_block,
                     top_block=top_block, seed=seed, device=dev)
    return _model(body, schema, "dlrm", prediction_tasks, dev)


def DCNModel(
    schema: Schema,
    depth: int = 2,
    deep_block: Union[Block, Sequence[int], None] = (64, 32),
    stacked: bool = True,
    low_rank_dim: Optional[int] = None,
    embedding_dim: Optional[int] = None,
    prediction_tasks: Optional[Block] = None,
    seed: int = 0,
    device=None,
) -> Model:
    """DCN-v2 over the input block's concatenation: stacked (cross ->
    deep) or parallel (cross ‖ deep, concatenated)."""
    dev = resolve_device(device)
    inputs = InputBlockV2(schema, dim=embedding_dim, seed=seed, device=dev)
    d = inputs.out_features
    if isinstance(deep_block, (list, tuple)):
        deep_block = MLPBlock(deep_block, seed=seed, in_features=d, device=dev)
    cross = CrossBlock(depth, low_rank_dim=low_rank_dim, seed=seed, in_features=d, device=dev)
    if stacked:
        body = SequentialBlock([inputs, cross] + ([deep_block] if deep_block else []))
        body.out_features = deep_block.out_features if deep_block else d
    else:
        body = SequentialBlock([inputs, ParallelBlock({"cross": cross, "deep": deep_block},
                                                      aggregation=ConcatFeatures())])
        body.out_features = d + deep_block.out_features
    return _model(body, schema, "dcn", prediction_tasks, dev)


class _DeepFMBody(Block):
    """The factorisation machine ‖ the deep MLP over the input block."""

    def __init__(self, schema: Schema, deep_block, latent_dim: int, seed: int, device):
        super().__init__(schema=schema.excluding_by_tag(Tags.TARGET))
        self.fm = FMBlock(self.schema, latent_dim=latent_dim, seed=seed, device=device)
        self.inputs = InputBlockV2(self.schema, dim=latent_dim, seed=seed, device=device)
        if isinstance(deep_block, (list, tuple)):
            deep_block = MLPBlock(deep_block, seed=seed, in_features=self.inputs.out_features,
                                  device=device)
        self.deep = deep_block
        self.out_features = 1 + deep_block.out_features

    def forward(self, x, **kwargs):
        deep_out = self.deep(self.inputs(x, **kwargs), **kwargs)
        return torch.cat([self.fm(x, **kwargs), deep_out], dim=-1)


def DeepFMModel(
    schema: Schema,
    embedding_dim: int = 64,
    deep_block: Union[Block, Sequence[int]] = (64, 32),
    prediction_tasks: Optional[Block] = None,
    seed: int = 0,
    device=None,
) -> Model:
    dev = resolve_device(device)
    body = _DeepFMBody(schema, deep_block, embedding_dim, seed, dev)
    return _model(body, schema, "deepfm", prediction_tasks, dev)


class _WidePath(Block):
    """A linear model over the categorical columns' multi-hot encoding and,
    with ``crosses``, the one-hot hashed crosses of every pair of them:
    ``encoding`` (a :class:`CategoryEncoding`), ``crosses`` (a
    :class:`HashedCrossAll`) and ``linear``, a ``Dense(1)`` over their
    concatenated width (the module's note)."""

    def __init__(self, schema: Schema, crosses: bool = True, seed: int = 0, device=None):
        from ..transforms.features import CategoryEncoding, HashedCrossAll

        super().__init__(schema=schema.excluding_by_tag(Tags.TARGET))
        self.encoding = CategoryEncoding(self.schema.categorical, output_mode="multi_hot")
        self.crosses = (HashedCrossAll(self.schema.categorical, max_level=2, num_bins=1000)
                        .to(device) if crosses else None)
        cols = list(self.schema.categorical)
        widths = [c.cardinality for c in cols]
        if self.crosses is not None:
            if any(c.is_list for c in cols):
                raise ValueError("Wide&Deep's crosses take scalar categorical columns")
            widths += [self.crosses.num_bins] * len(self.crosses.crosses)
        starts = torch.tensor([0] + widths[:-1]).cumsum(0)
        self.columns = [c.name for c in cols]
        self.cardinalities = [c.cardinality for c in cols]
        self.scalar = [i for i, c in enumerate(cols) if not c.is_list]
        self.register_buffer("starts", starts.to(device=device, dtype=torch.int64),
                             persistent=False)
        self.register_buffer("scalar_starts", starts[self.scalar].to(device=device),
                             persistent=False)
        self.register_buffer("scalar_cards", torch.tensor(
            [self.cardinalities[i] for i in self.scalar], dtype=torch.int64, device=device),
            persistent=False)
        self.linear = Dense(1, use_bias=True, seed=seed, in_features=sum(widths), device=device)

    def dense_forward(self, x) -> torch.Tensor:
        """The JAX package's form: ``linear`` over the dense encoding."""
        enc = self.encoding(x)
        if self.crosses is not None:
            enc = torch.cat([enc, self.crosses(x)], dim=-1)
        return self.linear(enc)

    def forward(self, x, **kwargs) -> torch.Tensor:
        kernel = cast_compute(self.linear.weight).float().reshape(-1, 1)  # (sum of widths, 1)

        def gathered(ids, keep, starts):
            # the kernel's entries at ids (B, n) offset by their columns' starts,
            # summed over the valid ones
            rows = F.embedding(torch.where(keep, ids, 0) + starts, kernel)[..., 0]
            return (rows * keep).sum(dim=1)

        total = 0.0
        if self.scalar:
            ids = torch.stack([x[self.columns[i]].reshape(-1).to(torch.int64)
                               for i in self.scalar], 1)
            total = gathered(ids, (ids >= 0) & (ids < self.scalar_cards), self.scalar_starts)
        for i, (name, card) in enumerate(zip(self.columns, self.cardinalities)):
            v = x[name]
            if i in self.scalar:
                continue
            ids, keep = v.values.to(torch.int64), v.mask & (v.values >= 0) & (v.values < card)
            if self.encoding.output_mode != "count":
                # a row's repeated ids count once: sorted, the first of each run
                ids = torch.where(keep, ids, -1).sort(dim=1)[0]
                keep = ids >= 0
                keep[:, 1:] &= ids[:, 1:] != ids[:, :-1]
            total = total + gathered(ids, keep, self.starts[i])
        if self.crosses is not None:
            buckets = self.crosses.buckets(x)
            total = total + gathered(buckets, torch.ones_like(buckets, dtype=torch.bool),
                                     self.starts[len(self.columns):])
        out = total[:, None]
        return out if self.linear.bias is None else out + self.linear.bias


def WideAndDeepModel(
    schema: Schema,
    embedding_dim: int = 32,
    deep_block: Union[Block, Sequence[int], None] = (64, 32),
    wide_schema: Optional[Schema] = None,
    enable_wide_crosses: bool = True,
    prediction_tasks: Optional[Block] = None,
    seed: int = 0,
    device=None,
) -> Model:
    """Wide&Deep: the wide linear path (:class:`_WidePath`, over
    ``wide_schema``, default the schema) ‖ the deep MLP over the input
    block's embeddings (``embedding_dim`` wide), concatenated."""
    dev = resolve_device(device)
    inputs = InputBlockV2(schema, dim=embedding_dim, seed=seed, device=dev)
    if isinstance(deep_block, (list, tuple)):
        deep_block = MLPBlock(deep_block, seed=seed, in_features=inputs.out_features, device=dev)
    wide = _WidePath(wide_schema or schema, crosses=enable_wide_crosses, seed=seed, device=dev)
    body = ParallelBlock({"wide": wide, "deep": SequentialBlock([inputs, deep_block])},
                         aggregation="concat")
    body.schema = schema.excluding_by_tag(Tags.TARGET)
    body.out_features = 1 + deep_block.out_features
    return _model(body, schema, "wide_and_deep", prediction_tasks, dev)
