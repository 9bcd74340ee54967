"""The ranking models (``models_tpu/models/ranking.py``): DLRM, DCN-v2 and
DeepFM, each a body and the heads of the schema's TARGET columns
(:func:`~models_tpu_torch.outputs.base.OutputBlock`). Widths follow from the
schema at construction; weights are drawn from ``seed`` on ``device``
(default the card). ``WideAndDeepModel`` waits for the feature transforms
(``CategoryEncoding``, ``HashedCrossAll``; ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from ..blocks.cross import CrossBlock
from ..blocks.dlrm import DLRMBlock
from ..blocks.interaction import FMBlock
from ..blocks.mlp import MLPBlock
from ..core.aggregation import ConcatFeatures
from ..core.block import Block
from ..core.combinators import ParallelBlock, SequentialBlock
from ..core.device import resolve_device
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
        bottom_block = MLPBlock(n_cont, list(bottom_block) + [embedding_dim], seed=seed,
                                device=dev)
    if isinstance(top_block, (list, tuple)):
        top_block = MLPBlock(DLRMBlock.interaction_width(schema, embedding_dim), top_block,
                             seed=seed + 1, device=dev)
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
        deep_block = MLPBlock(d, deep_block, seed=seed, device=dev)
    cross = CrossBlock(d, depth, low_rank_dim=low_rank_dim, seed=seed, device=dev)
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
            deep_block = MLPBlock(self.inputs.out_features, deep_block, seed=seed,
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
