"""The V1 retrieval blocks (``models_tpu/blocks/retrieval.py``): the V1
names mapped onto the two-tower and matrix-factorization machinery of
``models/retrieval.py`` and the contrastive head.

The port takes every width at construction: a tower given as widths is
built on its input block's width; a tower given as a Block must take that
width itself."""

from __future__ import annotations

from typing import Optional, Sequence, Union

from torch import nn

from ..core.block import fresh_copy
from ..core.combinators import ParallelBlock, SequentialBlock
from ..core.device import resolve_device
from ..inputs.base import InputBlockV2
from ..outputs.contrastive import ContrastiveOutput
from ..schema import Schema, Tags
from .mlp import MLPBlock


class TowerBlock(SequentialBlock):
    """A named single tower."""

    def __init__(self, block: nn.Module, block_name: str = "tower"):
        super().__init__([block], block_name=block_name)


def DualEncoderBlock(query: nn.Module, item: nn.Module, aggregation=None,
                     block_name: str = "dual_encoder") -> ParallelBlock:
    """``ParallelBlock({"query": query, "candidate": item})``."""
    return ParallelBlock({"query": query, "candidate": item}, aggregation=aggregation,
                         block_name=block_name)


def ItemRetrievalScorer(samplers: Union[str, Sequence] = "in-batch",
                        sampling_downscore_false_negatives: bool = True,
                        item_id_feature_name: Optional[str] = None,
                        logits_temperature: float = 1.0, **kwargs) -> ContrastiveOutput:
    """The contrastive head under the V1 argument names."""
    return ContrastiveOutput(negative_samplers=samplers, target=item_id_feature_name,
                             downscore_false_negatives=sampling_downscore_false_negatives,
                             logits_temperature=logits_temperature, **kwargs)


def TwoTowerBlock(schema: Schema, query_tower: Union[nn.Module, Sequence[int]],
                  item_tower: Union[nn.Module, Sequence[int], None] = None,
                  embedding_dim: Optional[int] = None, seed: int = 0,
                  device=None) -> ParallelBlock:
    """USER features (an input block) into the query tower, ITEM features
    into the item tower, as a :func:`DualEncoderBlock` named
    ``"two_tower"``. A tower is a Block on its input block's width, or
    widths (an MLP whose last layer is linear); the item tower defaults to
    the query tower's widths, or a re-seeded copy of the query Block
    (:func:`~models_tpu_torch.core.block.fresh_copy`)."""
    dev = resolve_device(device)
    user_schema = schema.select_by_tag(Tags.USER).excluding_by_tag(Tags.TARGET)
    item_schema = schema.select_by_tag(Tags.ITEM).excluding_by_tag(Tags.TARGET)
    if not len(user_schema) or not len(item_schema):
        raise ValueError("TwoTowerBlock needs USER- and ITEM-tagged columns")
    if item_tower is None:
        item_tower = fresh_copy(query_tower, 1) if isinstance(query_tower, nn.Module) \
            else query_tower

    def tower(tower_schema, block, tower_seed):
        inputs = InputBlockV2(tower_schema, dim=embedding_dim, seed=tower_seed, device=dev)
        if not isinstance(block, nn.Module):
            block = MLPBlock(tuple(block), no_activation_last_layer=True, seed=tower_seed,
                             in_features=inputs.out_features, device=dev)
        return SequentialBlock([inputs, block.to(dev)])

    return DualEncoderBlock(tower(user_schema, query_tower, seed),
                            tower(item_schema, item_tower, seed + 1), block_name="two_tower")


def MatrixFactorizationBlock(schema: Schema, dim: int, seed: int = 0, aggregation=None,
                             device=None) -> ParallelBlock:
    """The user-id and item-id tables as the two towers (each an
    :class:`~models_tpu_torch.core.encoder.EmbeddingEncoder`), named
    ``"mf"``."""
    from ..core.encoder import EmbeddingEncoder
    from ..inputs.embedding import EmbeddingTable

    dev = resolve_device(device)
    user_col = schema.select_by_tag(Tags.USER_ID).first
    item_col = schema.select_by_tag(Tags.ITEM_ID).first
    query = EmbeddingEncoder(EmbeddingTable(dim, user_col, seed=seed, device=dev))
    item = EmbeddingEncoder(EmbeddingTable(dim, item_col, seed=seed + 1, device=dev))
    return DualEncoderBlock(query, item, aggregation=aggregation, block_name="mf")


def QueryItemIdsEmbeddingsBlock(schema: Schema, dim: int, seed: int = 0, aggregation=None,
                                device=None) -> ParallelBlock:
    """The V1 name of :func:`MatrixFactorizationBlock`."""
    return MatrixFactorizationBlock(schema, dim, seed=seed, aggregation=aggregation,
                                    device=device)
