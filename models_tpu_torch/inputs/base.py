"""InputBlockV2: schema -> (categorical | continuous | pretrained) branches,
aggregated (``models_tpu/inputs/base.py``), and the V1 ``InputBlock``
adapter."""

from __future__ import annotations

from typing import Optional, Union

from torch import nn

from ..core.combinators import ParallelBlock
from ..schema import Schema, Tags
from .continuous import Continuous, ContinuousProjection
from .embedding import Embeddings, PretrainedEmbeddings


def InputBlockV2(schema: Schema, categorical: Optional[nn.Module] = None,
                 continuous: Optional[nn.Module] = None,
                 pretrained_embeddings: Optional[nn.Module] = None,
                 aggregation: Union[str, nn.Module, None] = "concat", seed: int = 0,
                 device=None, **embeddings_kwargs) -> ParallelBlock:
    """The input layer of a schema; TARGET columns are excluded. Branches:

    - ``categorical``: the given block, else ``Embeddings(categorical
      columns, seed=seed, device=device, **embeddings_kwargs)`` (``dim``,
      ``param_dtype``, ``trainable``, ``table_kwargs``, ``dynamic``, ...);
    - ``continuous``: the given block, else the continuous columns not
      tagged ``EMBEDDING`` as they are;
    - ``pretrained_embeddings``: the given block, else the ``EMBEDDING``
      columns (:func:`PretrainedEmbeddings`).

    ``aggregation`` (``"concat"``, any registered name or block, or None for
    the dict by column) merges them. ``out_features`` is the concatenation's
    width where the default branches make it known (each categorical column
    its table's dim, each continuous column 1), else None."""
    schema = schema.excluding_by_tag(Tags.TARGET)
    branches = {}
    cat_schema = schema.categorical
    if categorical is not None:
        branches["categorical"] = categorical
    elif len(cat_schema):
        branches["categorical"] = Embeddings(cat_schema, seed=seed, device=device,
                                             **embeddings_kwargs)
    cont_schema = schema.continuous.excluding_by_tag(Tags.EMBEDDING)
    if continuous is not None:
        branches["continuous"] = continuous
    elif len(cont_schema):
        branches["continuous"] = Continuous(cont_schema)
    emb_schema = schema.select_by_tag(Tags.EMBEDDING)
    if pretrained_embeddings is not None:
        branches["pretrained_embeddings"] = pretrained_embeddings
    elif len(emb_schema):
        branches["pretrained_embeddings"] = PretrainedEmbeddings(emb_schema)
    if not branches:
        raise ValueError("Schema produced no input branches")
    block = ParallelBlock(branches, aggregation=aggregation, block_name="input_block",
                          schema=schema)
    block.out_features = None
    if categorical is None and continuous is None and "pretrained_embeddings" not in branches:
        tables = branches["categorical"].branches.values() if "categorical" in branches else ()
        block.out_features = len(cont_schema) + sum(t.dim * len(t.features) for t in tables)
    return block


def InputBlock(schema: Schema, aggregation: Union[str, nn.Module, None] = "concat",
               continuous_projection=None, embedding_dims=None,
               embedding_dim_default: Optional[int] = None, seed: int = 0, device=None,
               **kwargs) -> ParallelBlock:
    """The V1 input constructor over :func:`InputBlockV2`: ``embedding_dims``
    (or ``embedding_dim_default``) as ``dim``; ``continuous_projection``, a
    block or widths (an ``MLPBlock``), over the continuous columns."""
    from ..blocks.mlp import MLPBlock

    dim = embedding_dims if embedding_dims is not None else embedding_dim_default
    continuous = None
    if continuous_projection is not None and len(schema.continuous):
        proj = continuous_projection
        if isinstance(proj, (tuple, list)):
            proj = MLPBlock(tuple(proj), device=device)
        continuous = ContinuousProjection(schema.continuous, proj)
    return InputBlockV2(schema, continuous=continuous, aggregation=aggregation, dim=dim,
                        seed=seed, device=device, **kwargs)
