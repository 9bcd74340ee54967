"""InputBlockV2: schema -> (categorical | continuous) branches, concatenated
(``models_tpu/inputs/base.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from ..core.aggregation import ConcatFeatures
from ..core.combinators import ParallelBlock
from ..schema import Schema, Tags
from .continuous import Continuous
from .embedding import Embeddings


def InputBlockV2(schema: Schema, dim: Optional[int] = None,
                 param_dtype: Optional[torch.dtype] = None, seed: int = 0,
                 aggregation: Optional[str] = "concat", device=None) -> ParallelBlock:
    """Build the input layer from the schema; TARGET columns are excluded.
    The branches' outputs are concatenated into one (B, out_features) tensor
    (``aggregation="concat"``), or, with ``aggregation=None``, returned as
    the dict by column (sequence columns as :class:`SequenceFeature`);
    ``out_features`` is then the width they would concatenate to.
    ``param_dtype`` is the embedding tables' dtype at rest (see ``Embeddings``)."""
    if aggregation not in ("concat", None):
        raise ValueError(f"aggregation must be 'concat' or None, got {aggregation!r}")
    schema = schema.excluding_by_tag(Tags.TARGET)
    branches = {}
    cat_schema = schema.categorical
    if len(cat_schema):
        branches["categorical"] = Embeddings(cat_schema, dim=dim, param_dtype=param_dtype,
                                             seed=seed, device=device)
    cont_schema = schema.continuous.excluding_by_tag(Tags.EMBEDDING)
    if len(cont_schema):
        branches["continuous"] = Continuous(cont_schema)
    if not branches:
        raise ValueError("Schema produced no input branches")
    block = ParallelBlock(
        branches, aggregation=ConcatFeatures() if aggregation else None,
        block_name="input_block", schema=schema,
    )
    # every categorical column gives its table's dim, every continuous one 1
    tables = branches["categorical"].branches.values() if len(cat_schema) else ()
    block.out_features = len(cont_schema) + sum(t.dim * len(t.features) for t in tables)
    return block
