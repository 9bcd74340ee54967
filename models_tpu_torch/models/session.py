"""Session-based next-item models (``models_tpu/models/session.py``): the
sequence features through a transformer into a sampled softmax over the item
catalog, the item table tied between the inputs and the head.

    model = SessionBasedTransformerModel(schema, GPT2Block(128, 8, 2, dropout=0.0),
                                         embedding_dim=128)
    model.compile(optimizer="adam", learning_rate=1e-3, metrics=[])
    model.fit(ds, batch_size=1024, pre=SequencePredictNext(schema, target="item_id_seq"))
    model.evaluate(ds, batch_size=1024, pre=SequencePredictLast(schema, target="item_id_seq"))
"""

from __future__ import annotations

from typing import Optional

import torch

from ..blocks.mlp import Dense
from ..core.block import Block
from ..core.combinators import SequentialBlock
from ..core.device import resolve_device
from ..core.types import SequenceFeature
from ..inputs.base import InputBlockV2
from ..inputs.embedding import EmbeddingTable
from ..outputs.contrastive import ContrastiveOutput
from ..outputs.sampling import PopularityBasedSampler
from ..schema import Schema, Tags
from ..transformer.block import TransformerBlock
from ..transforms.sequence import ReplaceMaskedEmbeddings
from .retrieval import RetrievalModelV2


class _SequenceConcat(Block):
    """Concatenate the 3-D sequence features and the 2-D context features,
    in sorted name order, into (B, L, D): a context feature repeats along
    the L positions (the reference's ``BroadcastToSequence``)."""

    def forward(self, inputs: dict, **kwargs):
        mask = next((inputs[n].mask for n in sorted(inputs)
                     if isinstance(inputs[n], SequenceFeature)), None)
        if mask is None:
            raise ValueError("Session model needs at least one sequence feature")
        L = mask.shape[1]
        parts = []
        for name in sorted(inputs):
            v = inputs[name]
            arr = v.values if isinstance(v, SequenceFeature) else v
            if arr.ndim == 1:
                arr = arr[:, None]
            if arr.ndim == 2:
                arr = arr[:, None, :].expand(-1, L, -1)
            parts.append(arr)
        return SequenceFeature(torch.cat(parts, dim=-1), mask)


class _ProjectToTableDim(Block):
    """Project the transformer's hidden states to the item table's width for
    the tied head (``dense``, no bias); none where the widths match."""

    def __init__(self, in_features: int, dim: int, seed: int = 0, device=None):
        super().__init__()
        self.dim = dim
        self.dense = (None if in_features == dim else
                      Dense(dim, use_bias=False, seed=seed, in_features=in_features,
                            device=device))

    def forward(self, inputs, **kwargs):
        if self.dense is None:
            return inputs
        if isinstance(inputs, SequenceFeature):
            return SequenceFeature(self.dense(inputs.values), inputs.mask)
        return self.dense(inputs)


def _find_item_table(input_block, item_domain: str) -> EmbeddingTable:
    for b in input_block.modules():
        if isinstance(b, EmbeddingTable) and b.block_name == item_domain:
            return b
    raise ValueError(f"No embedding table for domain {item_domain!r} in input block")


def SessionBasedTransformerModel(
    schema: Schema,
    transformer: Optional[TransformerBlock] = None,
    embedding_dim: Optional[int] = None,
    num_sampled: Optional[int] = None,
    masked_lm: bool = False,
    logits_temperature: float = 1.0,
    seed: int = 0,
    device=None,
) -> RetrievalModelV2:
    """Sequence features -> transformer -> sampled softmax over the item
    catalog, the ITEM_ID column's table tied to the head.

    ``num_sampled=None`` takes in-batch negatives over the flattened
    positions; an int, that many popularity-sampled negatives a step with
    the logQ correction. ``masked_lm=True`` puts
    :class:`~models_tpu_torch.transforms.sequence.ReplaceMaskedEmbeddings`
    before the transformer (train with ``SequenceMaskRandom``) and makes
    the default transformer bidirectional. The transformer (default
    ``TransformerBlock(d_model=table width, n_heads=4, n_layers=2)``) takes
    the input block's width, worked out from the schema; the model lives on
    ``device`` (default the card), the transformer moved there."""
    dev = resolve_device(device)
    item_col = schema.select_by_tag(Tags.ITEM_ID).first
    input_schema = schema.excluding_by_tag(Tags.TARGET)
    input_block = InputBlockV2(input_schema, dim=embedding_dim, aggregation=None, seed=seed,
                               device=dev)
    width = input_block.out_features
    item_table = _find_item_table(input_block, item_col.domain_name)
    if transformer is None:
        transformer = TransformerBlock(d_model=item_table.dim, n_heads=4, n_layers=2,
                                       causal=not masked_lm, seed=seed, device=dev)
    transformer = transformer.to(dev)
    transformer.set_in_features(width, dev)

    samplers = ["in-batch"]
    if num_sampled:
        samplers = [PopularityBasedSampler(max_num_samples=num_sampled,
                                           max_id=item_col.cardinality - 1, seed=seed,
                                           device=dev)]
    output = ContrastiveOutput(item_table, negative_samplers=samplers,
                               logits_temperature=logits_temperature)
    blocks = [input_block, _SequenceConcat()]
    if masked_lm:
        blocks.append(ReplaceMaskedEmbeddings(width, device=dev))
    blocks += [transformer, _ProjectToTableDim(transformer.d_model, item_table.dim, seed=seed,
                                               device=dev)]
    model = RetrievalModelV2(query=SequentialBlock(blocks), output=output, schema=schema)
    model.block_name = "session_transformer"
    return model
