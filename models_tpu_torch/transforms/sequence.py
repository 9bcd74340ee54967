"""Sequence transforms for session models (``models_tpu/transforms/sequence.py``).

Each transform returns ``(features, targets)``, the target a
:class:`SequenceFeature` whose mask marks the positions to predict (or, for
the predict-last and predict-random protocols, the (B,) item ids), and
leaves the mask in the context under ``MASK_KEY``. Shapes stay static:
positions are masked, never gathered. Use one as
``model.fit(..., pre=SequencePredictNext(schema, target="item_id_seq"))``;
the engine runs it on the batch's tensors inside the training step, on the
chunked route inside the captured graph.

The random transforms draw from their own generator
(:class:`~models_tpu_torch.core.block.RandomBlock`), where the JAX package
folds the step into a key: the two packages draw different positions, and
the parity tests give the port JAX's draws.
"""

from __future__ import annotations

from typing import Union

import torch
from torch import nn

from ..core.block import Block, RandomBlock
from ..core.types import MASK_KEY, SequenceFeature
from ..schema import ColumnSchema, Schema, Tags


def _as_seq(v) -> SequenceFeature:
    return v if isinstance(v, SequenceFeature) else SequenceFeature(v)


def _last_index(seq: SequenceFeature) -> torch.Tensor:
    """(B,) the last valid position of each row, 0 for an empty row."""
    return (seq.lengths() - 1).clamp_min(0)


def _positions(seq: SequenceFeature) -> torch.Tensor:
    """(1, L) the positions 0..L-1."""
    return torch.arange(seq.values.shape[1], device=seq.values.device)[None, :]


def _take(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``values[b, idx[b]]`` for each row b."""
    return values.gather(1, idx.long()[:, None])[:, 0]


class SequenceTransform(Block):
    """Base: resolves the target sequence column (a name, a column or a
    tag) and the schema's list columns, whose masks the transforms rewrite."""

    def __init__(self, schema: Schema, target: Union[str, ColumnSchema, Tags], **kwargs):
        if isinstance(target, Tags):
            target = schema.select_by_tag(target).first.name
        elif isinstance(target, ColumnSchema):
            target = target.name
        super().__init__(schema=schema, **kwargs)
        self.target = target
        self.seq_names = [c.name for c in schema if c.is_list]

    def _finish(self, out, new_target, mask, context):
        """Stash the mask and the target in the context; ``(out, targets)``."""
        if context is not None:
            if mask is not None:
                context[MASK_KEY] = mask
            context.targets = {self.target: new_target}
        return out, {self.target: new_target}

    def _with_input_mask(self, inputs, mask):
        """The inputs with every list column's mask replaced by ``mask``."""
        out = dict(inputs)
        for name in self.seq_names:
            out[name] = SequenceFeature(_as_seq(out[name]).values, mask)
        return out


class SequencePredictNext(SequenceTransform):
    """Causal LM: each position predicts the next item. Lengths stay L: the
    target is the sequence shifted left, its mask the positions whose next
    item exists; every list input loses its last valid position."""

    def forward(self, inputs, *, targets=None, context=None, training=False, **kwargs):
        out = dict(inputs)
        seq = _as_seq(inputs[self.target])
        shifted = torch.roll(seq.values, -1, dims=1)
        pred_mask = seq.mask & torch.roll(seq.mask, -1, dims=1)
        pred_mask[:, -1] = False
        for name in self.seq_names:
            v = _as_seq(out[name])
            out[name] = SequenceFeature(v.values, pred_mask | (v.mask & ~seq.mask))
        return self._finish(out, SequenceFeature(shifted, pred_mask), pred_mask, context)


class SequencePredictLast(SequenceTransform):
    """The target is each row's last valid item, (B,); the inputs are the
    positions before it."""

    def forward(self, inputs, *, targets=None, context=None, training=False, **kwargs):
        seq = _as_seq(inputs[self.target])
        last = _last_index(seq)
        input_mask = seq.mask & (_positions(seq) < last[:, None])
        out = self._with_input_mask(inputs, input_mask)
        return self._finish(out, _take(seq.values, last), input_mask, context)


class SequencePredictRandom(SequenceTransform, RandomBlock):
    """Each row predicts the item at a random position in [1, length - 1]
    (one uniform draw a row), conditioned on the positions before it."""

    def __init__(self, schema: Schema, target, seed: int = 0, device=None):
        super().__init__(schema, target, seed=seed, device=device)

    def draw(self, seq: SequenceFeature) -> torch.Tensor:
        """(B,) uniform [0, 1) draws."""
        return torch.rand(seq.values.shape[0], generator=self.generator,
                          device=seq.values.device)

    def forward(self, inputs, *, targets=None, context=None, training=False, **kwargs):
        seq = _as_seq(inputs[self.target])
        u = self.draw(seq)
        max_pos = (seq.lengths() - 1).clamp_min(1)
        pick = torch.minimum(1 + (u * (max_pos - 1).to(torch.float32)).to(torch.int32), max_pos)
        input_mask = seq.mask & (_positions(seq) < pick[:, None])
        out = self._with_input_mask(inputs, input_mask)
        return self._finish(out, _take(seq.values, pick), input_mask, context)


class SequenceTargetAsInput(SequenceTransform):
    """The whole sequence as input and as target; pair with a masking
    transform."""

    def forward(self, inputs, *, targets=None, context=None, training=False, **kwargs):
        seq = _as_seq(inputs[self.target])
        return self._finish(dict(inputs), SequenceFeature(seq.values, seq.mask), None, context)


class SequenceMaskRandom(SequenceTransform, RandomBlock):
    """BERT-style masking: each valid position is chosen for prediction with
    probability ``masking_prob`` (one uniform draw a position), and a row
    with none chosen gets its last valid position; the chosen positions are
    the targets, and :class:`ReplaceMaskedEmbeddings` hides their inputs."""

    def __init__(self, schema: Schema, target, masking_prob: float = 0.2, seed: int = 0,
                 device=None):
        super().__init__(schema, target, seed=seed, device=device)
        self.masking_prob = masking_prob

    def draw(self, seq: SequenceFeature) -> torch.Tensor:
        """(B, L) uniform [0, 1) draws."""
        return torch.rand(seq.values.shape[:2], generator=self.generator,
                          device=seq.values.device)

    def forward(self, inputs, *, targets=None, context=None, training=False, **kwargs):
        seq = _as_seq(inputs[self.target])
        pred_mask = (self.draw(seq) < self.masking_prob) & seq.mask
        none_masked = (pred_mask.sum(dim=1) == 0) & (seq.lengths() > 0)
        force_last = none_masked[:, None] & (_positions(seq) == _last_index(seq)[:, None])
        pred_mask = pred_mask | force_last
        return self._finish(dict(inputs), SequenceFeature(seq.values, pred_mask), pred_mask,
                            context)


class SequenceMaskLast(SequenceTransform):
    """Mask only each row's last valid position: the next-item evaluation
    protocol of a masked-LM model."""

    def forward(self, inputs, *, targets=None, context=None, training=False, **kwargs):
        seq = _as_seq(inputs[self.target])
        pred_mask = seq.mask & (_positions(seq) == _last_index(seq)[:, None])
        return self._finish(dict(inputs), SequenceFeature(seq.values, pred_mask), pred_mask,
                            context)


class SequenceMaskLastInference(SequenceMaskLast):
    """The inference form of :class:`SequenceMaskLast` (the same masks)."""


class ReplaceMaskedEmbeddings(Block):
    """Replace the embeddings at the positions to predict (the context's
    ``MASK_KEY``) by a learned [MASK] vector of the input width ``dim``,
    drawn as the JAX package draws it (a normal truncated at 2 sigma, sigma
    0.05; seed 11). Placed after the input block, before the transformer; it
    replaces wherever a mask is present, in evaluation too."""

    def __init__(self, dim: int, seed: int = 11, device=None):
        super().__init__()
        emb = torch.empty(dim, device=device)
        nn.init.trunc_normal_(emb, std=0.05, a=-0.1, b=0.1,
                              generator=torch.Generator(emb.device).manual_seed(seed))
        self.mask_embedding = nn.Parameter(emb)

    def forward(self, inputs, *, context=None, training=False, **kwargs):
        pred_mask = context.get(MASK_KEY) if context is not None else None
        if pred_mask is None:
            return inputs
        v = inputs.values if isinstance(inputs, SequenceFeature) else inputs
        replaced = torch.where(pred_mask[..., None], self.mask_embedding[None, None, :], v)
        if isinstance(inputs, SequenceFeature):
            return SequenceFeature(replaced, inputs.mask)
        return replaced


class ExtractMaskFromTargets(Block):
    """Stash the prediction mask of a :class:`SequenceFeature` target in the
    context, so that an evaluation needs no masking transform."""

    def forward(self, inputs, *, targets=None, context=None, **kwargs):
        if context is not None:
            from ..core.types import prediction_mask_from_targets

            m = prediction_mask_from_targets(targets)
            if m is not None:
                context[MASK_KEY] = m
        return inputs
