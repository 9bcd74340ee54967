"""ContrastiveOutput: the sampled-softmax training head of the two-tower model
(``models_tpu/outputs/contrastive.py``), with in-batch negatives.

- positive score: the row-wise dot of query and positive candidate;
- negative scores: ``query @ negatives.T``;
- logQ correction ``score -= log(sampling_prob + eps)`` where a sampler
  knows its probabilities (the positive's too);
- false negatives (negative id == positive id) scored ``MIN_FLOAT``;
- temperature: every logit divided by T.

Three branches. Training with ``need_logits`` False (no metric reads the
logits) takes the fused loss, :func:`~models_tpu_torch.ops.contrastive.sampled_softmax_loss`,
which never holds the (B, 1+N) logits. Otherwise the head returns those
logits with a one-hot target on column 0, for the model's loss. Without
targets it scores each row's own pair (inference). Weight tying with an
embedding table and post blocks are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from ..core.constants import LOGQ_EPS, MIN_FLOAT
from ..core.types import Prediction
from ..data.loader import ROW_VALID_KEY
from ..ops.contrastive import sampled_softmax_loss
from ..schema import ColumnSchema, Schema
from .base import ModelOutput
from .sampling import Candidate, CandidateSampler


class ContrastiveOutput(ModelOutput):
    default_loss = "categorical_crossentropy"

    def __init__(
        self,
        to_call: Union[ColumnSchema, Schema, None] = None,
        negative_samplers: Union[str, CandidateSampler, Sequence, None] = "in-batch",
        target: Optional[str] = None,
        downscore_false_negatives: bool = True,
        logq_sampling_correction: bool = True,
        logits_temperature: float = 1.0,
        fused_loss: Union[str, bool] = "auto",
        post=None,
    ):
        if isinstance(to_call, ColumnSchema):
            target = target or to_call.name
        elif isinstance(to_call, Schema):
            target = target or to_call.item_id_column.name
        elif to_call is not None:
            raise NotImplementedError(
                "weight tying (an EmbeddingTable as the head) is not ported yet "
                "(ROADMAP.md queue 1)")
        super().__init__(target=target, post=post, logits_temperature=logits_temperature)
        if isinstance(negative_samplers, (str, CandidateSampler)):
            negative_samplers = [negative_samplers]
        self.samplers = nn.ModuleList(CandidateSampler.parse(s) for s in negative_samplers or [])
        if not len(self.samplers):
            raise ValueError("ContrastiveOutput needs at least one negative sampler")
        if len(self.samplers) > 1:
            raise NotImplementedError("several negative samplers are not ported yet "
                                      "(ROADMAP.md queue 1)")
        self.downscore_false_negatives = downscore_false_negatives
        self.logq_sampling_correction = logq_sampling_correction
        # "auto" or True: the fused loss on training steps that need no logits
        self.fused_loss = fused_loss

    @property
    def item_id_name(self) -> Optional[str]:
        return self.target

    def _query_and_positive(self, inputs, context, targets):
        """(query (Q, D), the positive Candidate): ids from the targets when
        they hold the item id, else from the batch's features."""
        if not isinstance(inputs, dict):
            raise NotImplementedError(
                "ContrastiveOutput takes {'query', 'candidate'} inputs; weight tying "
                "is not ported yet (ROADMAP.md queue 1)")
        features = context.features if context is not None else {}
        if isinstance(targets, dict) and self.item_id_name in targets:
            pos_id = targets[self.item_id_name]
        elif targets is not None and not isinstance(targets, dict):
            pos_id = targets
        else:
            pos_id = features.get(self.item_id_name)
        row_valid = features.get(ROW_VALID_KEY)
        if row_valid is not None:
            row_valid = row_valid.to(torch.bool)
        return inputs["query"], Candidate(
            id=pos_id, embedding=inputs.get("candidate"), valid=row_valid)

    def contrastive_logits(self, query, positive: Candidate, negatives: Candidate):
        """(B, 1+N) logits before the temperature: [positive | negatives]."""
        pos_score = (query * positive.embedding).sum(dim=1, keepdim=True)
        if self.logq_sampling_correction and positive.sampling_prob is not None:
            pos_score = pos_score - torch.log(positive.sampling_prob + LOGQ_EPS)[:, None]
        neg_scores = query @ negatives.embedding.T
        if self.logq_sampling_correction and negatives.sampling_prob is not None:
            neg_scores = neg_scores - torch.log(negatives.sampling_prob + LOGQ_EPS)[None, :]
        if self.downscore_false_negatives and positive.id is not None \
                and negatives.id is not None:
            false_neg = negatives.id[None, :] == positive.id[:, None]
            neg_scores = torch.where(false_neg, MIN_FLOAT, neg_scores)
        if negatives.valid is not None:
            # padded tail-batch rows must not act as negatives
            neg_scores = torch.where(negatives.valid[None, :], neg_scores, MIN_FLOAT)
        return torch.cat([pos_score, neg_scores], dim=1)

    def _fused(self, query, positive: Candidate, negatives: Candidate) -> Prediction:
        # row validity becomes the rows' weights
        w = None if positive.valid is None else positive.valid.to(torch.float32)
        neg_bias = None
        neg_emb = negatives.embedding
        if self.logq_sampling_correction and negatives.sampling_prob is not None:
            neg_bias = -torch.log(negatives.sampling_prob + LOGQ_EPS)
        if negatives.valid is not None:
            # replace, as the unfused branch does, not add: zero the invalid
            # rows' embeddings (their dot is exactly 0) AND pin their bias to
            # MIN_FLOAT, so that their logit is MIN_FLOAT / T
            neg_emb = torch.where(negatives.valid[:, None], neg_emb, 0.0)
            neg_bias = torch.where(negatives.valid, 0.0 if neg_bias is None else neg_bias,
                                   MIN_FLOAT)
        pos_bias = None
        if self.logq_sampling_correction and positive.sampling_prob is not None:
            pos_bias = -torch.log(positive.sampling_prob + LOGQ_EPS)
        downscore = self.downscore_false_negatives
        loss = sampled_softmax_loss(
            query, positive.embedding, neg_emb,
            positive.id if downscore else None, negatives.id if downscore else None,
            w, neg_bias,
            self.logits_scaler.temperature if self.logits_scaler is not None else 1.0,
            pos_bias=pos_bias,
        )
        return Prediction(outputs=loss, precomputed_loss=loss)

    def forward(self, inputs, *, training=False, context=None, targets=None, **kwargs):
        step = context.get("step") if context is not None else None
        if training or targets is not None:
            query, positive = self._query_and_positive(inputs, context, targets)
            if positive.id is not None:
                sampler = self.samplers[0]
                negatives = sampler(positive, training=training, step=step, context=context)
                need_logits = context.get("need_logits", True) if context is not None else True
                if (self.fused_loss in ("auto", True) and training and not need_logits
                        and negatives.embedding is not None
                        and positive.embedding is not None):
                    return self._fused(query, positive, negatives)
                logits = self.contrastive_logits(query, positive, negatives)
                if self.logits_scaler is not None:
                    logits = self.logits_scaler(logits)
                onehot = torch.zeros_like(logits)
                onehot[:, 0] = 1.0
                return Prediction(outputs=logits, targets=onehot,
                                  negative_candidate_ids=negatives.id)
        # inference: each row's own (query, candidate) score
        logits = (inputs["query"] * inputs["candidate"]).sum(dim=-1, keepdim=True)
        if self.logits_scaler is not None:
            logits = self.logits_scaler(logits)
        return Prediction(outputs=logits, targets=self.bind_target(targets))
