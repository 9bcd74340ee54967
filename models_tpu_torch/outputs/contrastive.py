"""ContrastiveOutput: the sampled-softmax training head
(``models_tpu/outputs/contrastive.py``), for the two-tower model (``{"query",
"candidate"}`` inputs) and with weight tying (an :class:`EmbeddingTable` as
``to_call``: the candidates are the table's rows, the query a tensor).

- positive score: the row-wise dot of query and positive candidate;
- negative scores: ``query @ negatives.T``;
- logQ correction ``score -= log(sampling_prob + eps)`` where a sampler
  knows its probabilities (the positive's too);
- false negatives (negative id == positive id) scored ``MIN_FLOAT``;
- temperature: every logit divided by T.

Sequence queries (B, L, D) flatten to (B*L, D): every position is a query,
weighted by the target's prediction mask (or the query's mask), and the
loader's row validity repeats over the L positions. A scalar target (the
predict-last protocol) takes the hidden state at each row's last valid
position instead. Padded positions inside a valid row stay in-batch
negatives, with their id (0 after the shift): the JAX package marks
validity per row (ROADMAP.md queue 3).

Three branches. Training with ``need_logits`` False (no metric reads the
logits) takes the fused loss, :func:`~models_tpu_torch.ops.contrastive.sampled_softmax_loss`,
which never holds the (Q, 1+N) logits, where its kernels hold the query's
width (:func:`~models_tpu_torch.ops.flash_ce.fits`: any width on the CPU, up
to 256 on the card; wider queries take the logits branch, as the JAX
package's ``_use_flash`` routes shapes outside its kernel). Otherwise (training steps that feed
metrics, and evaluation: targets given, or the engine's ``testing`` flag)
the head returns those logits with a one-hot target on column 0 and the
prediction mask as ``sample_weight``, for the model's loss and the top-k
metrics. Without either it scores each row's own pair (two-tower) or the
whole catalog (weight tying: (B[, L], catalog) logits). Under the
``mixed_bfloat16`` policy the first two cast their operands to bf16
(``cast_compute``, each operand on its own) and keep float32 scores; the
tying inference takes its product through ``cast_compute`` too, the
two-tower inference scores as it is given.

Several samplers: their candidates concatenate in the samplers' order (ids,
embeddings, ``sampling_prob`` only where every sampler gives one, ``valid``
with True for a sampler that gives none); only a head with one sampler
stamps the positive's ``sampling_prob``. A ``post`` block (the sample
weights of :class:`ContrastiveSampleWeight`, ``PopularityLogitsCorrection``)
works on the logits' Prediction, so a head with one never takes the fused
loss, nor does one built with ``fused_loss=False``, nor one whose compiled
loss is not the categorical cross-entropy that the fused loss computes: the
engine passes each head's compiled loss in the context (``head_losses``),
and a pairwise loss (``"bpr"``, ...) then takes the logits. (The JAX package
takes the fused CE whatever the compiled loss, ROADMAP.md queue 3; the port
does what it means.) On the row-sparse route a tied table records its
lookups as the JAX package taps them, the positives' under ``"pos"``, the
negatives' under ``"neg"``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from ..core.aggregation import sequence_last
from ..core.block import Block
from ..core.constants import LOGQ_EPS, MIN_FLOAT
from ..core.policy import cast_compute
from ..core.types import Prediction, SequenceFeature
from ..data.loader import ROW_VALID_KEY
from ..inputs.embedding import EmbeddingTable
from ..losses import categorical_crossentropy
from ..ops import flash_ce
from ..ops.contrastive import sampled_softmax_loss
from ..schema import ColumnSchema, Schema, Tags
from .base import EmbeddingTablePrediction, ModelOutput
from .sampling import Candidate, CandidateSampler, PopularityBasedSampler


class ContrastiveOutput(ModelOutput):
    default_loss = "categorical_crossentropy"

    def __init__(
        self,
        to_call: Union[ColumnSchema, Schema, EmbeddingTable, None] = None,
        negative_samplers: Union[str, CandidateSampler, Sequence, None] = "in-batch",
        target: Optional[str] = None,
        downscore_false_negatives: bool = True,
        logq_sampling_correction: bool = True,
        logits_temperature: float = 1.0,
        default_metrics_top_ks: Sequence[int] = (10,),
        query_name: str = "query",
        candidate_name: str = "candidate",
        fused_loss: Union[str, bool] = "auto",
        post=None,
    ):
        table = None
        if isinstance(to_call, ColumnSchema):
            col_schema = to_call
        elif isinstance(to_call, Schema):
            col_schema = to_call.item_id_column
        elif isinstance(to_call, EmbeddingTable):
            table, col_schema = to_call, to_call.schema.first
        elif to_call is None:
            col_schema = None
        else:
            raise TypeError(f"ContrastiveOutput takes a column, a schema or an EmbeddingTable, "
                            f"not {type(to_call).__name__}")
        if col_schema is not None:
            target = target or col_schema.name
        super().__init__(target=target, logits_temperature=logits_temperature, post=post)
        self.query_name, self.candidate_name = query_name, candidate_name
        # the JAX package's attribute: a tied model's item table is named
        # ``.../table/table`` by its first registration, here
        self.table = table
        if isinstance(negative_samplers, (str, CandidateSampler)):
            negative_samplers = [negative_samplers]
        self.samplers = nn.ModuleList(CandidateSampler.parse(s) for s in negative_samplers or [])
        if not len(self.samplers):
            raise ValueError("ContrastiveOutput needs at least one negative sampler")
        # a catalog sampler takes the item domain from the head's column
        if col_schema is not None and col_schema.cardinality:
            for s in self.samplers:
                if isinstance(s, PopularityBasedSampler) and s.max_id is None:
                    s.max_id = int(col_schema.cardinality) - 1
        self.downscore_false_negatives = downscore_false_negatives
        self.logq_sampling_correction = logq_sampling_correction
        # "auto" or True: the fused loss on training steps that need no
        # logits, where the compiled loss is the categorical CE; False never
        self.fused_loss = fused_loss
        self.top_ks = tuple(default_metrics_top_ks)
        self.tying = None
        if table is not None:
            self.tying = EmbeddingTablePrediction(table)
            self.samplers.to(table.table.device)  # a catalog sampler draws beside the table

    def default_metrics(self):
        from ..metrics.topk import TopKMetricsAggregator

        return [TopKMetricsAggregator.default(k) for k in self.top_ks]

    @property
    def item_id_name(self) -> Optional[str]:
        return self.target

    def _resolve_positive_ids(self, context, targets):
        """(positive ids, prediction weights or None): from the targets where
        they hold the item id, else from the batch's features; a sequence
        target gives its values and its mask as the weights."""
        if isinstance(targets, dict) and self.item_id_name in targets:
            source = targets[self.item_id_name]
        elif targets is not None and not isinstance(targets, dict):
            source = targets
        else:
            source = (context.features if context is not None else {}).get(self.item_id_name)
        if isinstance(source, SequenceFeature):
            return source.values, source.mask.to(torch.float32)
        return source, None

    def _query_and_positive(self, inputs, context, targets):
        """(query (Q, D), the positive Candidate, weights (Q,) or None)."""
        pos_id, weights = self._resolve_positive_ids(context, targets)
        row_valid = (context.features if context is not None else {}).get(ROW_VALID_KEY)
        if row_valid is not None:
            row_valid = row_valid.to(torch.bool)
        if isinstance(inputs, dict):
            return inputs[self.query_name], Candidate(
                id=pos_id, embedding=inputs.get(self.candidate_name), valid=row_valid), weights
        if self.tying is None:
            raise ValueError("ContrastiveOutput with tensor input requires an EmbeddingTable "
                             "(weight tying) or dict {'query', 'candidate'} inputs")
        query, qmask = inputs, None
        if isinstance(query, SequenceFeature):
            query, qmask = query.values, query.mask
        if query.ndim == 3:
            B, L, D = query.shape
            if pos_id is not None and pos_id.ndim == 1:
                # a scalar target: the hidden state at the last valid position
                m = qmask if qmask is not None else torch.ones(
                    B, L, dtype=torch.bool, device=query.device)
                query = sequence_last(SequenceFeature(query, m))
            else:
                query = query.reshape(B * L, D)
                if pos_id is not None and pos_id.ndim == 2:
                    pos_id = pos_id.reshape(B * L)
                if weights is not None:
                    weights = weights.reshape(B * L)
                elif qmask is not None:
                    weights = qmask.to(torch.float32).reshape(B * L)
        if pos_id is None:
            raise ValueError(f"ContrastiveOutput needs feature/target {self.item_id_name!r} "
                             "to identify positives")
        emb = self.tying.embedding_lookup(pos_id, "pos", context)
        if row_valid is not None and pos_id.shape[0] != row_valid.shape[0] \
                and pos_id.shape[0] % row_valid.shape[0] == 0:
            row_valid = row_valid.repeat_interleave(pos_id.shape[0] // row_valid.shape[0])
        return query, Candidate(id=pos_id, embedding=emb, valid=row_valid), weights

    def _sample_negatives(self, positive: Candidate, training, step, context) -> Candidate:
        negs = []
        for sampler in self.samplers:
            c = sampler(positive, training=training, step=step, context=context)
            if c.embedding is None:
                if self.tying is None:
                    raise ValueError(f"Sampler {type(sampler).__name__} returned ids only; "
                                     "embedding lookup requires weight tying")
                c = c._replace(embedding=self.tying.embedding_lookup(c.id, "neg", context))
            negs.append(c)
        if len(negs) == 1:
            return negs[0]
        probs = None
        if all(c.sampling_prob is not None for c in negs):
            probs = torch.cat([c.sampling_prob for c in negs])
        valid = None
        if any(c.valid is not None for c in negs):
            valid = torch.cat([c.valid if c.valid is not None else torch.ones(
                c.id.shape[0], dtype=torch.bool, device=c.id.device) for c in negs])
        return Candidate(id=torch.cat([c.id.to(torch.int32) for c in negs]),
                         embedding=torch.cat([c.embedding for c in negs]),
                         sampling_prob=probs, valid=valid)

    def _fused_route(self, training, query, positive: Candidate, negatives: Candidate,
                     context) -> bool:
        """Whether this step takes the fused loss: a training step whose
        logits nothing reads, a head without ``post`` and not built with
        ``fused_loss=False``, whose compiled loss is the categorical CE,
        with operands the kernels hold."""
        if not (training and self.fused_loss in ("auto", True) and self.post is None):
            return False
        if context is None or context.get("need_logits", True):
            return False
        loss = (context.get("head_losses") or {}).get(self.block_name, categorical_crossentropy)
        return (loss is categorical_crossentropy and negatives.embedding is not None
                and positive.embedding is not None
                and flash_ce.fits(query.shape[-1], query.device))

    def contrastive_logits(self, query, positive: Candidate, negatives: Candidate):
        """(B, 1+N) float32 logits before the temperature: [positive |
        negatives], from the operands in the policy's compute dtype."""
        pos_score = (cast_compute(query).float() * cast_compute(positive.embedding).float()
                     ).sum(dim=1, keepdim=True)
        if self.logq_sampling_correction and positive.sampling_prob is not None:
            pos_score = pos_score - torch.log(positive.sampling_prob + LOGQ_EPS)[:, None]
        neg_scores = cast_compute(query).float() @ cast_compute(negatives.embedding).float().T
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

    def _fused(self, query, positive: Candidate, negatives: Candidate, weights) -> Prediction:
        # the rows' weights: the prediction mask times the row validity
        w = weights
        if positive.valid is not None:
            rv = positive.valid.to(torch.float32)
            w = rv if w is None else w * rv
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
        # each operand its own cast: under in-batch negatives positive and
        # negatives are one tensor, whose two bf16 cotangents then sum in fp32
        loss = sampled_softmax_loss(
            cast_compute(query), cast_compute(positive.embedding), cast_compute(neg_emb),
            positive.id if downscore else None, negatives.id if downscore else None,
            w, neg_bias,
            self.logits_scaler.temperature if self.logits_scaler is not None else 1.0,
            pos_bias=pos_bias,
        )
        return Prediction(outputs=loss, precomputed_loss=loss)

    def forward(self, inputs, *, training=False, context=None, targets=None, **kwargs):
        step = context.get("step") if context is not None else None
        testing = context is not None and context.get("testing", False)
        if training or targets is not None or testing:
            query, positive, weights = self._query_and_positive(inputs, context, targets)
            if positive.id is not None:
                negatives = self._sample_negatives(positive, training, step, context)
                sampler = self.samplers[0]
                if self.logq_sampling_correction and len(self.samplers) == 1 \
                        and positive.sampling_prob is None \
                        and getattr(sampler, "max_id", None) is not None:
                    # a sampler that knows its distribution stamps the
                    # positive's probability too
                    positive = positive._replace(
                        sampling_prob=sampler.sampling_probs(positive.id, sampler.max_id))
                if self._fused_route(training, query, positive, negatives, context):
                    return self._fused(query, positive, negatives, weights)
                logits = self.contrastive_logits(query, positive, negatives)
                if self.logits_scaler is not None:
                    logits = self.logits_scaler(logits)
                onehot = torch.zeros_like(logits)
                onehot[:, 0] = 1.0
                pred = Prediction(outputs=logits, targets=onehot, sample_weight=weights,
                                  negative_candidate_ids=negatives.id)
                if self.post is not None:
                    pred = self.post(pred, training=training, context=context, targets=targets)
                return pred
        if isinstance(inputs, dict):
            # inference: each row's own (query, candidate) score
            logits = (inputs[self.query_name] * inputs[self.candidate_name]).sum(dim=-1,
                                                                                 keepdim=True)
        else:
            # weight tying: the whole catalog, (B[, L], catalog)
            logits = self.tying(inputs)
        if self.logits_scaler is not None:
            logits = self.logits_scaler(logits)
        return Prediction(outputs=logits, targets=self.bind_target(targets))

    def to_dataset(self):
        """The tied table's rows as a Dataset of ``id`` and ``embedding``."""
        if self.tying is None:
            raise ValueError("No tied embedding table to export")
        return self.tying.table.to_dataset()


class ContrastiveSampleWeight(Block):
    """A contrastive head's ``post``: per-candidate sample weights, a (B,
    1+N) matrix over the [positive | negatives] logits, times the row
    weights the head already gave (a sequence's prediction mask).

    - ``pos_class_weight``: a column's name (each interaction's weight from
      that feature), an array (num_candidates,) gathered by the positive's
      id (needs ``schema`` with a ``candidate_tag_id`` column), or a number;
    - ``neg_class_weight``: an array gathered by the negatives' ids, or a
      number.

    The losses adapt the matrix to their shape (``losses._weighted_mean``);
    the metrics take its positive column."""

    def __init__(self, pos_class_weight, neg_class_weight=1.0, schema: Optional[Schema] = None,
                 candidate_tag_id: Tags = Tags.ITEM_ID, device=None):
        super().__init__()
        self.candidate_id_name = None
        if schema is not None:
            sel = schema.select_by_tag(candidate_tag_id)
            if len(sel):
                self.candidate_id_name = sel.first.name
        self.pos_class_weight = None
        self.neg_class_weight = None
        if isinstance(pos_class_weight, (str, int, float)):
            self.pos_class_weight = pos_class_weight
            self.register_buffer("pos_table", None)
        else:
            if self.candidate_id_name is None:
                raise ValueError("per-candidate pos_class_weight needs schema= with a "
                                 f"{candidate_tag_id}-tagged candidate-id column")
            self.register_buffer("pos_table", torch.as_tensor(
                np.asarray(pos_class_weight, np.float32), device=device))
        if isinstance(neg_class_weight, (int, float)):
            self.neg_class_weight = float(neg_class_weight)
            self.register_buffer("neg_table", None)
        else:
            self.register_buffer("neg_table", torch.as_tensor(
                np.asarray(neg_class_weight, np.float32), device=device))

    def _positive_ids(self, context, targets):
        ids = context.features.get(self.candidate_id_name) if context is not None else None
        if ids is None and isinstance(targets, dict):
            ids = targets.get(self.candidate_id_name)
        if ids is None:
            raise ValueError(f"candidate-id column {self.candidate_id_name!r} not found in the "
                             "features or targets (the per-candidate positive weights)")
        return ids

    def forward(self, inputs, *, context=None, targets=None, **kwargs):
        if not isinstance(inputs, Prediction) or inputs.outputs is None:
            return inputs
        logits = inputs.outputs
        if logits.ndim != 2 or logits.shape[1] < 2:
            return inputs  # not a [positive | negatives] layout
        batch, n_negs = logits.shape[0], logits.shape[1] - 1
        f32 = dict(dtype=torch.float32, device=logits.device)
        if self.pos_table is not None:
            ids = self._positive_ids(context, targets).reshape(-1).long()
            pos = self.pos_table[ids].reshape(-1, 1)
        elif isinstance(self.pos_class_weight, str):
            col = context.features.get(self.pos_class_weight) if context is not None else None
            if col is None:
                raise ValueError("The model's inputs don't contain the positive weight "
                                 f"feature {self.pos_class_weight!r}.")
            pos = col.to(torch.float32).reshape(-1, 1)
        else:
            pos = torch.full((batch, 1), float(self.pos_class_weight), **f32)
        if self.neg_table is not None:
            neg_ids = inputs.negative_candidate_ids
            if neg_ids is None:
                raise ValueError("per-candidate neg_class_weight needs the head to emit "
                                 "negative_candidate_ids")
            nw = self.neg_table[neg_ids.reshape(-1).long()].reshape(neg_ids.shape)
            # in-batch negatives are every row's: (N,) -> (B, N)
            neg = nw.reshape(1, -1).expand(batch, n_negs) if nw.ndim == 1 else nw
        else:
            neg = torch.full((batch, n_negs), self.neg_class_weight, **f32)
        w = torch.cat([pos, neg], dim=1)
        prev = inputs.sample_weight
        if prev is not None:
            prev = prev.to(torch.float32).reshape(prev.shape[0], -1)
            w = w * (prev[:, :1] if prev.shape[1] == 1 else prev)
        return inputs._replace(sample_weight=w)
