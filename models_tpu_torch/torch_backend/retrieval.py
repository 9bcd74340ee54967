"""Torch-backend retrieval (``models_tpu/torch_backend/retrieval.py``):
contrastive training + brute-force top-k serving.

The second backend's retrieval contract, mirroring the reference torch stack:

- ``ContrastiveOutput`` — sampled-softmax head over {query, candidate} tower
  outputs: in-batch and/or popularity (log-uniform) negatives, logQ sampling-
  probability correction, false-negative downscoring to ``MIN_FLOAT``
  (reference ``merlin/models/torch/outputs/contrastive.py:37-476``).
- ``InBatchNegativeSampler`` / ``PopularityBasedSampler`` + ``LogUniformSampler``
  (reference ``torch/outputs/sampling/in_batch.py``,
  ``torch/outputs/sampling/popularity.py:9-254`` — the zipfian
  ``P(id) = (log(id+2) - log(id+1)) / log(max_id+1)`` distribution with the
  expected-count correction for sampling WITH replacement).
- ``BruteForceIndex`` — candidate matrix + ids, the exact top-k of ``q @
  C.T`` (semantics of the TF ``BruteForce`` layer, ``tf/outputs/topk.py:
  129-240``) through the port's :func:`~models_tpu_torch.ops.topk.
  topk_scores`: on the card its binned route's phase B is K5 and its
  streaming route K6; ties go to the lowest index.
- ``TwoTowerModel`` — schema-split user/item towers ending in the contrastive
  head, with ``query_embeddings``/``candidate_embeddings`` export,
  ``to_top_k_recommender`` and ``evaluate_retrieval`` (recall/ndcg/mrr @k)
  (reference ``tf/models/retrieval.py:409`` restated for torch).

Everything runs on the port's schema-driven ``Dataset``/``Loader``, on the
device the model's constructor resolves (``device=``, default the card).
Random draws take an explicit ``torch.Generator`` where given (else the
global one, as the JAX package's copy draws).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence as Seq, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..core.constants import MIN_FLOAT
from ..core.device import check_module_device, resolve_device
from ..data.dataset import Dataset
from ..ops.topk import topk_scores
from ..schema import ColumnSchema, Schema, Tags, infer_embedding_dim
from .dsl import (
    Batch,
    Block,
    MLPBlock,
    Model,
    ModelOutput,
    ParallelBlock,
    TabularInputBlock,
)


# ---------------------------------------------------------------------------
# negative samplers
# ---------------------------------------------------------------------------

class InBatchNegativeSampler(nn.Module):
    """The other rows of the batch are the negatives (reference
    ``torch/outputs/sampling/in_batch.py``). Free (embeddings already
    computed) and popularity-weighted by construction."""

    def forward(
        self, query: torch.Tensor, pos_emb: torch.Tensor, pos_id: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        # log-expected-count of an item appearing in the batch is a constant
        # shift under in-batch sampling (every sampled id appears exactly
        # once), so no logQ term (the reference applies none here either)
        return pos_emb, pos_id, None


class LogUniformSampler(nn.Module):
    """Zipfian (log-uniform) id sampler with analytic probabilities
    (reference ``torch/outputs/sampling/popularity.py:9-174``):

    ``P(id) = (log(id+2) - log(id+1)) / log(max_id + 1)`` — assumes item ids
    are frequency-ranked (most popular = smallest id). ``expected_count(id)``
    is the expected number of occurrences in ``n_sample`` draws with
    replacement, ``1 - (1 - P)^n`` — the logQ correction numerator. The
    draws take ``generator`` (on the buffers' device) where given."""

    def __init__(self, max_id: int, n_sample: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.max_id = int(max_id)
        self.n_sample = int(n_sample)
        self.generator = generator
        ids = torch.arange(self.max_id, dtype=torch.float64)
        probs = ((ids + 2).log() - (ids + 1).log()) / math.log(self.max_id + 1)
        self.register_buffer("probs", probs.float(), persistent=False)
        self.register_buffer(
            "expected", (1.0 - (1.0 - probs) ** self.n_sample).float(), persistent=False
        )

    def sample(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Draw ids by inverse CDF: ``floor(exp(u * log(max_id+1))) - 1`` is
        exactly log-uniform (the classic candidate-sampling trick)."""
        u = torch.rand(self.n_sample, generator=self.generator, device=self.probs.device)
        ids = (torch.exp(u * math.log(self.max_id + 1.0)) - 1.0).long()
        ids = ids.clamp(0, self.max_id - 1)
        return ids, self.expected[ids]


class PopularityBasedSampler(nn.Module):
    """Draw ``n_samples`` zipfian negatives per batch; embeddings come from the
    tied candidate id table (reference ``PopularityBasedSampler:175-254`` —
    there, via ``EmbeddingTablePrediction`` weight tying)."""

    def __init__(self, max_id: int, n_samples: int = 100,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.sampler = LogUniformSampler(max_id, n_samples, generator=generator)
        self.lookup: Optional[nn.Module] = None  # bound by ContrastiveOutput

    def forward(
        self, query: torch.Tensor, pos_emb: torch.Tensor, pos_id: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        if self.lookup is None:
            raise RuntimeError(
                "PopularityBasedSampler needs an id->embedding lookup: pass "
                "item_embeddings= to ContrastiveOutput (weight tying)"
            )
        ids, expected = self.sampler.sample()
        return self.lookup(ids), ids, torch.log(expected.clamp_min(1e-20))


# ---------------------------------------------------------------------------
# contrastive head
# ---------------------------------------------------------------------------

class ContrastiveOutput(ModelOutput):
    """Sampled/contrastive softmax head over two-tower outputs.

    Training forward on ``{"query": q, "candidate": c}``:
    positive logit = rowwise ``q . c``; negatives from each sampler scored
    ``q @ N.T``; sampled negatives get the logQ correction
    ``logit -= log(expected_count)``; negatives whose id equals the row's
    positive id are downscored to ``MIN_FLOAT`` (false negatives); the
    CE target is column 0 (reference ``contrastive.py:293-358``).

    Eval forward returns the positive logit only — retrieval metrics go
    through :class:`BruteForceIndex` / ``evaluate_retrieval``.
    """

    def __init__(
        self,
        item_col: Union[str, ColumnSchema],
        negative_sampling: Union[str, nn.Module, Seq] = "in-batch",
        n_samples: int = 100,
        max_id: Optional[int] = None,
        item_embeddings: Optional[nn.Module] = None,
        downscore_false_negatives: bool = True,
        false_negative_score: float = MIN_FLOAT,
        logits_temperature: float = 1.0,
        generator: Optional[torch.Generator] = None,
    ):
        name = item_col if isinstance(item_col, str) else item_col.name
        if max_id is None and isinstance(item_col, ColumnSchema):
            max_id = item_col.cardinality
        super().__init__(target=name, loss=nn.CrossEntropyLoss())
        if isinstance(negative_sampling, (str, nn.Module)):
            negative_sampling = [negative_sampling]
        samplers: List[nn.Module] = []
        for s in negative_sampling:
            if isinstance(s, nn.Module):
                samplers.append(s)
            elif s == "in-batch":
                samplers.append(InBatchNegativeSampler())
            elif s in ("popularity", "log-uniform"):
                if max_id is None:
                    raise ValueError("popularity sampling needs max_id or a ColumnSchema")
                samplers.append(PopularityBasedSampler(max_id, n_samples, generator=generator))
            else:
                raise ValueError(f"unknown negative_sampling {s!r}")
        self.samplers = nn.ModuleList(samplers)
        for s in self.samplers:
            if isinstance(s, PopularityBasedSampler):
                if item_embeddings is None:
                    raise ValueError(
                        "popularity sampling requires item_embeddings= (an "
                        "id->embedding module — weight tying with the "
                        "candidate tower's id table)"
                    )
                s.lookup = item_embeddings
        self.downscore_false_negatives = downscore_false_negatives
        self.false_negative_score = false_negative_score
        self.logits_temperature = logits_temperature

    def forward(self, inputs, batch: Optional[Batch] = None):
        if not isinstance(inputs, dict) or "query" not in inputs or "candidate" not in inputs:
            raise ValueError(
                "ContrastiveOutput expects {'query': ..., 'candidate': ...} "
                "tower outputs (reference DotProduct contract)"
            )
        q, c = inputs["query"], inputs["candidate"]
        pos_logit = (q * c).sum(-1, keepdim=True)  # (B, 1)
        if not self.training:
            return pos_logit / self.logits_temperature
        if batch is None or self.target not in batch.features:
            raise ValueError(
                f"contrastive training needs the item-id feature "
                f"{self.target!r} in the batch"
            )
        pos_id = batch.features[self.target].long().reshape(-1)
        neg_logits: List[torch.Tensor] = []
        for sampler in self.samplers:
            n_emb, n_id, log_q = sampler(q, c, pos_id)
            scores = q @ n_emb.T  # (B, N)
            if log_q is not None:
                # logQ correction: subtract log-expected-count so popular
                # (over-sampled) items aren't over-penalized as negatives
                scores = scores - log_q[None, :]
            if self.downscore_false_negatives:
                fn = n_id[None, :] == pos_id[:, None]
                scores = torch.where(
                    fn, torch.full_like(scores, self.false_negative_score), scores
                )
            neg_logits.append(scores)
        logits = torch.cat([pos_logit] + neg_logits, dim=1)
        return logits / self.logits_temperature

    def compute_loss(self, out: torch.Tensor, batch: Batch) -> torch.Tensor:
        # CE against column 0 — [pos | negatives] ordering
        return self.loss(out, torch.zeros(out.shape[0], dtype=torch.long, device=out.device))

    def output_activation(self, t: torch.Tensor) -> torch.Tensor:
        return t


# ---------------------------------------------------------------------------
# brute-force top-k index
# ---------------------------------------------------------------------------

class BruteForceIndex(nn.Module):
    """Candidate matrix + ids on ``device`` (default the card);
    ``forward(q)`` = exact top-k by dot product (reference
    ``tf/outputs/topk.py:129-240`` semantics: unique-id check at index time,
    scores then ids returned), through :func:`~models_tpu_torch.ops.topk.
    topk_scores` (direct for at most 4096 candidates; else binned, phase B
    on K5 where the pool fits; else K6 on the card). Tied scores go to the
    lowest index (``torch.topk`` promises no order)."""

    def __init__(self, k: int = 10, device=None):
        super().__init__()
        self.k = k
        dev = resolve_device(device)
        self.register_buffer("candidates", torch.zeros(0, 0, device=dev), persistent=False)
        self.register_buffer("ids", torch.zeros(0, dtype=torch.long, device=dev),
                             persistent=False)

    def index(self, ids, embeddings) -> "BruteForceIndex":
        dev = self.candidates.device
        ids = torch.as_tensor(np.array(ids, copy=True), device=dev).long().reshape(-1)
        embeddings = torch.as_tensor(np.array(embeddings, copy=True), device=dev).float()
        if ids.unique().numel() != ids.numel():
            raise ValueError("candidate ids must be unique (reference _check_unique_ids)")
        self.candidates = embeddings.contiguous()
        self.ids = ids
        return self

    def forward(self, query: torch.Tensor, k: Optional[int] = None):
        if self.candidates.numel() == 0:
            raise RuntimeError("index() must be called before querying")
        k = min(k or self.k, self.candidates.shape[0])
        top_scores, top_ids = topk_scores(query.float().contiguous(), self.candidates, k,
                                          ids=self.ids, device=self.candidates.device)
        return top_scores, top_ids.long()


# ---------------------------------------------------------------------------
# two-tower retrieval model
# ---------------------------------------------------------------------------

class RetrievalModel(Model):
    """Two-tower Model with encoder export + top-k evaluation conveniences."""

    def __init__(self, towers: ParallelBlock, output: ContrastiveOutput,
                 schema: Schema, item_id: str, device=None):
        super().__init__(towers, output, schema=schema, device=device)
        self.item_id = item_id

    # -- encoders --------------------------------------------------------
    def _tower(self, name: str) -> nn.Module:
        return self.blocks[0].branches[name]

    def _encode(self, tower: nn.Module, data, batch_size: int = 1024,
                device=None) -> np.ndarray:
        from ..data.loader import ROW_VALID_KEY, Loader

        dev = check_module_device(self, device)
        loader = Loader(data, batch_size) if isinstance(data, Dataset) else data
        self.eval()
        chunks = []
        with torch.no_grad():
            for x, _ in loader:
                batch = Batch.from_loader_batch(x, device=dev)
                valid = np.asarray(x[ROW_VALID_KEY]) if ROW_VALID_KEY in x else None
                emb = tower(batch.features, batch=batch).cpu().numpy()
                chunks.append(emb[valid] if valid is not None else emb)
        return np.concatenate(chunks, axis=0)

    def query_embeddings(self, data, batch_size: int = 1024, device=None) -> np.ndarray:
        """(reference ``RetrievalModelV2.query_embeddings``)."""
        return self._encode(self._tower("query"), data, batch_size, device)

    def candidate_embeddings(self, data, batch_size: int = 1024, device=None) -> np.ndarray:
        """(reference ``RetrievalModelV2.candidate_embeddings``)."""
        return self._encode(self._tower("candidate"), data, batch_size, device)

    # -- serving ---------------------------------------------------------
    def to_top_k_recommender(self, candidate_data, k: int = 10,
                             batch_size: int = 1024, device=None) -> "TopKRecommender":
        """Encode the (unique-item) candidate dataset through the item tower
        and attach a brute-force index (reference ``to_top_k_encoder``)."""
        dev = check_module_device(self, device)
        cands = candidate_data.unique_by(self.item_id) \
            if hasattr(candidate_data, "unique_by") else candidate_data
        emb = self.candidate_embeddings(cands, batch_size, device=dev)
        ids = np.asarray(cands.table()[self.item_id])
        index = BruteForceIndex(k, device=dev).index(ids, emb)
        return TopKRecommender(self._tower("query"), index, self.item_id)

    def evaluate_retrieval(self, data, candidate_data=None, k: int = 10,
                           batch_size: int = 1024, device=None) -> Dict[str, float]:
        """Full-corpus recall/mrr/ndcg@k: encode queries, score against the
        indexed catalog, check the row's true item id (reference
        ``RetrievalModel.evaluate(item_corpus=...)`` flow)."""
        dev = check_module_device(self, device)
        rec = self.to_top_k_recommender(candidate_data if candidate_data is not None
                                        else data, k=k, batch_size=batch_size, device=dev)
        from ..data.loader import ROW_VALID_KEY, Loader

        loader = Loader(data, batch_size) if isinstance(data, Dataset) else data
        hits, rr, dcg, n = 0.0, 0.0, 0.0, 0
        self.eval()
        with torch.no_grad():
            for x, _ in loader:
                batch = Batch.from_loader_batch(x, device=dev)
                valid = np.asarray(x[ROW_VALID_KEY]) if ROW_VALID_KEY in x else None
                _, top_ids = rec(batch.features, batch=batch)
                true_id = batch.features[self.item_id].long().reshape(-1, 1)
                hit = (top_ids == true_id).float()  # (B, k)
                if valid is not None:
                    hit = hit[torch.as_tensor(valid, device=dev)]
                ranks = torch.arange(1, hit.shape[1] + 1, dtype=torch.float32, device=dev)
                hits += float(hit.sum())
                rr += float((hit / ranks).max(dim=1).values.sum())
                dcg += float((hit / torch.log2(ranks + 1.0)).sum())
                n += hit.shape[0]
        n = max(n, 1)
        return {f"recall_at_{k}": hits / n, f"mrr_at_{k}": rr / n,
                f"ndcg_at_{k}": dcg / n}


class TopKRecommender(nn.Module):
    """query features → query tower → brute-force top-k (scores, ids)."""

    def __init__(self, query_tower: nn.Module, index: BruteForceIndex, item_id: str):
        super().__init__()
        self.query_tower = query_tower
        self.index = index
        self.item_id = item_id

    def forward(self, features: Dict[str, torch.Tensor],
                batch: Optional[Batch] = None, k: Optional[int] = None):
        if batch is None:
            batch = Batch.from_loader_batch(features, device=self.index.candidates.device)
            features = batch.features
        q = self.query_tower(features, batch=batch)
        return self.index(q, k=k)


def TwoTowerModel(
    schema: Schema,
    dim: int = 32,
    query_block: Optional[Seq[int]] = (64,),
    candidate_block: Optional[Seq[int]] = None,
    embedding_dim: Optional[int] = None,
    negative_sampling: Union[str, Seq] = "in-batch",
    n_samples: int = 100,
    logits_temperature: float = 1.0,
    device=None,
    generator: Optional[torch.Generator] = None,
) -> RetrievalModel:
    """Schema-split user/item towers + contrastive head for the torch backend
    (reference ``torch`` two-tower usage of ``ContrastiveOutput``; TF twin
    ``tf/models/retrieval.py:409``). ``dim`` is the shared tower output width.
    The model lives on ``device`` (default the card); ``generator`` draws the
    popularity negatives.
    """
    dev = resolve_device(device)
    user_schema = schema.select_by_tag(Tags.USER).excluding_by_tag(Tags.TARGET)
    item_schema = schema.select_by_tag(Tags.ITEM).excluding_by_tag(Tags.TARGET)
    if not len(user_schema) or not len(item_schema):
        raise ValueError("TwoTowerModel needs USER- and ITEM-tagged columns")
    item_col = schema.item_id_column

    def tower(tower_schema: Schema, dims: Optional[Seq[int]]) -> Block:
        inp = TabularInputBlock(tower_schema, dim=embedding_dim)
        mlp = MLPBlock(tuple(dims or (64,)), in_dim=inp.out_dim)
        # linear projection to the shared space: no activation on the tower
        # output (a ReLU there would confine embeddings to one orthant and
        # cap cosine separability)
        return Block(inp, mlp, nn.Linear(mlp.out_dim, dim))

    query = tower(user_schema, query_block)
    candidate = tower(item_schema, candidate_block or query_block)

    item_embeddings = None
    needs_tying = "popularity" in ([negative_sampling] if isinstance(negative_sampling, str)
                                   else list(negative_sampling))
    if needs_tying:
        item_embeddings = _ItemIdEncoder(candidate, item_col, item_schema)

    output = ContrastiveOutput(
        item_col,
        negative_sampling=negative_sampling,
        n_samples=n_samples,
        item_embeddings=item_embeddings,
        logits_temperature=logits_temperature,
        generator=generator,
    )
    towers = ParallelBlock({"query": query, "candidate": candidate})
    return RetrievalModel(towers, output, schema=schema, item_id=item_col.name, device=dev)


class _ItemIdEncoder(nn.Module):
    """id → candidate-tower embedding for popularity negatives: runs the item
    tower on id-only features (non-id item features take their mode-0 value —
    the reference's weight-tying path ties to the id table alone; running the
    full tower keeps the space consistent with indexed candidates)."""

    def __init__(self, candidate_tower: nn.Module, item_col: ColumnSchema,
                 item_schema: Schema):
        super().__init__()
        self.tower = candidate_tower
        self.item_col = item_col
        self.extra_cols = [c for c in item_schema if c.name != item_col.name]

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        feats = {self.item_col.name: ids}
        for c in self.extra_cols:
            if c.is_list:
                continue
            if str(Tags.CONTINUOUS) in [str(t) for t in c.tags]:
                feats[c.name] = torch.zeros(ids.shape[0], device=ids.device)
            else:
                feats[c.name] = torch.zeros(ids.shape[0], dtype=torch.long, device=ids.device)
        return self.tower(feats, batch=Batch(features=feats))
