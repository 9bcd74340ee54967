"""Negative candidate samplers (``models_tpu/outputs/sampling.py``): the
in-batch sampler and the popularity (log-uniform) sampler; the cross-batch
queue is in ``outputs/queue.py``."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.block import Block, RandomBlock


class Candidate(NamedTuple):
    """Candidate ids, embeddings, analytic sampling probabilities (for the
    logQ correction) and ``valid``, which marks real rows: padded rows of a
    tail batch must not act as in-batch negatives."""

    id: Optional[torch.Tensor]  # (N,)
    embedding: Optional[torch.Tensor] = None  # (N, D)
    sampling_prob: Optional[torch.Tensor] = None  # (N,)
    metadata: Optional[dict] = None
    valid: Optional[torch.Tensor] = None  # (N,) bool


class CandidateSampler(Block):
    """``forward(positive: Candidate, ...) -> Candidate`` of negatives."""

    def forward(self, positive: Candidate, *, training: bool = False, step=None, **kwargs):
        raise NotImplementedError

    @staticmethod
    def parse(s) -> "CandidateSampler":
        if isinstance(s, CandidateSampler):
            return s
        if s in ("in-batch", "inbatch"):
            return InBatchSampler()
        if s in ("popularity", "popularity-based"):
            return PopularityBasedSampler()
        if s in ("cross-batch", "cached-cross-batch"):
            from .queue import CachedCrossBatchSampler

            return CachedCrossBatchSampler()
        raise ValueError(f"Unknown negative sampler {s!r}")


def global_candidates(positive: Candidate, context) -> Candidate:
    """``positive`` over the global batch under a mesh step whose batch is
    split over the data axis (the context's ``mesh``): its ids, embeddings,
    sampling probabilities and validity all-gathered over the rank's data
    line, the embeddings' gradient reduce-scattered back
    (``parallel/collectives.py::GatherRows``); else ``positive`` itself."""
    mesh = context.get("mesh") if context is not None else None
    if mesh is None:
        return positive
    from ..parallel.collectives import all_gather, gather_rows
    from ..parallel.mesh import DATA_AXIS

    g = mesh.group(DATA_AXIS)
    if g.size == 1:
        return positive

    def rows(x):
        return None if x is None else all_gather(x.contiguous(), g)

    return Candidate(id=rows(positive.id),
                     embedding=None if positive.embedding is None
                     else gather_rows(positive.embedding, g),
                     sampling_prob=rows(positive.sampling_prob), metadata=positive.metadata,
                     valid=rows(positive.valid))


class InBatchSampler(CandidateSampler):
    """The batch's positive items are everyone's negatives: under a mesh
    whose data axis splits the batch, the global batch's
    (:func:`global_candidates`), as in the JAX package, whose negatives are
    the whole data-sharded batch."""

    def forward(self, positive: Candidate, *, training: bool = False, step=None, context=None,
                **kwargs):
        return global_candidates(positive, context)


def _log32(x: float) -> float:
    """log(x) in float32 (as JAX takes ``jnp.log`` of a Python float), as a
    Python number: a captured graph holds no host tensor."""
    return float(np.log(np.float32(x)))


class PopularityBasedSampler(CandidateSampler, RandomBlock):
    """Log-uniform (Zipfian) draws over the ids 0..``max_id``, with their
    analytic probabilities for the logQ correction:

        P(id) = (log(id + 2) - log(id + 1)) / log(max_id + 2)

    (ids frequency-sorted, id 0 the most popular, as the JAX package
    requires). ``max_num_samples`` ids a step, drawn by the inverse CDF from
    the block's generator (:class:`~models_tpu_torch.core.block.RandomBlock`;
    JAX folds the step into its key, so the two packages draw different
    ids). The contrastive head looks up their embeddings in its tied table.
    """

    def __init__(self, max_num_samples: int = 100, max_id: Optional[int] = None, seed: int = 0,
                 device=None):
        super().__init__(seed=seed, device=device)
        self.max_num_samples = int(max_num_samples)
        self.max_id = max_id

    def sample_ids(self, n: int, max_id: int, device) -> torch.Tensor:
        """(n,) int32 ids by the log-uniform inverse CDF over [0, max_id]."""
        u = torch.rand(n, generator=self.generator, device=device)
        ids = torch.exp(u * _log32(max_id + 2.0)) - 1.0
        return ids.to(torch.int32).clamp(0, max_id)

    def sampling_probs(self, ids: torch.Tensor, max_id: int) -> torch.Tensor:
        ids_f = ids.to(torch.float32)
        return (torch.log(ids_f + 2.0) - torch.log(ids_f + 1.0)) / _log32(max_id + 2.0)

    def forward(self, positive: Candidate, *, training: bool = False, step=None, **kwargs):
        if self.max_id is None:
            raise ValueError("PopularityBasedSampler needs max_id (catalog size - 1)")
        ids = self.sample_ids(self.max_num_samples, self.max_id, self.generator.device)
        return Candidate(id=ids, sampling_prob=self.sampling_probs(ids, self.max_id))
