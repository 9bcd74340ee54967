"""Negative candidate samplers (``models_tpu/outputs/sampling.py``): the
in-batch sampler. The popularity sampler waits (ROADMAP.md queue 1)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.block import Block


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
            raise NotImplementedError(
                f"the {s!r} sampler is not ported yet (ROADMAP.md queue 1)")
        raise ValueError(f"Unknown negative sampler {s!r}")


class InBatchSampler(CandidateSampler):
    """The batch's positive items are everyone's negatives."""

    def forward(self, positive: Candidate, *, training: bool = False, step=None, **kwargs):
        return positive
