"""Input regularization transforms (``models_tpu/transforms/regularization.py``)."""

from __future__ import annotations

import torch

from ..core.block import Block
from ..core.types import SequenceFeature


class L2Norm(Block):
    """L2-normalise the last axis (a dict's values each, a sequence's
    values): ``x / sqrt(max(sum(x**2), epsilon))``, the two-tower model's
    cosine towers."""

    def __init__(self, epsilon: float = 1e-12):
        super().__init__()
        self.epsilon = epsilon

    def _norm(self, x):
        if isinstance(x, SequenceFeature):
            return SequenceFeature(self._norm(x.values), x.mask)
        return x / torch.sqrt(torch.clamp_min(x.square().sum(dim=-1, keepdim=True),
                                              self.epsilon))

    def forward(self, inputs, **kwargs):
        if isinstance(inputs, dict):
            return {k: self._norm(v) for k, v in inputs.items()}
        return self._norm(inputs)
