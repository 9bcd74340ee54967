"""Input corruption (``models_tpu/transforms/noise.py``)."""

from __future__ import annotations

import torch

from ..core.block import Block
from ..core.types import SequenceFeature


def _swap(v: torch.Tensor, perm: torch.Tensor, swap: torch.Tensor) -> torch.Tensor:
    """``v`` with the elements where ``swap`` holds taken from row
    ``perm[b]`` of the batch."""
    return torch.where(swap, v[perm], v)


class StochasticSwapNoise(Block):
    """In training, each feature value is replaced, with probability
    ``pad_ratio``, by the same feature of another row of the batch (a
    SequenceFeature's values, its mask kept). The JAX package draws the
    permutation and the swap mask from ``jax.random`` keyed by (seed, step,
    the feature's index in sorted name order); the port draws them from a
    ``torch.Generator`` seeded by the same three, on the feature's device
    (other draws), and applies them through :func:`_swap`."""

    def __init__(self, pad_ratio: float = 0.1, seed: int = 0):
        super().__init__()
        self.pad_ratio = float(pad_ratio)
        self.seed = seed

    def draws(self, v: torch.Tensor, step: int, index: int):
        """(perm (B,), swap mask of ``v``'s shape) for one feature."""
        gen = torch.Generator(v.device).manual_seed(
            (self.seed * 1_000_003 + int(step) * 1009 + index) & 0x7FFFFFFFFFFFFFFF)
        perm = torch.randperm(v.shape[0], generator=gen, device=v.device)
        swap = torch.rand(v.shape, generator=gen, device=v.device) < self.pad_ratio
        return perm, swap

    def _apply(self, v, step: int, index: int):
        if isinstance(v, SequenceFeature):
            return SequenceFeature(self._apply(v.values, step, index), v.mask)
        return _swap(v, *self.draws(v, step, index))

    def forward(self, inputs, *, training: bool = False, context=None, **kwargs):
        if not training or self.pad_ratio == 0.0:
            return inputs
        step = context.get("step", 0) if context is not None else 0
        if isinstance(inputs, dict):
            out = {name: self._apply(v, step, i) for i, (name, v) in enumerate(sorted(inputs.items()))}
            return {k: out[k] for k in inputs}
        return self._apply(inputs, step, 0)
