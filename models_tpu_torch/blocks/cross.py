"""DCN-v2 cross layers (``models_tpu/blocks/cross.py``):
``x_{l+1} = x0 * (W x_l + b) + x_l``, W full (d, d) or low rank."""

from __future__ import annotations

from typing import Optional

from ..core.block import Block
from ..core.combinators import SequentialBlock
from .mlp import DenseMaybeLowRank


class Cross(Block):
    """One cross layer over ``(x0, x_l)`` (or one tensor for both); returns
    ``(x0, x_{l+1})``."""

    def __init__(self, low_rank_dim: Optional[int] = None, seed: int = 0,
                 in_features: Optional[int] = None, device=None):
        super().__init__()
        self.out_features = in_features
        self.dense = DenseMaybeLowRank(low_rank_dim=low_rank_dim, seed=seed,
                                       in_features=in_features, device=device)

    def forward(self, inputs, **kwargs):
        x0, x = inputs if isinstance(inputs, tuple) else (inputs, inputs)
        return x0, x0 * self.dense(x) + x


class _TakeCrossOutput(Block):
    def forward(self, inputs, **kwargs):
        return inputs[1] if isinstance(inputs, tuple) else inputs


def CrossBlock(depth: int = 1, low_rank_dim: Optional[int] = None, seed: int = 0,
               block_name: str = "CrossBlock", in_features: Optional[int] = None,
               device=None) -> SequentialBlock:
    """``depth`` cross layers threading ``(x0, x_l)``, then ``x_depth``;
    without ``in_features`` each builds at its first call."""
    if depth < 1:
        raise ValueError(f"CrossBlock depth must be >= 1, got {depth}")
    layers = [Cross(low_rank_dim=low_rank_dim, seed=seed + i, in_features=in_features,
                    device=device) for i in range(depth)]
    block = SequentialBlock(layers + [_TakeCrossOutput()], block_name=block_name)
    block.out_features = in_features
    return block
