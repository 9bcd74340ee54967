"""Dense and MLPBlock (``models_tpu/blocks/mlp.py``).

The JAX kernel is (in, out); the port's ``weight`` is (out, in), its
transpose, as ``torch.nn.functional.linear`` takes it. Under the
``mixed_bfloat16`` policy the product takes the input and the weight cast to
bf16 and gives a float32 result (the widened operands' fp32 product, cuBLAS
with TF32 off on the card); the bias and the activation follow in float32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core.block import Block
from ..core.combinators import SequentialBlock
from ..core.policy import cast_compute

_ACTIVATIONS = {"relu": F.relu, None: None}


class Dense(Block):
    """Dense layer on the last axis; glorot-uniform weight, zero bias."""

    def __init__(
        self,
        in_features: int,
        units: int,
        activation: Optional[str] = None,
        seed: int = 0,
        device=None,
    ):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise ValueError(f"Unknown activation {activation!r}")
        self.units = int(units)
        self.activation = activation
        weight = torch.empty(self.units, in_features, device=device)
        gen = torch.Generator(weight.device).manual_seed(seed + in_features)
        nn.init.xavier_uniform_(weight, generator=gen)
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(torch.zeros(self.units, device=device))

    def forward(self, inputs, **kwargs):
        x, w = cast_compute(inputs), cast_compute(self.weight)
        out = F.linear(x.float(), w.float(), self.bias)
        act = _ACTIVATIONS[self.activation]
        return out if act is None else act(out)


def MLPBlock(
    in_features: int,
    dimensions: Sequence[int],
    no_activation_last_layer: bool = False,
    seed: int = 0,
    device=None,
) -> SequentialBlock:
    """A stack of relu Dense layers; with ``no_activation_last_layer`` the
    last one is linear."""
    layers = []
    width = in_features
    for i, units in enumerate(dimensions):
        last = i == len(dimensions) - 1
        act = None if (no_activation_last_layer and last) else "relu"
        layers.append(Dense(width, units, activation=act, seed=seed + i, device=device))
        width = units
    return SequentialBlock(layers, block_name="MLPBlock")
