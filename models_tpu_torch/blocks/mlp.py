"""Dense layers, normalisation, dropout and MLPBlock (``models_tpu/blocks/mlp.py``).

The JAX kernel is (in, out); the port's ``weight`` is (out, in), its
transpose, as ``torch.nn.functional.linear`` takes it. Under the
``mixed_bfloat16`` policy the product takes the input and the weight cast to
bf16 and gives a float32 result (the widened operands' fp32 product, cuBLAS
with TF32 off on the card); the bias and the activation follow in float32.

The JAX package builds these layers lazily, at a first call; the port takes
every width at construction (``in_features``, which the models work out
from the schema), so that the parameters exist before the optimizer and any
captured graph. Each layer and ``MLPBlock`` expose ``out_features``. The
initialisers keep the JAX seeds' formulas (``seed + in_features``; ``seed +
d`` for :class:`DenseMaybeLowRank`) on a ``torch.Generator``: the draws
themselves differ from ``jax.random``'s.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.block import Block, RandomBlock
from ..core.combinators import SequentialBlock
from ..core.policy import cast_compute

# ``jax.nn``'s functions by name, with its defaults (gelu: the tanh form)
_ACTIVATIONS = {
    "relu": F.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh, "silu": F.silu,
    "swish": F.silu, "elu": F.elu, "selu": F.selu, "softplus": F.softplus,
    "leaky_relu": F.leaky_relu, "relu6": F.relu6,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "log_softmax": lambda x: torch.log_softmax(x, dim=-1),
}


def get_activation(activation: Union[str, Callable, None]) -> Optional[Callable]:
    """A name of ``jax.nn``'s (or ``"linear"``, None: no activation), or a
    callable, as the function it names."""
    if activation is None or callable(activation):
        return activation
    if activation == "linear":
        return None
    if activation not in _ACTIVATIONS:
        raise ValueError(f"Unknown activation {activation!r}")
    return _ACTIVATIONS[activation]


def _glorot(shape, seed: int, device) -> torch.Tensor:
    w = torch.empty(shape, device=device)
    nn.init.xavier_uniform_(w, generator=torch.Generator(w.device).manual_seed(seed))
    return w


class Dense(Block):
    """Dense layer on the last axis; glorot-uniform weight, zero bias."""

    def __init__(
        self,
        in_features: int,
        units: int,
        activation: Union[str, Callable, None] = None,
        use_bias: bool = True,
        seed: int = 0,
        device=None,
    ):
        super().__init__()
        self.act = get_activation(activation)
        self.out_features = int(units)
        self.weight = nn.Parameter(_glorot((self.out_features, in_features), seed + in_features,
                                           device))
        self.bias = nn.Parameter(torch.zeros(self.out_features, device=device)) if use_bias else None

    def forward(self, inputs, **kwargs):
        x, w = cast_compute(inputs), cast_compute(self.weight)
        out = F.linear(x.float(), w.float(), self.bias)
        return out if self.act is None else self.act(out)


class BatchNorm(Block):
    """Batch normalisation over the last axis, the JAX package's: in
    training the batch's mean and biased variance normalise, and the running
    statistics move as ``m * old + (1 - m) * batch`` (Keras's momentum, 0.99),
    in place, so that a captured training chunk replays their update; in
    evaluation the running statistics normalise. ``(x - mean) / sqrt(var +
    eps) * scale + bias``, eps 1e-3. ``torch.nn.BatchNorm1d`` differs: its
    momentum weighs the batch, and its running variance is unbiased."""

    def __init__(self, num_features: int, momentum: float = 0.99, epsilon: float = 1e-3,
                 device=None):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.out_features = num_features
        self.scale = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("mean", torch.zeros(num_features, device=device))
        self.register_buffer("var", torch.ones(num_features, device=device))

    def forward(self, inputs, *, training: bool = False, **kwargs):
        if training:
            axes = tuple(range(inputs.ndim - 1))
            mean = inputs.mean(dim=axes)
            var = inputs.var(dim=axes, unbiased=False)
            m = self.momentum
            with torch.no_grad():
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        return (inputs - mean) / torch.sqrt(var + self.epsilon) * self.scale + self.bias


class NNXLayerNorm(nn.Module):
    """``nnx.LayerNorm`` under its attribute names (``scale``, ``bias``):
    over the last axis, the variance as ``E[x^2] - E[x]^2`` (clipped at 0),
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, eps 1e-6."""

    def __init__(self, num_features: int, epsilon: float = 1e-6, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))

    def forward(self, inputs):
        x = inputs.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x * x).mean(dim=-1, keepdim=True) - mean.square()).clamp_min(0)
        return (x - mean) * (torch.rsqrt(var + self.epsilon) * self.scale) + self.bias


class LayerNorm(Block):
    """The JAX package's LayerNorm block: an :class:`NNXLayerNorm` as ``ln``."""

    def __init__(self, num_features: int, epsilon: float = 1e-6, device=None):
        super().__init__()
        self.out_features = num_features
        self.ln = NNXLayerNorm(num_features, epsilon, device)

    def forward(self, inputs, **kwargs):
        return self.ln(inputs)


class Dropout(RandomBlock):
    """Dropout in training: each element kept with probability ``1 - rate``
    and scaled by ``1 / (1 - rate)``. JAX derives its bits from (seed, step);
    the port draws them from the block's generator (:class:`RandomBlock`)."""

    def __init__(self, rate: float, seed: int = 0, device=None):
        super().__init__(seed=seed, device=device)
        self.rate = float(rate)

    def forward(self, inputs, *, training: bool = False, **kwargs):
        if not training or self.rate == 0.0:
            return inputs
        keep = torch.rand(inputs.shape, generator=self.generator, device=inputs.device)
        return torch.where(keep < 1.0 - self.rate, inputs / (1.0 - self.rate), 0.0)


class DenseMaybeLowRank(Block):
    """A d -> d dense layer, full rank (``u`` (d, d)) or as ``(x @ v) @ u``
    with ``v`` (d, r), ``u`` (r, d); the JAX layout, (in, out)."""

    def __init__(self, in_features: int, low_rank_dim: Optional[int] = None,
                 use_bias: bool = True, seed: int = 0, device=None):
        super().__init__()
        d = self.out_features = in_features
        self.low_rank_dim = low_rank_dim
        gen_seed = seed + d
        if low_rank_dim is not None:
            self.v = nn.Parameter(_glorot((d, low_rank_dim), gen_seed, device))
            self.u = nn.Parameter(_glorot((low_rank_dim, d), gen_seed + 1, device))
        else:
            self.v = None
            self.u = nn.Parameter(_glorot((d, d), gen_seed, device))
        self.bias = nn.Parameter(torch.zeros(d, device=device)) if use_bias else None

    def forward(self, inputs, **kwargs):
        x = inputs.float()
        out = x @ self.v @ self.u if self.v is not None else x @ self.u
        return out if self.bias is None else out + self.bias


class DenseResidualBlock(Block):
    """``act(x + norm(dense(x)))``, ``dense`` a :class:`DenseMaybeLowRank`;
    the JAX package's ``normalization`` takes only ``"batch_norm"``."""

    def __init__(self, in_features: int, low_rank_dim: Optional[int] = None,
                 activation: Union[str, None] = "relu",
                 normalization: Optional[str] = "batch_norm", seed: int = 0, device=None):
        super().__init__()
        self.out_features = in_features
        self.act = get_activation(activation)
        self.norm = BatchNorm(in_features, device=device) if normalization == "batch_norm" else None
        self.dense = DenseMaybeLowRank(in_features, low_rank_dim, seed=seed, device=device)

    def forward(self, inputs, *, training: bool = False, **kwargs):
        out = self.dense(inputs)
        if self.norm is not None:
            out = self.norm(out, training=training)
        out = inputs + out
        return out if self.act is None else self.act(out)


def MLPBlock(
    in_features: int,
    dimensions: Sequence[int],
    activation: Union[str, Callable, None] = "relu",
    use_bias: bool = True,
    dropout: Optional[float] = None,
    normalization: Optional[str] = None,
    no_activation_last_layer: bool = False,
    seed: int = 0,
    block_name: str = "MLPBlock",
    device=None,
) -> SequentialBlock:
    """A stack of Dense layers, each followed by a normalisation
    (``"batch_norm"`` or ``"layer_norm"``) and dropout where asked; with
    ``no_activation_last_layer`` the last Dense is linear."""
    layers: List[Block] = []
    width = in_features
    for i, units in enumerate(dimensions):
        last = i == len(dimensions) - 1
        act = None if (no_activation_last_layer and last) else activation
        layers.append(Dense(width, units, activation=act, use_bias=use_bias, seed=seed + i,
                            device=device))
        width = units
        if normalization == "batch_norm":
            layers.append(BatchNorm(width, device=device))
        elif normalization == "layer_norm":
            layers.append(LayerNorm(width, device=device))
        elif normalization:
            raise ValueError(f"Unknown normalization {normalization!r}")
        if dropout:
            layers.append(Dropout(dropout, seed=seed + i, device=device))
    block = SequentialBlock(layers, block_name=block_name)
    block.out_features = width
    return block
