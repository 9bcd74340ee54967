"""Dense layers, normalisation, dropout and MLPBlock (``models_tpu/blocks/mlp.py``).

The JAX kernel is (in, out); the port's ``weight`` is (out, in), its
transpose, as ``torch.nn.functional.linear`` takes it. Under the
``mixed_bfloat16`` policy the product takes the input and the weight cast to
bf16 and gives a float32 result (the widened operands' fp32 product, cuBLAS
with TF32 off on the card); the bias and the activation follow in float32.

As in the JAX package, a layer whose input width is not given
(``in_features``) builds at its first call (:class:`LazyMixin`): a model
builds them all in one eager pass over a sample batch before its optimizer
and any captured graph exist. The zoo models give every width, so their
parameters exist at construction. Each layer and ``MLPBlock`` expose
``out_features`` (None for a width-preserving layer not built yet). The
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
from ..core.device import resolve_device
from ..core.policy import cast_compute
from ..core.types import SequenceFeature

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


# ``nnx.initializers``' variance-scaling initialisers by name: (scale, mode,
# distribution); the truncated normal is cut at two standard deviations and
# rescaled, as ``jax.nn.initializers.variance_scaling`` does
_KERNEL_INITS = {
    "glorot_uniform": (1.0, "fan_avg", "uniform"), "xavier_uniform": (1.0, "fan_avg", "uniform"),
    "glorot_normal": (1.0, "fan_avg", "normal"), "xavier_normal": (1.0, "fan_avg", "normal"),
    "he_uniform": (2.0, "fan_in", "uniform"), "kaiming_uniform": (2.0, "fan_in", "uniform"),
    "he_normal": (2.0, "fan_in", "normal"), "kaiming_normal": (2.0, "fan_in", "normal"),
    "lecun_uniform": (1.0, "fan_in", "uniform"), "lecun_normal": (1.0, "fan_in", "normal"),
}


def _kernel(init: str, in_features: int, units: int, seed: int, device,
            dtype: torch.dtype) -> torch.Tensor:
    """A (units, in_features) weight drawn by ``init`` from a generator
    seeded by ``seed`` (glorot-uniform: the draw ``_glorot`` makes)."""
    if init in ("zeros", "ones"):
        return (torch.zeros if init == "zeros" else torch.ones)(units, in_features, device=device,
                                                               dtype=dtype)
    if init not in _KERNEL_INITS:
        raise ValueError(f"Unknown kernel_init {init!r}; options "
                         f"{sorted(_KERNEL_INITS) + ['ones', 'zeros']}")
    if init in ("glorot_uniform", "xavier_uniform"):
        return _glorot((units, in_features), seed, device).to(dtype)
    scale, mode, dist = _KERNEL_INITS[init]
    fan = {"fan_in": in_features, "fan_avg": (in_features + units) / 2}[mode]
    var = scale / max(1.0, fan)
    w = torch.empty(units, in_features, device=device)
    gen = torch.Generator(w.device).manual_seed(seed)
    if dist == "uniform":
        lim = (3.0 * var) ** 0.5
        nn.init.uniform_(w, -lim, lim, generator=gen)
    else:
        std = var ** 0.5 / 0.87962566103423978
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)
    return w.to(dtype)


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


class LazyMixin:
    """Build at the first call where the width was not given: ``build(in_features,
    device)`` makes the parameters from the input's last axis, on its device.
    A model builds every such layer in one eager pass
    (:meth:`~models_tpu_torch.models.base.BaseModel.build`) before its
    optimizer and any captured graph exist; an unbuilt layer met inside a
    CUDA graph capture raises, as the JAX package's raises under a tracer.
    A layer given ``in_features`` builds at construction, with the same
    draws (the seeds take ``in_features``, not the call)."""

    built: bool = False

    def _ensure_built(self, x: torch.Tensor) -> None:
        if self.built:
            return
        if _capturing():
            raise RuntimeError(f"{type(self).__name__} is not built. Run model.build(data) "
                               "(fit, evaluate and predict do) before capturing a graph.")
        self._build(int(x.shape[-1]), x.device)
        self.built = True

    def build(self, x, device=None) -> None:
        """Build on a sample whose last axis is the width (the JAX package's
        ``build(x)``; a :class:`SequenceFeature`'s values), on its device;
        or on the width as an ``int``, on ``device`` (default the card)."""
        if isinstance(x, int):
            width, dev = x, resolve_device(device)
        else:
            x = x.values if isinstance(x, SequenceFeature) else x
            width, dev = int(x.shape[-1]), (x.device if device is None else device)
        self._build(width, dev)
        self.built = True

    def _build(self, in_features: int, device) -> None:  # pragma: no cover - overridden
        raise NotImplementedError


def _split_seq(inputs):
    if isinstance(inputs, SequenceFeature):
        return inputs.values, inputs.mask
    return inputs, None


def _join_seq(out, mask):
    return out if mask is None else SequenceFeature(out, mask)


class Dense(LazyMixin, Block):
    """Dense layer on the last axis (a :class:`SequenceFeature`'s values,
    its mask kept); ``kernel_init`` (glorot-uniform) weight, zero bias, in
    ``param_dtype``. Without ``in_features`` it builds at its first call."""

    def __init__(
        self,
        units: int,
        activation: Union[str, Callable, None] = None,
        use_bias: bool = True,
        kernel_init: str = "glorot_uniform",
        seed: int = 0,
        param_dtype: torch.dtype = torch.float32,
        in_features: Optional[int] = None,
        device=None,
    ):
        super().__init__()
        self.act = get_activation(activation)
        self.units = self.out_features = int(units)
        self.use_bias = use_bias
        self.kernel_init = kernel_init
        self.seed = seed
        self.param_dtype = param_dtype
        self.register_parameter("weight", None)
        self.register_parameter("bias", None)
        if in_features is not None:
            self._build(int(in_features), device)
            self.built = True

    def _build(self, in_features: int, device) -> None:
        self.in_features = in_features
        self.weight = nn.Parameter(_kernel(self.kernel_init, in_features, self.units,
                                           self.seed + in_features, device, self.param_dtype))
        if self.use_bias:
            self.bias = nn.Parameter(torch.zeros(self.units, device=device,
                                                 dtype=self.param_dtype))

    def forward(self, inputs, **kwargs):
        inputs, mask = _split_seq(inputs)
        self._ensure_built(inputs)
        x, w = cast_compute(inputs), cast_compute(self.weight)
        out = F.linear(x.float(), w.float(), None if self.bias is None else self.bias.float())
        return _join_seq(out if self.act is None else self.act(out), mask)


class BatchNorm(LazyMixin, Block):
    """Batch normalisation over the last axis, the JAX package's: in
    training the batch's mean and biased variance normalise, and the running
    statistics move as ``m * old + (1 - m) * batch`` (Keras's momentum, 0.99),
    in place, so that a captured training chunk replays their update; in
    evaluation the running statistics normalise. ``(x - mean) / sqrt(var +
    eps) * scale + bias``, eps 1e-3. ``torch.nn.BatchNorm1d`` differs: its
    momentum weighs the batch, and its running variance is unbiased."""

    def __init__(self, momentum: float = 0.99, epsilon: float = 1e-3,
                 in_features: Optional[int] = None, device=None):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.out_features = in_features
        self.register_parameter("scale", None)
        self.register_parameter("bias", None)
        self.register_buffer("mean", None)
        self.register_buffer("var", None)
        if in_features is not None:
            self._build(int(in_features), device)
            self.built = True

    def _build(self, in_features: int, device) -> None:
        self.out_features = in_features
        self.scale = nn.Parameter(torch.ones(in_features, device=device))
        self.bias = nn.Parameter(torch.zeros(in_features, device=device))
        self.mean = torch.zeros(in_features, device=device)
        self.var = torch.ones(in_features, device=device)

    def forward(self, inputs, *, training: bool = False, **kwargs):
        inputs, mask = _split_seq(inputs)
        self._ensure_built(inputs)
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
        out = (inputs - mean) / torch.sqrt(var + self.epsilon) * self.scale + self.bias
        return _join_seq(out, mask)


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


class LayerNorm(LazyMixin, Block):
    """The JAX package's LayerNorm block: an :class:`NNXLayerNorm` as ``ln``."""

    def __init__(self, epsilon: float = 1e-6, in_features: Optional[int] = None, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.out_features = in_features
        self.register_module("ln", None)
        if in_features is not None:
            self._build(int(in_features), device)
            self.built = True

    def _build(self, in_features: int, device) -> None:
        self.out_features = in_features
        self.ln = NNXLayerNorm(in_features, self.epsilon, device)

    def forward(self, inputs, **kwargs):
        inputs, mask = _split_seq(inputs)
        self._ensure_built(inputs)
        return _join_seq(self.ln(inputs), mask)


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


class DenseMaybeLowRank(LazyMixin, Block):
    """A d -> d dense layer, full rank (``u`` (d, d)) or as ``(x @ v) @ u``
    with ``v`` (d, r), ``u`` (r, d); the JAX layout, (in, out)."""

    def __init__(self, low_rank_dim: Optional[int] = None, use_bias: bool = True,
                 seed: int = 0, in_features: Optional[int] = None, device=None):
        super().__init__()
        self.low_rank_dim = low_rank_dim
        self.use_bias = use_bias
        self.seed = seed
        self.out_features = in_features
        for name in ("v", "u", "bias"):
            self.register_parameter(name, None)
        if in_features is not None:
            self._build(int(in_features), device)
            self.built = True

    def _build(self, in_features: int, device) -> None:
        d = self.out_features = in_features
        gen_seed = self.seed + d
        if self.low_rank_dim is not None:
            self.v = nn.Parameter(_glorot((d, self.low_rank_dim), gen_seed, device))
            self.u = nn.Parameter(_glorot((self.low_rank_dim, d), gen_seed + 1, device))
        else:
            self.u = nn.Parameter(_glorot((d, d), gen_seed, device))
        if self.use_bias:
            self.bias = nn.Parameter(torch.zeros(d, device=device))

    def forward(self, inputs, **kwargs):
        self._ensure_built(inputs)
        x = inputs.float()
        out = x @ self.v @ self.u if self.v is not None else x @ self.u
        return out if self.bias is None else out + self.bias


class DenseResidualBlock(Block):
    """``act(x + norm(dense(x)))``, ``dense`` a :class:`DenseMaybeLowRank`;
    the JAX package's ``normalization`` takes only ``"batch_norm"``."""

    def __init__(self, low_rank_dim: Optional[int] = None,
                 activation: Union[str, None] = "relu",
                 normalization: Optional[str] = "batch_norm", seed: int = 0,
                 in_features: Optional[int] = None, device=None):
        super().__init__()
        self.out_features = in_features
        self.act = get_activation(activation)
        self.norm = (BatchNorm(in_features=in_features, device=device)
                     if normalization == "batch_norm" else None)
        self.dense = DenseMaybeLowRank(low_rank_dim, seed=seed, in_features=in_features,
                                       device=device)

    def forward(self, inputs, *, training: bool = False, **kwargs):
        out = self.dense(inputs)
        if self.norm is not None:
            out = self.norm(out, training=training)
        out = inputs + out
        return out if self.act is None else self.act(out)


def MLPBlock(
    dimensions: Sequence[int],
    activation: Union[str, Callable, None] = "relu",
    use_bias: bool = True,
    dropout: Optional[float] = None,
    normalization: Optional[str] = None,
    no_activation_last_layer: bool = False,
    kernel_init: str = "glorot_uniform",
    seed: int = 0,
    block_name: str = "MLPBlock",
    in_features: Optional[int] = None,
    device=None,
) -> SequentialBlock:
    """A stack of Dense layers, each followed by a normalisation
    (``"batch_norm"`` or ``"layer_norm"``) and dropout where asked; with
    ``no_activation_last_layer`` the last Dense is linear. Without
    ``in_features`` every layer builds at its first call, on its input's
    device."""
    layers: List[Block] = []
    width = in_features
    for i, units in enumerate(dimensions):
        last = i == len(dimensions) - 1
        act = None if (no_activation_last_layer and last) else activation
        layers.append(Dense(units, activation=act, use_bias=use_bias, kernel_init=kernel_init,
                            seed=seed + i, in_features=width, device=device))
        width = None if in_features is None else units
        if normalization == "batch_norm":
            layers.append(BatchNorm(in_features=width, device=device))
        elif normalization == "layer_norm":
            layers.append(LayerNorm(in_features=width, device=device))
        elif normalization:
            raise ValueError(f"Unknown normalization {normalization!r}")
        if dropout:
            layers.append(Dropout(dropout, seed=seed + i, device=device))
    block = SequentialBlock(layers, block_name=block_name)
    block.out_features = int(dimensions[-1]) if len(dimensions) else in_features
    return block
