"""The dense optimizers ``compile()`` names (``optax`` in the JAX package).

``adagrad`` follows optax's formula (``scale_by_rss``): the accumulator starts
at 0.1, ``acc += g * g`` and ``update = -lr * g * rsqrt(acc + 1e-7)``.
``torch.optim.Adagrad`` differs: its accumulator starts at 0 and its eps sits
outside the square root. ``sgd`` and ``adam`` (eps 1e-8) are torch's, whose
formulas are optax's. The row-sparse embedding optimizer and the other names
are not ported yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

_NOT_PORTED = ("adamw", "rmsprop", "lamb", "adafactor")


class Adagrad(torch.optim.Optimizer):
    """optax.adagrad. Parameters without a gradient are left as they are,
    which is what a zero gradient does to them."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, eps=eps))
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["sum"] = torch.full_like(p, initial_accumulator_value)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            acc = [self.state[p]["sum"] for p in params]
            torch._foreach_addcmul_(acc, grads, grads)
            scale = torch._foreach_add(acc, group["eps"])
            torch._foreach_rsqrt_(scale)
            torch._foreach_mul_(scale, grads)
            torch._foreach_add_(params, scale, alpha=-group["lr"])


def check_optimizer(name: str) -> None:
    """Raise unless ``name`` is a ported optimizer."""
    if name in ("adagrad", "sgd", "adam"):
        return
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (ROADMAP.md queue 1); ported: adagrad, "
            "sgd, adam")
    raise ValueError(f"Unknown optimizer {name!r}")


def make_optimizer(name: str, params: Iterable[torch.Tensor],
                   learning_rate: Optional[float]) -> torch.optim.Optimizer:
    """The optimizer ``name`` over ``params``; the learning rate defaults to
    1e-3, as in the JAX package."""
    check_optimizer(name)
    lr = 1e-3 if learning_rate is None else float(learning_rate)
    params = list(params)
    if name == "adagrad":
        return Adagrad(params, lr)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr)
    return torch.optim.Adam(params, lr=lr, eps=1e-8)
