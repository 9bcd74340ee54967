"""What the references share: dense Adagrad over a loss, followed step by
step, and the precision a reference runs in.

Adagrad is optax's (the accumulator from ``initial``, ``acc += g * g``, the
update ``-lr * g * rsqrt(acc + eps)``). Over a table it leaves a row that no
step looked up exactly as it was (its gradient is zero), so a reference may
hold only the rows its steps look up: the losses, the gradients' norms and
the change's norms come out the same.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List

import torch


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 products as configured (``tf32=False``), or the control's
    TF32 (``tf32=True``); the previous settings are put back after."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def follow_adagrad(loss_fn: Callable, params: Dict[str, torch.Tensor],
                   batch_of: Callable[[int], dict], steps: int, change_at: int,
                   lr: float, initial: float, eps: float) -> dict:
    """Run ``steps`` Adagrad steps on ``params`` (updated in place), step
    ``i`` on ``batch_of(i)``. Returns every step's loss, each leaf's
    gradient norm at the first step, and each leaf's change norm after
    ``change_at`` steps."""
    start = {n: p.detach().clone() for n, p in params.items()}
    acc = {n: torch.full_like(p, initial) for n, p in params.items()}
    losses, grad_norms, change = [], {}, {}
    for step in range(steps):
        leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
        loss = loss_fn(leaves, batch_of(step))
        grads = torch.autograd.grad(loss, list(leaves.values()))
        losses.append(loss.detach())
        with torch.no_grad():
            for (n, p), g in zip(params.items(), grads):
                if step == 0:
                    grad_norms[n] = float(torch.linalg.vector_norm(g, dtype=torch.float64))
                acc[n].addcmul_(g, g)
                p.sub_(lr * g * torch.rsqrt(acc[n] + eps))
            if step + 1 == change_at:
                change = {n: float(torch.linalg.vector_norm(p - start[n], dtype=torch.float64))
                          for n, p in params.items()}
    return {"losses": [float(v) for v in losses], "grad_norms": grad_norms,
            "change_norms": change}
