"""Initial weights from the seed, made on the device one leaf a call.

A configuration's reference names its leaves (``kinds/<kind>/reference.py::
leaf_specs``): ``(name, shape, init)``, ``init`` one of ``("uniform", a)``,
``("glorot_uniform",)``, ``("zeros",)``. Leaf ``i`` is drawn from a
``torch.Generator`` of its own, seeded from the run's seed and ``i``, so the
benchmark can fill the program's parameter in place and make the same
values again for the reference, or to measure how far a leaf moved.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def leaf_seed(seed: int, index: int) -> int:
    return (int(seed) * 1_000_003 + 7_919 * (index + 1)) % (2 ** 63)


def fill_(out: torch.Tensor, init: Sequence, seed: int, index: int) -> torch.Tensor:
    """Fill the contiguous ``out`` with leaf ``index``'s values."""
    if not out.is_contiguous():
        raise ValueError("a leaf is filled contiguous, so that it can be made again alike")
    kind = init[0]
    if kind == "zeros":
        return out.zero_()
    gen = torch.Generator(out.device).manual_seed(leaf_seed(seed, index))
    if kind == "uniform":
        bound = float(init[1])
    elif kind == "glorot_uniform":
        fan_out, fan_in = out.shape  # (out, in), as torch.nn.Linear
        bound = math.sqrt(6.0 / (fan_in + fan_out))
    else:
        raise ValueError(f"unknown initializer {kind!r}")
    return out.uniform_(-bound, bound, generator=gen)


def make(shape, init: Sequence, seed: int, index: int, device) -> torch.Tensor:
    return fill_(torch.empty(tuple(shape), dtype=torch.float32, device=device), init, seed,
                 index)
