"""Work by count, from shapes: the operations and bytes that a step or a
call needs for its inputs, which the per-layer metrics hold to the card's
peaks. No recomputation is counted: a backward pass's products are the two
a forward product needs (input and weight gradients), and a kernel that
computes a product again is charged only once for it.

Adagrad leaves a table row that no lookup of the step touched exactly as it
was, so an update's bytes are those of the rows a step looks up and of the
dense parameters: each element's parameter, gradient and accumulator read,
and parameter and accumulator written (five float32 accesses)."""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

FP32 = 4
ADAGRAD_ACCESSES = 5


def dense_flops(batch: int, shapes: Iterable[Sequence[int]]) -> float:
    """Forward multiply-adds, as 2 operations each, of (out, in) weights."""
    return float(sum(2 * batch * out * inp for out, inp in shapes))


def train_from_forward(forward: float) -> float:
    """Forward and backward: the backward takes two products a forward one."""
    return 3.0 * forward


def adagrad_bytes(touched_rows: int, dim: int, dense_params: int) -> float:
    return float(ADAGRAD_ACCESSES * FP32 * (touched_rows * dim + dense_params))


def unique_count(ids: np.ndarray) -> int:
    return int(np.unique(ids).size)


def topk_flops(queries: int, catalog: int, dim: int) -> float:
    return 2.0 * queries * catalog * dim


def topk_bytes(queries: int, catalog: int, dim: int, k: int) -> float:
    """The catalog read once, the queries read, each query's k scores and
    ids written."""
    return float(FP32 * (catalog * dim + queries * dim) + queries * k * 8)
