"""Collectives over one axis of a mesh, and the autograd-aware ones a
training step differentiates through (``models_tpu/parallel/mesh.py``'s
counterpart of the collectives that ``shard_map`` and XLA insert).

Every function takes an :class:`AxisGroup`: the ranks of one line of the
mesh along an axis, with their process group. A group of one rank returns
its input and moves nothing. Under gloo a CUDA tensor is staged through host
memory (copied to the host, reduced there, copied back): the same code then
runs under gloo and NCCL. A reduce-scatter is built from
``all_to_all_single`` and a local sum, which both backends have.

- :class:`GatherRows`: all-gather along dim 0; its backward is the
  reduce-scatter (the global in-batch negatives);
- :class:`GatherReplicated`: all-gather whose output is the same on every
  rank of the group (the a2a lookup's last step); its backward takes the
  rank's own slice of the cotangent and sums nothing, since every rank holds
  the same cotangent once;
- :class:`AllToAll`: ``all_to_all_single`` of equal chunks; its backward is
  the same exchange of the cotangent;
- :class:`SumReplicated`: all-reduce whose output every rank then uses
  alike (the psum lookup); its backward is the identity.

:data:`TRAFFIC` counts each collective's calls and bytes (the larger of the
rank's input and output buffers), so that a test or a smoke run can show
that no step moves a table-sized tensor between ranks.

A mesh step runs inside :func:`data_scope`: the losses' weighted means then
divide by the data line's total weight (:func:`weight_total`), so that the
mean over the line of the ranks' losses is the global batch's weighted mean,
as the JAX package's loss over its data-sharded batch is.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, NamedTuple, Optional

import torch
import torch.distributed as dist


class AxisGroup(NamedTuple):
    """The ranks of one mesh line along ``axis`` (global ranks, in
    coordinate order), the process group over them (None for one rank), this
    rank's place among them and the group's backend."""

    axis: str
    ranks: tuple
    group: Optional[object]
    index: int
    backend: str

    @property
    def size(self) -> int:
        return len(self.ranks)


class Traffic:
    """Per-kind counts of the collectives run: calls, bytes in all, the
    largest of each kind (``largest``), the host seconds spent in them
    (staging included; under NCCL the time to enqueue), and the largest
    single collective's bytes (``max_bytes``, with its kind)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls = {}
        self.bytes = {}
        self.largest = {}
        self.seconds = {}
        self.max_bytes = 0
        self.max_kind = None

    def add(self, kind: str, nbytes: int, seconds: float = 0.0) -> None:
        self.seconds[kind] = self.seconds.get(kind, 0.0) + seconds
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.bytes[kind] = self.bytes.get(kind, 0) + int(nbytes)
        self.largest[kind] = max(self.largest.get(kind, 0), int(nbytes))
        if nbytes > self.max_bytes:
            self.max_bytes, self.max_kind = int(nbytes), kind

    def snapshot(self) -> dict:
        return {"calls": dict(self.calls), "bytes": dict(self.bytes),
                "largest": dict(self.largest), "seconds": dict(self.seconds),
                "max_bytes": self.max_bytes,
                "max_kind": self.max_kind}


TRAFFIC = Traffic()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _staged(t: torch.Tensor, g: AxisGroup) -> bool:
    return g.backend == "gloo" and t.device.type == "cuda"


@contextlib.contextmanager
def _counted(kind: str, nbytes: int):
    t0 = time.perf_counter()
    yield
    TRAFFIC.add(kind, nbytes, time.perf_counter() - t0)


def all_reduce(t: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """Sum ``t`` over the group, in place; returns ``t``."""
    if g.size == 1:
        return t
    with _counted("all_reduce", _nbytes(t)):
        if _staged(t, g):
            host = t.cpu()
            dist.all_reduce(host, group=g.group)
            t.copy_(host)
        else:
            dist.all_reduce(t, group=g.group)
    return t


def all_gather(t: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes), concatenated along dim 0 in the
    group's rank order."""
    if g.size == 1:
        return t
    src = t.contiguous()
    with _counted("all_gather", _nbytes(src) * g.size):
        staged = _staged(src, g)
        if staged:
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(g.size)]
        dist.all_gather(parts, src, group=g.group)
        out = torch.cat(parts)
        return out.to(t.device) if staged else out


def all_to_all(t: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """``t`` (n * S, ...) in n equal chunks along dim 0: chunk j goes to the
    group's j-th rank, and the output's chunk j comes from it."""
    if g.size == 1:
        return t
    src = t.contiguous()
    with _counted("all_to_all", _nbytes(src)):
        staged = _staged(src, g)
        if staged:
            src = src.cpu()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=g.group)
        return out.to(t.device) if staged else out


def reduce_scatter(t: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """``t`` (n * S, ...) summed over the group, and this rank's chunk of the
    sum: (S, ...). An all-to-all of the chunks and a local sum."""
    if g.size == 1:
        return t
    parts = all_to_all(t, g)
    return parts.view(g.size, -1, *t.shape[1:]).sum(dim=0)


def broadcast(t: torch.Tensor, g: AxisGroup, src_index: int = 0) -> torch.Tensor:
    """The group's ``src_index``-th rank's ``t`` on every rank, in place."""
    if g.size == 1:
        return t
    src = g.ranks[src_index]
    with _counted("broadcast", _nbytes(t)):
        if _staged(t, g):
            host = t.cpu()
            dist.broadcast(host, src, group=g.group)
            t.copy_(host)
        else:
            dist.broadcast(t, src, group=g.group)
    return t


class GatherRows(torch.autograd.Function):
    """All-gather along dim 0, the backward a reduce-scatter."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return all_gather(x, g)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad, ctx.g), None


class GatherReplicated(torch.autograd.Function):
    """All-gather whose output every rank of the group holds alike; the
    backward takes the rank's own slice of the cotangent."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g, ctx.rows = g, x.shape[0]
        return all_gather(x, g)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.g.index * ctx.rows
        return grad[lo:lo + ctx.rows], None


class AllToAll(torch.autograd.Function):
    """All-to-all of equal chunks; the backward the same exchange."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return all_to_all(x, g)

    @staticmethod
    def backward(ctx, grad):
        return all_to_all(grad, ctx.g), None


class SumReplicated(torch.autograd.Function):
    """All-reduce whose sum every rank uses alike; the backward the
    identity."""

    @staticmethod
    def forward(ctx, x, g):
        return all_reduce(x.clone(), g)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def gather_rows(x: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    return GatherRows.apply(x, g) if g.size > 1 else x


def all_reduce_tree(tree, g: AxisGroup):
    """Sum every tensor of a nested dict / list of tensors over the group,
    in one collective a dtype; the tree's tensors are updated in place."""
    leaves: List[torch.Tensor] = []

    def walk(node):
        if torch.is_tensor(node):
            leaves.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(tree)
    if g.size == 1 or not leaves:
        return tree
    by_dtype = {}
    for t in leaves:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        all_reduce(flat, g)
        offset = 0
        for t in ts:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n
    return tree


# the data line of the mesh step being run (data_scope), or None
_DATA_GROUP: List[Optional[AxisGroup]] = [None]


@contextlib.contextmanager
def data_scope(g: Optional[AxisGroup]):
    """Run a mesh step's forward and backward with ``g``, the rank's data
    line, as the one :func:`weight_total` reads."""
    prev = _DATA_GROUP[0]
    _DATA_GROUP[0] = g if g is not None and g.size > 1 else None
    try:
        yield
    finally:
        _DATA_GROUP[0] = prev


def in_data_scope() -> bool:
    """Whether a mesh step over a data line of more than one rank runs."""
    return _DATA_GROUP[0] is not None


def weight_total(w_sum: torch.Tensor) -> torch.Tensor:
    """The denominator of a weighted mean whose numerator is this rank's
    ``sum(w * loss)``: ``w_sum`` itself outside a mesh step; inside one, the
    data line's total weight over its size (a constant: no gradient)."""
    g = _DATA_GROUP[0]
    if g is None:
        return w_sum
    total = all_reduce(w_sum.detach().reshape(1).clone(), g)[0]
    return total / g.size
