"""Row gather from a device-resident table (``models_tpu/ops/embedding_lookup.py``).

- :func:`row_gather` (K9): ``out[j] = table[ids[j]]``, ids clamped into the
  table; CUDA tensors go to the kernel of ``csrc/row_gather.cu``, CPU tensors
  to :func:`row_gather_plain`;
- :func:`pallas_gather`: the JAX package's name for the same function;
- :func:`gather_plan`: how the kernel copies rows between two tensors;
- :func:`a2a_lookup`, :func:`sharded_lookup`: lookups on a table split by
  rows over a mesh axis (``parallel/mesh.py``), each rank holding its shard;
- :func:`sharded_row_scatter_add`, :func:`sharded_update_rows`: row updates
  of such a table, each rank writing the rows it owns.

``EmbeddingTable`` looks rows up with ``F.embedding``, as the JAX package's
tables do, and a row-sharded table through :func:`sharded_lookup`. The
device-resident training route gathers each chunk's permuted rows of the
packed (n, F) int32 columns with :func:`row_gather`, as the JAX package's
chunk step takes them with ``jnp.take`` (``models/base.py``).

On a mesh the JAX package's ``shard_map`` sees the global batch; here each
rank holds its own ids (the whole batch, or its data slice where the batch
is split over ``data_axis``) and calls the same collectives as the other
ranks of its model line, in the same order. The owner's gather of the a2a
lookup is K9 (:func:`row_gather`); its backward lands the row gradients on
the owning shard through ``dedup_rows`` and K7. Where the batch is split
over ``data_axis``, the backward also gathers the (ids, row gradients) of
the ranks that hold the same shard, so that the shard's gradient is the
global batch's: a (B, D)-sized collective where a dense all-reduce of the
shard's gradient would move the shard.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import kernels
from ..parallel.collectives import (AllToAll, AxisGroup, GatherReplicated, SumReplicated,
                                    all_gather, all_to_all)

# the copy does not look at the type: any 32- or 16-bit element
TABLE_DTYPES = (torch.float32, torch.int32, torch.bfloat16, torch.float16)


def row_gather_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`row_gather`: ``index_select`` of the clamped ids."""
    return table.index_select(0, ids.long().clamp(0, table.shape[0] - 1))


def _lib():
    lib = kernels.load("row_gather")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.row_gather.argtypes = [p, i, p, p, i, i, i, p]
        lib.row_gather.restype = i
        lib.row_gather_plan.argtypes = [i, p, p, ctypes.POINTER(ctypes.c_int)]
        lib.row_gather_plan.restype = None
        lib._typed = True
    return lib


def row_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``out[j] = table[ids[j]]``: table (R, D) float32, int32, bfloat16 or
    float16, contiguous; ids (B,) int32 -> (B, D) in the table's dtype, the
    rows bit for bit. An id outside ``[0, R)`` is clamped into it, as the JAX
    package's ``jnp.take(..., mode="clip")`` fallback does (no host sync, no
    read outside the table). The JAX ``block`` argument, the TPU grid step,
    is dropped: the kernel has no block of ids to pad to."""
    if table.dtype not in TABLE_DTYPES or table.ndim != 2 or not table.is_contiguous():
        raise ValueError("table must be a contiguous 2-D float32, bfloat16 or float16 (or int32) "
                         "tensor")
    if ids.dtype != torch.int32 or ids.ndim != 1 or not ids.is_contiguous() \
            or ids.device != table.device:
        raise ValueError("ids must be a contiguous (B,) int32 tensor beside the table")
    (R, D), B = table.shape, ids.shape[0]
    if R == 0 and B > 0:
        raise ValueError("cannot gather from a table with no rows")
    if table.device.type == "cpu":
        return row_gather_plain(table, ids)
    if table.device.type != "cuda":
        raise ValueError(f"row_gather runs on CUDA or the CPU, not {table.device}")
    out = torch.empty((B, D), dtype=table.dtype, device=table.device)
    if B == 0 or D == 0:
        return out
    lib = _lib()
    rc = lib.row_gather(table.data_ptr(), table.element_size(), ids.data_ptr(), out.data_ptr(),
                        B, R, D, torch.cuda.current_stream(table.device).cuda_stream)
    kernels.check(lib, rc, "row_gather")
    row_gather.launches += 1
    return out


row_gather.launches = 0
pallas_gather = row_gather


def gather_plan(table: torch.Tensor, out: torch.Tensor) -> dict:
    """How :func:`row_gather` copies ``table``'s rows into ``out`` on the card:
    the piece's bytes (the widest of 16, 8, 4, 2 dividing the row and both
    addresses), the lanes a row and the rows a warp takes at a time."""
    plan = (ctypes.c_int * 3)()
    _lib().row_gather_plan(table.shape[1] * table.element_size(), table.data_ptr(),
                           out.data_ptr(), plan)
    return {"piece_bytes": plan[0], "lanes": plan[1], "rows_per_warp": plan[2]}


# ---------------------------------------------------------------------------
# mesh-sharded lookups
# ---------------------------------------------------------------------------

def _groups(mesh, axis: str, data_axis: Optional[str]):
    g = mesh.group(axis)
    dg = mesh.group(data_axis) if data_axis is not None else None
    return g, (dg if dg is not None and dg.size > 1 else None)


class _OwnerGather(torch.autograd.Function):
    """The owner's gather from its shard, K9; the backward lands the row
    gradients on the shard (``dedup_rows``, then K7 into zeros), first
    gathering the data line's (ids, rows) where given and taking their mean
    over it: the shard's gradient of the global batch's mean loss."""

    @staticmethod
    def forward(ctx, shard, local_ids, data_group):
        ctx.save_for_backward(local_ids)
        ctx.like = (shard.shape, shard.dtype, shard.device)
        ctx.data_group = data_group
        return row_gather(shard, local_ids)

    @staticmethod
    def backward(ctx, grad):
        from .scatter import dedup_rows, row_scatter_add

        (ids,) = ctx.saved_tensors
        grads, g = grad.float().contiguous(), ctx.data_group
        if g is not None:
            ids, grads = all_gather(ids, g), all_gather(grads, g) / g.size
        shape, dtype, device = ctx.like
        out = torch.zeros(shape, dtype=torch.float32, device=device)
        if ids.numel():
            sids, summed, start = dedup_rows(ids, grads)
            row_scatter_add(out, sids, summed, start)
        return out.to(dtype), None, None


def _a2a(table: torch.Tensor, ids: torch.Tensor, g: AxisGroup,
         data_group: Optional[AxisGroup]) -> torch.Tensor:
    n, m = g.size, g.index
    rows_per = table.shape[0]
    S = ids.shape[0] // n
    dev = table.device
    # 1. this rank's slice of the ids; out-of-range ids give zero rows
    ids_s = ids[m * S:(m + 1) * S].to(torch.int64)
    valid = (ids_s >= 0) & (ids_s < rows_per * n)
    ids_s = torch.where(valid, ids_s, 0)
    owner = ids_s // rows_per
    # 2. bucket by owner: sorted (stable), packed (n, S), capacity S a bucket
    order = torch.argsort(owner, stable=True)
    sorted_ids, sorted_owner = ids_s[order], owner[order]
    lanes = torch.arange(n, device=dev)
    starts = torch.searchsorted(sorted_owner, lanes)
    ends = torch.searchsorted(sorted_owner, lanes, right=True)
    idx = starts[:, None] + torch.arange(S, device=dev)[None, :]
    send = torch.where(idx < ends[:, None], sorted_ids[idx.clamp(max=max(S - 1, 0))], 0)
    # 3. ids to their owners, who gather their rows (padding slots read row
    # 0 of the shard and are never read back)
    recv = all_to_all(send.reshape(-1).to(torch.int32), g).to(torch.int64)
    local = (recv - m * rows_per).clamp(0, rows_per - 1).to(torch.int32).contiguous()
    rows = _OwnerGather.apply(table, local, data_group)
    # 4. rows back to their requesters, unsorted into slice order
    back = AllToAll.apply(rows, g).view(n, S, -1)
    emb = back[sorted_owner, torch.arange(S, device=dev) - starts[sorted_owner]]
    emb = emb[torch.argsort(order)] * valid[:, None].to(emb.dtype)
    # 5. the n slices, the same on every rank of the line
    return GatherReplicated.apply(emb, g)


def _psum(table: torch.Tensor, ids: torch.Tensor, g: AxisGroup,
          data_group: Optional[AxisGroup]) -> torch.Tensor:
    rows_per = table.shape[0]
    local = ids.to(torch.int64) - g.index * rows_per
    owned = (local >= 0) & (local < rows_per)
    safe = local.clamp(0, rows_per - 1).to(torch.int32).contiguous()
    rows = _OwnerGather.apply(table, safe, data_group) * owned[:, None].to(table.dtype)
    return SumReplicated.apply(rows, g)


def a2a_lookup(table: torch.Tensor, ids: torch.Tensor, mesh, axis: str = "model",
               data_axis: Optional[str] = None) -> torch.Tensor:
    """Bucketed all-to-all lookup on a table split by rows over ``axis``
    (``table``: this rank's (R/n, D) shard; ``ids``: this rank's (B,)).

    On the n ranks of the model line, each with the same ids: 1. take slice
    ``m`` (of S = B/n ids); 2. bucket them by owning shard (``id //
    (R/n)``), sorted and packed (n, S); 3. all-to-all the buckets to their
    owners, who gather their rows (K9); 4. all-to-all the rows back and
    unsort them; 5. all-gather the n slices into (B, D), the same on every
    rank of the line. An id outside ``[0, R)`` gives a zero row and no
    gradient. Comm a rank ~ B/n ids + 2 (B/n) D rows + B D gathered,
    whatever the table's size. The backward reverses the route
    (:mod:`~models_tpu_torch.parallel.collectives`: the own slice of the
    gathered cotangent, the reverse all-to-all) and lands the rows on the
    owner. ``data_axis``: the axis the batch is split over (the module's
    note). Requires ``B % n == 0``."""
    g, dg = _groups(mesh, axis, data_axis)
    flat = ids.reshape(-1)
    if flat.shape[0] % g.size:
        raise ValueError(f"a2a lookup: {flat.shape[0]} ids do not divide mesh axis "
                         f"{axis}={g.size}")
    return _a2a(table, flat, g, dg) if g.size > 1 else _psum(table, flat, g, dg)


def sharded_lookup(table: torch.Tensor, ids: torch.Tensor, mesh, axis: str = "model",
                   data_axis: Optional[str] = None, strategy: str = "auto") -> torch.Tensor:
    """Lookup on a table split by rows over ``axis`` (this rank's shard and
    its own ids, any shape; returns ``ids.shape + (D,)``).
    ``strategy="a2a"``: :func:`a2a_lookup`; ``"psum"``: each rank gathers
    the rows it owns (K9), zeros elsewhere, and one all-reduce over the
    line assembles them (its backward the identity: every rank holds the
    same cotangent once); ``"auto"``: a2a where the id count divides the
    axis, else psum. Either way the backward lands the row gradients on the
    owning shard (K7) and the table never moves."""
    if strategy not in ("auto", "a2a", "psum"):
        raise ValueError(f"unknown strategy {strategy!r}")
    g, dg = _groups(mesh, axis, data_axis)
    flat = ids.reshape(-1)
    n = g.size
    if strategy == "a2a" and flat.shape[0] % n:
        raise ValueError(f"a2a strategy needs {flat.shape[0]} ids divisible by mesh axis "
                         f"{axis}={n}")
    if strategy != "psum" and n > 1 and flat.shape[0] % n == 0:
        out = _a2a(table, flat, g, dg)
    else:
        out = _psum(table, flat, g, dg)
    return out.reshape(tuple(ids.shape) + (table.shape[1],))


def owned_rows(table: torch.Tensor, ids: torch.Tensor, valid: Optional[torch.Tensor], mesh,
           axis: str):
    """(local ids int32, owned mask): the rows of the global ``ids`` this
    rank's shard holds, at shard-local positions (clamped where not owned)."""
    rows_per = table.shape[0]
    local = ids.to(torch.int64) - mesh.index(axis) * rows_per
    owned = (local >= 0) & (local < rows_per)
    if valid is not None:
        owned = owned & valid.to(torch.bool)
    return local.clamp(0, rows_per - 1).to(torch.int32).contiguous(), owned


def sharded_row_scatter_add(table: torch.Tensor, ids: torch.Tensor, updates: torch.Tensor,
                            valid: Optional[torch.Tensor], mesh,
                            axis: str = "model") -> torch.Tensor:
    """``table[ids[j]] += updates[j]`` on a table split by rows over
    ``axis``: ``ids`` (N,) global rows, the same on every rank, whose valid
    positions target unique rows; each rank adds the rows it owns to its
    shard (K7), in place. No collective."""
    from .scatter import row_scatter_add

    local, owned = owned_rows(table, ids, valid, mesh, axis)
    return row_scatter_add(table, local, updates, owned)


def sharded_update_rows(table: torch.Tensor, ids: torch.Tensor, updates: torch.Tensor, mesh,
                        axis: str = "model") -> torch.Tensor:
    """Scatter-add ``updates`` into a table split by rows, equal ids
    accumulating (``dedup_rows`` first)."""
    from .scatter import dedup_rows

    sids, summed, valid = dedup_rows(ids.reshape(-1).to(torch.int32),
                                     updates.reshape(-1, updates.shape[-1]))
    return sharded_row_scatter_add(table, sids, summed, valid, mesh, axis)
