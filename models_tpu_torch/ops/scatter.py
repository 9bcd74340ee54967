"""Row scatters of the row-sparse embedding optimizer (``models_tpu/ops/scatter.py``).

- :func:`dedup_rows`: sort the ids and segment-sum the rows of equal ids, with
  static shapes (N in, N out), so that every valid scatter target is unique;
- :func:`run_starts`: of sorted ids, the first position of each run of equal
  ids (the positions a scatter of unique targets takes);
- :func:`stochastic_round`: float32 to bfloat16, rounding up with the
  probability of the distance to the lower neighbour, from caller-given noise;
- :func:`row_scatter_add` (K7): ``table[ids[j]] += updates[j]``, in place;
- :func:`row_scatter_write` (K8): ``table[ids[j]] = rows[j]``, in place.

The two scatters act on every position j with ``valid[j]`` (every j when
``valid`` is None) whose id lies in ``[0, R)``: an invalid position may hold
any id, which is then never used as an address, and an id outside the table is
dropped (the JAX package's ``mode="drop"``). The valid ids must be unique
(:func:`dedup_rows` makes them so); neither the kernels nor the plain versions
check it, as that would cost a sort. CUDA tensors go to the kernels of
``csrc/row_scatter.cu``, CPU tensors to the plain versions. Tables are float32
or bfloat16; a bf16 table's add is taken in float32 and rounded to nearest.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import kernels

TABLE_DTYPES = (torch.float32, torch.bfloat16)


def dedup_rows(ids: torch.Tensor, rows: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(ids (N,), rows (N, D)) -> (sorted ids, summed rows, is run start).

    Each position holds the sum of the rows of its id; only the first
    position of a run of equal ids is marked valid. The other positions carry
    a duplicate id and must be masked by the third output. The sort is stable,
    as ``jnp.argsort``; the sum is float32 in another order than
    ``jax.ops.segment_sum`` (``index_add_`` with atomics on CUDA). No output
    shape depends on the data, so nothing waits for the device."""
    sids, order = torch.sort(ids, stable=True)
    srows = rows.index_select(0, order)
    start = run_starts(sids)
    seg = torch.cumsum(start, 0) - 1
    summed = torch.zeros_like(srows).index_add_(0, seg, srows)
    return sids, summed.index_select(0, seg), start


def run_starts(sids: torch.Tensor) -> torch.Tensor:
    """Of sorted ids (N,): True at the first position of each run of equal
    ids, (N,) bool."""
    start = torch.ones(sids.shape[0], dtype=torch.bool, device=sids.device)
    start[1:] = sids[1:] != sids[:-1]
    return start


def stochastic_round(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Round ``x`` (float32) to bfloat16 stochastically: add the low 16 bits
    of ``noise`` (int32, the shape of ``x``) to the bits that truncation
    drops, then truncate. Values already representable stay exact; a value
    rounds up with the probability of its distance to the lower neighbour.
    Infinities stay; a NaN becomes the quiet NaN of its sign (0x7FC0 or
    0xFFC0), as the JAX package's conversion gives it. The caller draws the
    noise, so that two implementations fed the same bits round alike.

    Integer arithmetic on the float's bits throughout, so that the result
    does not depend on a device's float-to-bf16 conversion (PyTorch's CPU
    conversion writes every NaN as 0xFFFF)."""
    if noise.shape != x.shape or noise.dtype != torch.int32:
        raise ValueError(f"noise must be int32 of shape {tuple(x.shape)}")
    x = x.float()
    # a finite value's bits plus at most 0xFFFF cannot carry into the sign
    # bit; an infinity adds nothing and truncates exactly
    high = (x.view(torch.int32) + torch.where(torch.isfinite(x), noise & 0xFFFF, 0)) >> 16
    high = torch.where(torch.isnan(x), (high & -0x8000) | 0x7FC0, high)
    return high.to(torch.int16).view(torch.bfloat16)


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------


def _targets(table, ids, valid):
    keep = (ids >= 0) & (ids < table.shape[0])
    if valid is not None:
        keep &= valid
    return ids[keep].long(), keep


def row_scatter_add_plain(table, ids, updates, valid=None) -> torch.Tensor:
    """Plain version of :func:`row_scatter_add` (boolean compaction, so a
    CUDA caller waits for the device)."""
    idx, keep = _targets(table, ids, valid)
    table.index_put_((idx,), (table[idx].float() + updates[keep]).to(table.dtype))
    return table


def row_scatter_write_plain(table, ids, rows, valid=None) -> torch.Tensor:
    """Plain version of :func:`row_scatter_write`."""
    idx, keep = _targets(table, ids, valid)
    table.index_put_((idx,), rows[keep])
    return table


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------


def _lib():
    lib = kernels.load("row_scatter")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.row_scatter_add, lib.row_scatter_write):
            fn.argtypes = [p, i, p, p, p, i, i, i, p]
            fn.restype = i
        lib.row_scatter_add_batch.restype = i
        lib.row_scatter_write_batch.restype = i
        lib.row_scatter_write_rows_first.argtypes = [i, i]
        lib.row_scatter_write_rows_first.restype = i
        lib._typed = True
    return lib


def _check(table, ids, rows, rows_dtype, valid):
    if table.dtype not in TABLE_DTYPES or table.ndim != 2 or not table.is_contiguous():
        raise ValueError("table must be a contiguous 2-D float32 or bfloat16 tensor")
    dev = table.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the row scatters run on CUDA or the CPU, not {dev}")
    if ids.dtype != torch.int32 or ids.ndim != 1 or not ids.is_contiguous() or ids.device != dev:
        raise ValueError("ids must be a contiguous (N,) int32 tensor beside the table")
    n, D = ids.shape[0], table.shape[1]
    if rows.dtype != rows_dtype or rows.shape != (n, D) or not rows.is_contiguous() \
            or rows.device != dev:
        raise ValueError(f"rows must be a contiguous ({n}, {D}) {rows_dtype} tensor "
                         "beside the table")
    if valid is not None and (valid.dtype != torch.bool or valid.shape != (n,)
                              or not valid.is_contiguous() or valid.device != dev):
        raise ValueError(f"valid must be a contiguous ({n},) bool tensor beside the table")


def _launch(entry, counter, table, ids, rows, valid):
    (R, D), n = table.shape, ids.shape[0]
    if n == 0:
        return table
    lib = _lib()
    rc = getattr(lib, entry)(
        table.data_ptr(), int(table.dtype == torch.bfloat16), ids.data_ptr(), rows.data_ptr(),
        None if valid is None else valid.data_ptr(), n, R, D,
        torch.cuda.current_stream(table.device).cuda_stream,
    )
    kernels.check(lib, rc, entry)
    counter.launches += 1
    return table


def row_scatter_add(table: torch.Tensor, ids: torch.Tensor, updates: torch.Tensor,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``table[ids[j]] += updates[j]`` in place for every valid j, and returns
    ``table`` (R, D) f32 or bf16. ``ids`` (N,) int32, ``updates`` (N, D) f32,
    ``valid`` (N,) bool or None. The valid ids must be unique."""
    _check(table, ids, updates, torch.float32, valid)
    if table.device.type == "cpu":
        return row_scatter_add_plain(table, ids, updates, valid)
    return _launch("row_scatter_add", row_scatter_add, table, ids, updates, valid)


def row_scatter_write(table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``table[ids[j]] = rows[j]`` in place for every valid j, and returns
    ``table``. ``rows`` (N, D) in the table's dtype; otherwise as
    :func:`row_scatter_add`."""
    _check(table, ids, rows, table.dtype, valid)
    if table.device.type == "cpu":
        return row_scatter_write_plain(table, ids, rows, valid)
    return _launch("row_scatter_write", row_scatter_write, table, ids, rows, valid)


def write_order(n: int, rows: int) -> str:
    """The order of loads :func:`row_scatter_write` takes on the card for
    ``n`` positions into a table of ``rows`` rows (16-byte rows): ``"rows
    first"`` (the source rows read beside the ids, every position's, where
    ``n <= rows``) or ``"ids first"`` (the valid positions' rows after the
    ids, where at least ``n - rows`` positions are invalid)."""
    return "rows first" if _lib().row_scatter_write_rows_first(n, rows) else "ids first"


row_scatter_add.launches = 0
row_scatter_write.launches = 0
