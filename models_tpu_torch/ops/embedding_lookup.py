"""Row gather from a device-resident table (``models_tpu/ops/embedding_lookup.py``).

- :func:`row_gather` (K9): ``out[j] = table[ids[j]]``, ids clamped into the
  table; CUDA tensors go to the kernel of ``csrc/row_gather.cu``, CPU tensors
  to :func:`row_gather_plain`;
- :func:`pallas_gather`: the JAX package's name for the same function;
- :func:`gather_plan`: how the kernel copies rows between two tensors.

``EmbeddingTable`` looks rows up with ``F.embedding``, as the JAX package's
tables do. The device-resident training route gathers each chunk's permuted
rows of the packed (n, F) int32 columns with :func:`row_gather`, as the JAX
package's chunk step takes them with ``jnp.take`` (``models/base.py``). The
mesh-sharded lookups of the JAX module wait for the distribution slice
(ROADMAP.md queue 1).
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels

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
