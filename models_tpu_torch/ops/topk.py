"""Exact top-k of ``queries @ candidates.T`` (``models_tpu/ops/topk.py``).

Routes, picked by :func:`topk_route` as the JAX ``topk_scores`` picks them:

- ``direct``: one product and one selection, for a catalog of at most one tile;
- ``binned``: the two-phase exact top-k. Phase A scores every candidate and
  keeps each 64-row bin's max (a plain product, as the JAX package leaves it
  to XLA); phase B rescores only the rows of the best ``k + margin`` bins
  through :func:`binned_rescore` (the kernel replacing K5);
- ``streaming``: the CUDA kernel :func:`streaming_topk` (replacing K6), for
  query batches whose binned pool would be too large, when the tensors lie on
  the card;
- ``blockwise``: the same function in plain PyTorch, tile by tile, elsewhere;
- :func:`sharded_topk`: the top-k over a catalog split by rows over a mesh
  axis, each rank scanning its shard and the (B, k) lists merged.

Every selection ranks by (score descending, position ascending), the order of
``lax.top_k``. Scores are fp32 for fp32 and bf16 catalogs alike, as JAX
promotes an f32 x bf16 product to f32. A padded row scores ``NEG_INF``, the
float32 minimum, not ``-inf``.

int8 catalogs (the bin-quantized index, ``outputs/topk.py``) come with
``col_scale``, one fp32 dequantization scale per row, and each route keeps
the JAX package's own scoring: the binned route quantizes the queries per row
to int8 and scores in exact int32 (phase A a cuBLASLt int8 product,
``torch._int_mm``; phase B :func:`binned_rescore`'s int8 form), scaling each
bin's max or each pooled score by its row's scale and the final (B, k) by the
query's; the direct, streaming and blockwise routes score fp32 queries
against the int8 rows widened to fp32, times the row's scale.

A kernel wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises. K5 and K6 are
``torch.library`` custom ops, ``models_tpu_torch::binned_rescore`` and
``models_tpu_torch::streaming_topk``: each has a fake implementation (its
outputs' shapes and dtypes), a CPU one (the plain version) and a CUDA one
(the launch, which counts it), so that a program traced by
``torch.export`` holds the kernel as an operator and runs it wherever the
program is loaded after ``import models_tpu_torch``. Their wrappers call
the op while a program is traced (``torch.compiler.is_compiling()``:
``torch.export``, ``torch.compile``) and the same two bodies directly
otherwise: the op's dispatch costs 0.013-0.017 ms of host time a K5 call
and 0.04-0.07 ms a K6 call on an H100 (PERF.md §6, ``ab_steps.py --what
predict``). Registering the ops builds and loads nothing.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from . import kernels

NEG_INF = torch.finfo(torch.float32).min
CAND_DTYPES = (torch.float32, torch.bfloat16, torch.int8)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# torch._int_mm on CUDA (cuBLASLt) checks "self.size(0) needs to be greater
# than 16", "self.size(1) ... a multiple of 8" and "mat2.size(1) ... a
# multiple of 8" (read from the installed libtorch_cuda); a batch of 16 rows
# or fewer is zero-padded to this many, C and D to multiples of 8
_INT_MM_MIN_ROWS = 32
_BINNED_BIN_SIZE = 64
_BINNED_MARGIN = 2
_BINNED_POOL_BYTES = 512 * 2**20

def stable_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k best of each row by (score desc, position asc): the first k of a
    stable descending sort, as ``lax.top_k`` ranks. On the CPU, where a full
    sort costs many times a selection, ``torch.topk`` answers wherever it is
    unambiguous: no two of the k scores equal and no other score equal to
    the k-th (its order among equal scores is unspecified). Otherwise, on
    the card (the check would wait for the device) and while
    ``torch.export`` traces (the check reads data), the sort."""
    k = min(k, scores.shape[1])
    # the check reads the scores: never while torch.export traces
    if scores.device.type == "cpu" and not torch.compiler.is_exporting():
        s, idx = torch.topk(scores, k, dim=1)
        if not bool((s[:, 1:] == s[:, :-1]).any()) \
                and bool(((scores >= s[:, -1:]).sum(dim=1) == k).all()):
            return s, idx
    s, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return s[:, :k], idx[:, :k]


def _scores(queries: torch.Tensor, candidates: torch.Tensor,
            scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fp32 ``queries @ candidates.T`` (int8 and bf16 rows widened to fp32),
    times each row's ``scale`` where given."""
    s = queries @ candidates.to(torch.float32).T
    return s if scale is None else s * scale[None, :]


def _int_scores(q8: torch.Tensor, c8: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``q8 @ c8.T`` for int8 operands (B, D) and (C, D): the
    cuBLASLt int8 product, the catalog read as int8 where it lies (a
    transposed view, no copy). Zeros, which leave every dot as it is, pad
    what its checks refuse: a batch of 16 rows or fewer to
    ``_INT_MM_MIN_ROWS``, C and D to multiples of 8 (a D that is not one
    costs a padded copy of the rows per call)."""
    B, D = q8.shape
    C = c8.shape[0]
    pad_d, pad_c = -D % 8, -C % 8
    if pad_d or pad_c:
        c8 = torch.nn.functional.pad(c8, (0, pad_d, 0, pad_c))
    pad_b = _INT_MM_MIN_ROWS - B if B <= 16 else 0
    if pad_d or pad_b:
        q8 = torch.nn.functional.pad(q8, (0, pad_d, 0, pad_b))
    return torch._int_mm(q8, c8.T)[:B, :C]


def int8_scale(amax: torch.Tensor) -> torch.Tensor:
    """The symmetric 127-level scale of values whose largest |value| is
    ``amax``: ``where(amax > 0, amax, 1) / 127`` in fp32, the quotient
    rounded once. The divisor is a tensor beside ``amax``: CUDA multiplies by
    the reciprocal of a host scalar, which lands one ulp off the quotient
    the CPU and the JAX package compute."""
    a = torch.where(amax > 0, amax, 1.0)
    return a / torch.full_like(a, 127.0)


def quantize_queries(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization of fp32 queries, as the JAX binned
    route does: the row's :func:`int8_scale`, then round half to even and
    clip to +-127. Returns (int8 (B, D), scale (B,) f32)."""
    scale = int8_scale(q.abs().amax(dim=1))
    return torch.clamp(torch.round(q / scale[:, None]), -127, 127).to(torch.int8), scale


def _map_ids(pos: torch.Tensor, ids: Optional[torch.Tensor]) -> torch.Tensor:
    pos = pos.to(torch.int32)
    if ids is None:
        return pos
    return torch.where(pos >= 0, ids[pos.clamp_min(0).long()], torch.full_like(pos, -1))


def _check_k(k: int) -> None:
    if k < 1:
        raise ValueError(f"k must be positive, got {k}")


# ---------------------------------------------------------------------------
# K6: streaming exact top-k
# ---------------------------------------------------------------------------


def streaming_topk_plain(
    queries: torch.Tensor,
    candidates: torch.Tensor,
    k: int,
    ids: Optional[torch.Tensor] = None,
    n_valid: Optional[int] = None,
    tile: int = 4096,
    scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`streaming_topk`: score a tile, merge it into the
    running (B, k) list with a stable sort. The list starts as k entries
    (NEG_INF, -1) that rank before every candidate; rows at or past
    ``n_valid`` never rank."""
    B = queries.shape[0]
    c_real = candidates.shape[0] if n_valid is None else int(n_valid)
    best_s = torch.full((B, k), NEG_INF, dtype=torch.float32, device=queries.device)
    best_p = torch.full((B, k), -1, dtype=torch.int64, device=queries.device)
    for t0 in range(0, c_real, tile):
        t1 = min(t0 + tile, c_real)
        s = _scores(queries, candidates[t0:t1], None if scale is None else scale[t0:t1])
        pos = torch.arange(t0, t1, device=queries.device).expand(B, -1)
        new_s, order = stable_topk(torch.cat([best_s, s], dim=1), k)
        best_p = torch.gather(torch.cat([best_p, pos], dim=1), 1, order)
        best_s = new_s
    return best_s, _map_ids(best_p, ids)


def _streaming_lib():
    lib = kernels.load("streaming_topk")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.streaming_topk.argtypes = [p, p, i, p, p, p, p, p, p, i, i, i, i, i, p]
        lib.streaming_topk.restype = i
        lib.streaming_topk_splits.argtypes = [i, i, i, i, i]
        lib.streaming_topk_splits.restype = i
        pi = ctypes.POINTER(ctypes.c_int)
        lib.streaming_topk_plan.argtypes = [i, i, i, i, i, pi, pi, pi, pi]
        lib.streaming_topk_plan.restype = i
        lib._typed = True
    return lib


def streaming_plan(cand_dtype: torch.dtype, B: int, D: int, c_real: int, k: int) -> dict:
    """How :func:`streaming_topk` launches on the card for these shapes (a
    report; it builds the kernel): scoring warps a block, ring stages, whether
    the lists sit in shared memory, dynamic shared memory in bytes, splits."""
    lib = _streaming_lib()
    out = [ctypes.c_int() for _ in range(4)]
    code = _DTYPE_CODE[cand_dtype]
    kernels.check(lib, lib.streaming_topk_plan(code, B, D, c_real, k,
                                               *(ctypes.byref(x) for x in out)),
                  "streaming_topk_plan")
    splits = lib.streaming_topk_splits(code, B, D, c_real, k)
    if splits < 0:
        kernels.check(lib, -splits, "streaming_topk_splits")
    return {"warps": out[0].value, "stages": out[1].value, "lists_shared": bool(out[2].value),
            "smem": out[3].value, "splits": splits}


def _check_operands(queries, candidates, ids=None, scale=None, query_dtype=torch.float32):
    if queries.dtype != query_dtype or queries.ndim != 2 or not queries.is_contiguous():
        raise ValueError(f"queries must be a contiguous (B, D) {query_dtype} tensor")
    if candidates.dtype not in CAND_DTYPES or candidates.ndim != 2 \
            or not candidates.is_contiguous():
        raise ValueError("candidates must be a contiguous (C, D) float32, bfloat16 or int8 "
                         "tensor")
    if candidates.shape[1] != queries.shape[1]:
        raise ValueError(f"width mismatch: queries D={queries.shape[1]}, "
                         f"candidates D={candidates.shape[1]}")
    if candidates.device != queries.device:
        raise ValueError("queries and candidates lie on different devices")
    if ids is not None and (ids.dtype != torch.int32 or ids.shape != candidates.shape[:1]
                            or not ids.is_contiguous() or ids.device != queries.device):
        raise ValueError("ids must be a contiguous (C,) int32 tensor beside the candidates")
    if scale is not None and (scale.dtype != torch.float32 or scale.shape != candidates.shape[:1]
                              or not scale.is_contiguous() or scale.device != queries.device):
        raise ValueError("scale must be a contiguous (C,) float32 tensor beside the candidates")


def streaming_topk(
    queries: torch.Tensor,
    candidates: torch.Tensor,
    k: int,
    ids: Optional[torch.Tensor] = None,
    n_valid: Optional[int] = None,
    scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the whole catalog in one pass that never holds the
    (B, C) scores: (B, k) f32 scores and (B, k) int32 ids (positions when
    ``ids`` is None; -1 where fewer than k rows are valid). Candidates are
    float32, bfloat16 or int8; ``scale`` (C,) f32, where given, multiplies
    each row's fp32 score (the int8 index's dequantization).

    CUDA tensors go to the kernel of ``csrc/streaming_topk.cu``; CPU tensors to
    :func:`streaming_topk_plain`."""
    _check_k(k)
    _check_operands(queries, candidates, ids, scale)
    c_real = candidates.shape[0] if n_valid is None else int(n_valid)
    if not 0 <= c_real <= candidates.shape[0]:
        raise ValueError(f"n_valid={n_valid} outside [0, {candidates.shape[0]}]")
    if queries.device.type not in ("cuda", "cpu"):
        raise ValueError(f"streaming_topk runs on CUDA or the CPU, not {queries.device}")
    if torch.compiler.is_compiling():  # the trace holds the operator
        return torch.ops.models_tpu_torch.streaming_topk(queries, candidates, k, ids, c_real,
                                                         scale)
    if queries.device.type == "cpu":
        return streaming_topk_plain(queries, candidates, k, ids=ids, n_valid=c_real,
                                    scale=scale)
    return _streaming_topk_cuda(queries, candidates, k, ids, c_real, scale)


streaming_topk.launches = 0


@torch.library.custom_op("models_tpu_torch::streaming_topk", mutates_args=(),
                         device_types="cpu")
def _streaming_topk_op(queries: torch.Tensor, candidates: torch.Tensor, k: int,
                       ids: Optional[torch.Tensor], n_valid: int,
                       scale: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6 as an operator (what a traced program holds); on the CPU its plain
    version."""
    return streaming_topk_plain(queries, candidates, k, ids=ids, n_valid=n_valid, scale=scale)


@_streaming_topk_op.register_fake
def _(queries, candidates, k, ids, n_valid, scale):
    B = queries.shape[0]
    return (queries.new_empty((B, k), dtype=torch.float32),
            queries.new_empty((B, k), dtype=torch.int32))


@_streaming_topk_op.register_kernel("cuda")
def _streaming_topk_cuda(queries, candidates, k, ids, n_valid, scale):
    """The launch of ``csrc/streaming_topk.cu``: its split count planned
    from the shapes here, at run time."""
    c_real = n_valid
    B, D = queries.shape
    out_s = torch.empty((B, k), dtype=torch.float32, device=queries.device)
    out_i = torch.empty((B, k), dtype=torch.int32, device=queries.device)
    if B == 0:
        return out_s, out_i
    lib = _streaming_lib()
    code = _DTYPE_CODE[candidates.dtype]
    # the kernel cuts the catalog into splits that fill the card; each keeps a
    # sorted list of k per row, merged in split order
    splits = lib.streaming_topk_splits(code, B, D, c_real, k)
    if splits < 0:
        kernels.check(lib, -splits, "streaming_topk_splits")
    part_s = torch.empty((B, splits, k), dtype=torch.float32, device=queries.device)
    part_p = torch.empty((B, splits, k), dtype=torch.int32, device=queries.device)
    rc = lib.streaming_topk(
        queries.data_ptr(), candidates.data_ptr(), code,
        scale.data_ptr() if scale is not None else None,
        ids.data_ptr() if ids is not None else None,
        part_s.data_ptr(), part_p.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
        B, D, c_real, k, splits,
        torch.cuda.current_stream(queries.device).cuda_stream,
    )
    kernels.check(lib, rc, "streaming_topk")
    streaming_topk.launches += 1
    return out_s, out_i


# ---------------------------------------------------------------------------
# K5: binned phase-B rescore
# ---------------------------------------------------------------------------


def binned_rescore_plain(
    queries: torch.Tensor, candidates: torch.Tensor, bin_idx: torch.Tensor, bin_size: int
) -> torch.Tensor:
    """Plain version of :func:`binned_rescore`: gather the selected bins, then
    one einsum in fp32, or, for int8 operands, products and a sum in int64
    (CUDA has no integer einsum). (B, kb*bin_size) f32 or int32."""
    B, D = queries.shape
    c3 = candidates.view(-1, bin_size, D)
    gathered = c3[bin_idx.long()]  # (B, kb, bs, D)
    if candidates.dtype == torch.int8:
        dots = (gathered.long() * queries.long()[:, None, None, :]).sum(dim=-1)
        return dots.to(torch.int32).reshape(B, -1)
    return torch.einsum("bd,bksd->bks", queries, gathered.to(torch.float32)).reshape(B, -1)


def _rescore_lib():
    lib = kernels.load("binned_rescore")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.binned_rescore.argtypes = [p, p, i, p, p, i, i, i, i, i, p]
        lib.binned_rescore_route.argtypes = [p, p, i, i, i, i, i, i]
        lib.binned_rescore_grid.argtypes = [i, i, i, i]
        lib.binned_rescore_const.argtypes = [i]
        for fn in (lib.binned_rescore, lib.binned_rescore_route, lib.binned_rescore_grid,
                   lib.binned_rescore_const):
            fn.restype = i
        lib._typed = True
    return lib


def rescore_plan(queries: torch.Tensor, candidates: torch.Tensor, bin_idx: torch.Tensor,
                 bin_size: int) -> dict:
    """How :func:`binned_rescore` launches on the card for these CUDA operands:
    ``route`` ``"bins"`` (``rescore_bins``: bin-major, each selected bin
    copied once a group of query rows by a bulk copy and scored against
    every query of the group that picked it) or ``"rows"`` (the first
    design, a block per query row: bins other than 64 rows, rows not whole
    16-byte pieces or past 512 bytes, unaligned pointers), and for
    ``"bins"`` the arguments of :func:`rescore_schedule`:
    the grid's ``blocks``, the selections a block scans at a time
    (``window``), the query rows of a group (``query_group``) and the pairs
    of an item (``pairs_per_item``)."""
    lib = _rescore_lib()
    (B, D), kb = queries.shape, bin_idx.shape[1]
    code, n_bins = _DTYPE_CODE[candidates.dtype], candidates.shape[0] // bin_size
    by_bins = lib.binned_rescore_route(queries.data_ptr(), candidates.data_ptr(), code, B, D, kb,
                                       bin_size, n_bins)
    if by_bins < 0:
        kernels.check(lib, -by_bins, "binned_rescore_route")
    if not by_bins:
        return {"route": "rows"}
    blocks = lib.binned_rescore_grid(code, B, D, n_bins)
    if blocks < 0:
        kernels.check(lib, -blocks, "binned_rescore_grid")
    return {"route": "bins", "blocks": blocks, "window": lib.binned_rescore_const(0),
            "query_group": lib.binned_rescore_const(1),
            "pairs_per_item": lib.binned_rescore_const(2)}


def rescore_schedule(bin_idx: torch.Tensor, n_bins: int, blocks: int, window: int = 4096,
                     query_group: int = 32, pairs_per_item: int = 8):
    """The bin-major form's schedule (``csrc/binned_rescore.cu::rescore_bins``),
    modelled on the host. The selections ``bin_idx`` (B, kb) are pairs at flat
    positions ``e = b * kb + j``; the pairs of bin ``n`` from query rows of
    group ``h = b // query_group`` form key ``n * ceil(B / query_group) +
    h``, and block ``g`` of ``blocks`` owns the keys ``key % blocks == g``.
    A block scans the pairs ``window`` at a time; within a window it takes
    its keys in ascending order, each as items of at most ``pairs_per_item``
    pairs, and each item is one copy of the bin (and of its pairs' query
    rows). Returns (``plan``, ``missing``): ``plan[g]`` holds one list per
    window of the block's items ``(bin, positions)``; ``missing`` the
    positions of bins outside ``[0, n_bins)``, which block 0 fills (NaN or
    INT32_MIN). Within a key the kernel takes the pairs in any order: each
    has one writer."""
    B, kb = bin_idx.shape
    groups = -(-B // query_group)
    flat = bin_idx.reshape(-1).tolist()
    plan, missing = [[] for _ in range(blocks)], []
    for w0 in range(0, len(flat), window):
        keys = {}
        for e in range(w0, min(w0 + window, len(flat))):
            n = flat[e]
            if 0 <= n < n_bins:
                keys.setdefault(n * groups + e // kb // query_group, []).append(e)
            else:
                missing.append(e)
        for g in range(blocks):
            plan[g].append([(key // groups, pairs[i:i + pairs_per_item])
                            for key, pairs in sorted(keys.items()) if key % blocks == g
                            for i in range(0, len(pairs), pairs_per_item)])
    return plan, missing


def binned_rescore(
    queries: torch.Tensor, candidates: torch.Tensor, bin_idx: torch.Tensor, bin_size: int
) -> torch.Tensor:
    """Dot each query row with every row of its selected bins: queries (B, D)
    f32, candidates (L*bin_size, D) f32 or bf16, bin_idx (B, kb) int32 in
    [0, L) -> (B, kb*bin_size) f32, bin j's rows at columns j*bin_size...
    For int8 candidates the queries are int8 too and the result is the exact
    int32 dot (the int8 index's phase B).

    CUDA tensors go to the kernel of ``csrc/binned_rescore.cu``; CPU tensors to
    :func:`binned_rescore_plain`."""
    is_int = candidates.dtype == torch.int8
    _check_operands(queries, candidates, query_dtype=torch.int8 if is_int else torch.float32)
    if candidates.shape[0] % bin_size:
        raise ValueError(f"candidates rows {candidates.shape[0]} not a multiple of {bin_size}")
    if bin_idx.dtype != torch.int32 or bin_idx.ndim != 2 or not bin_idx.is_contiguous() \
            or bin_idx.shape[0] != queries.shape[0] or bin_idx.device != queries.device:
        raise ValueError("bin_idx must be a contiguous (B, kb) int32 tensor beside the queries")
    if queries.device.type not in ("cuda", "cpu"):
        raise ValueError(f"binned_rescore runs on CUDA or the CPU, not {queries.device}")
    if torch.compiler.is_compiling():  # the trace holds the operator
        return torch.ops.models_tpu_torch.binned_rescore(queries, candidates, bin_idx, bin_size)
    if queries.device.type == "cpu":
        return binned_rescore_plain(queries, candidates, bin_idx, bin_size)
    return _binned_rescore_cuda(queries, candidates, bin_idx, bin_size)


binned_rescore.launches = 0


@torch.library.custom_op("models_tpu_torch::binned_rescore", mutates_args=(),
                         device_types="cpu")
def _binned_rescore_op(queries: torch.Tensor, candidates: torch.Tensor, bin_idx: torch.Tensor,
                       bin_size: int) -> torch.Tensor:
    """K5 as an operator (what a traced program holds); on the CPU its plain
    version."""
    return binned_rescore_plain(queries, candidates, bin_idx, bin_size)


@_binned_rescore_op.register_fake
def _(queries, candidates, bin_idx, bin_size):
    return queries.new_empty(
        (queries.shape[0], bin_idx.shape[1] * bin_size),
        dtype=torch.int32 if candidates.dtype == torch.int8 else torch.float32)


@_binned_rescore_op.register_kernel("cuda")
def _binned_rescore_cuda(queries, candidates, bin_idx, bin_size):
    """The launch of ``csrc/binned_rescore.cu`` (its route and grid chosen
    from the shapes and pointers there, at run time)."""
    is_int = candidates.dtype == torch.int8
    B, D = queries.shape
    kb = bin_idx.shape[1]
    out = torch.empty((B, kb * bin_size), dtype=torch.int32 if is_int else torch.float32,
                      device=queries.device)
    if B == 0 or kb == 0:
        return out
    lib = _rescore_lib()
    rc = lib.binned_rescore(
        queries.data_ptr(), candidates.data_ptr(), _DTYPE_CODE[candidates.dtype],
        bin_idx.data_ptr(), out.data_ptr(), B, D, kb, bin_size,
        candidates.shape[0] // bin_size,
        torch.cuda.current_stream(queries.device).cuda_stream,
    )
    kernels.check(lib, rc, "binned_rescore")
    binned_rescore.launches += 1
    return out


# ---------------------------------------------------------------------------
# the top-k functions
# ---------------------------------------------------------------------------


def _prepare(queries, candidates, ids, device, col_scale=None):
    dev = resolve_device(device)
    q = torch.as_tensor(queries, device=dev).to(torch.float32).contiguous()
    c = torch.as_tensor(candidates, device=dev)
    if c.dtype not in CAND_DTYPES:
        raise ValueError(f"candidates must be float32, bfloat16 or int8, not {c.dtype}")
    c = c.contiguous()
    if ids is not None:
        ids = torch.as_tensor(ids, device=dev).to(torch.int32).contiguous()
    if col_scale is not None:
        col_scale = torch.as_tensor(col_scale, device=dev).to(torch.float32).contiguous()
    return q, c, ids, col_scale


def _blockwise(q, c, k, ids, tile, col_scale=None):
    _check_k(k)
    return streaming_topk_plain(q, c, k, ids=ids, tile=tile, scale=col_scale)


def blockwise_topk(queries, candidates, k: int, ids=None, tile: int = 4096, col_scale=None,
                   device=None):
    """Exact top-k, tile by tile, without the (B, C) score matrix: the plain
    PyTorch route. ``col_scale`` (C,) f32 multiplies each row's score (the
    int8 index). Returns (scores (B, k) f32, ids (B, k) int32)."""
    q, c, ids, col_scale = _prepare(queries, candidates, ids, device, col_scale)
    return _blockwise(q, c, k, ids, tile, col_scale)


def _bin_scales(col_scale: torch.Tensor, L: int, bin_size: int) -> torch.Tensor:
    """(L,) the scale of each full bin, read from its first row."""
    return col_scale[: L * bin_size].view(L, bin_size)[:, 0]


def select_bins(q: torch.Tensor, full: torch.Tensor, k: int, bin_size: int = _BINNED_BIN_SIZE,
                bin_margin: int = _BINNED_MARGIN, n_valid: Optional[int] = None,
                col_scale: Optional[torch.Tensor] = None,
                col_scale_per_bin: bool = False) -> torch.Tensor:
    """Phase A of the binned top-k over the full bins ``full`` (L*bin_size, D):
    score every row, keep each bin's max, and return the (B, kb) int32 indices
    of the best ``kb = k + margin`` bins (one more when padding may inflate
    the last bin's max). For an int8 catalog ``q`` is the int8 queries and
    the product exact int32; a per-bin scale multiplies the (B, L) bin maxima,
    a per-row scale every score before the max."""
    B = q.shape[0]
    L = full.shape[0] // bin_size
    if full.dtype == torch.int8:
        raw = _int_scores(q, full)
    else:
        raw = _scores(q, full)
    raw = raw.view(B, L, bin_size)
    if col_scale is not None and col_scale_per_bin:
        bin_max = raw.amax(dim=2).to(torch.float32) * _bin_scales(col_scale, L, bin_size)[None]
    else:
        s = raw.to(torch.float32)
        if col_scale is not None:
            s = s * col_scale[: L * bin_size].view(1, L, bin_size)
        bin_max = s.amax(dim=2)
    mask_pad = n_valid is not None and n_valid < L * bin_size
    kb = min(k + bin_margin + (1 if mask_pad else 0), L)
    _, bin_idx = stable_topk(bin_max, kb)
    return bin_idx.to(torch.int32).contiguous()


def _dequant(raw: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    s = raw.to(torch.float32)
    return s if scale is None else s * scale


def _binned(q, c, k, ids, bin_size, bin_margin, n_valid, col_scale=None,
            col_scale_per_bin=False):
    _check_k(k)
    B, D = q.shape
    C = c.shape[0]
    L = C // bin_size  # full bins
    r = C - L * bin_size  # tail rows
    is_int = c.dtype == torch.int8
    q_scale = None
    if is_int:
        # the dots become int8 x int8 -> int32; the query's positive scale
        # commutes with every per-row max and top-k, so it scales only the
        # final (B, k)
        q, q_scale = quantize_queries(q)
        if col_scale is None:
            col_scale = torch.ones(C, dtype=torch.float32, device=q.device)
            col_scale_per_bin = True  # constant scales are bin-constant

    def product(rows):
        return _int_scores(q, rows) if is_int else _scores(q, rows)

    def final(s):
        return s if q_scale is None else s * q_scale[:, None]

    if L <= k:
        scores = _dequant(product(c), None if col_scale is None else col_scale[None, :])
        if n_valid is not None and n_valid < C:
            col = torch.arange(C, device=q.device)[None, :]
            scores = torch.where(col < n_valid, scores, NEG_INF)
        s, pos = stable_topk(scores, k)
        return final(s), _map_ids(pos, ids)

    full = c[: L * bin_size]
    mask_pad = n_valid is not None and n_valid < L * bin_size
    bin_idx = select_bins(q, full, k, bin_size, bin_margin, n_valid, col_scale,
                          col_scale_per_bin)
    kb = bin_idx.shape[1]

    # phase B: rescore the rows of the selected bins only
    csel = None
    if col_scale is not None and col_scale_per_bin:
        csel = _bin_scales(col_scale, L, bin_size)[bin_idx.long()][:, :, None]
        csel = csel.expand(B, kb, bin_size).reshape(B, -1)
    elif col_scale is not None:
        csel = col_scale[: L * bin_size].view(L, bin_size)[bin_idx.long()].reshape(B, -1)
    pool = _dequant(binned_rescore(q, full, bin_idx, bin_size), csel)
    cols = (bin_idx.long()[:, :, None] * bin_size
            + torch.arange(bin_size, device=q.device)[None, None, :]).reshape(B, -1)
    if mask_pad:
        pool = torch.where(cols < n_valid, pool, NEG_INF)
    if r:
        s_tail = _dequant(product(c[L * bin_size:]),
                          None if col_scale is None else col_scale[None, L * bin_size:])
        tail_cols = torch.arange(L * bin_size, C, device=q.device)[None, :]
        if n_valid is not None and n_valid < C:
            s_tail = torch.where(tail_cols < n_valid, s_tail, NEG_INF)
        pool = torch.cat([pool, s_tail], dim=1)
        cols = torch.cat([cols, tail_cols.expand(B, -1)], dim=1)
    top_s, top_p = stable_topk(pool, k)
    return final(top_s), _map_ids(torch.gather(cols, 1, top_p), ids)


def binned_topk(
    queries,
    candidates,
    k: int,
    ids=None,
    bin_size: int = _BINNED_BIN_SIZE,
    bin_margin: int = _BINNED_MARGIN,
    n_valid: Optional[int] = None,
    col_scale=None,
    col_scale_per_bin: bool = False,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact two-phase top-k (see the JAX docstring for the proof).

    Every row above the true k-th score θ lies in a bin whose max exceeds θ,
    and at most k-1 bins have one, so the k best bins by max hold them all.
    The proof needs both phases to score alike; phase A (a cuBLAS product) and
    phase B may round differently in the last bit, which the ``bin_margin``
    extra bins absorb. ``n_valid`` masks rows padded at index build. Phase B
    is :func:`binned_rescore`; the JAX option ``pallas_rescore``, which picks
    between two phase-B paths on the TPU, has no counterpart.

    ``col_scale`` (C,) f32: each row's dequantization scale (the int8 index).
    For an int8 catalog the queries are quantized per row and both phases
    score in exact int32, so they agree bit for bit and the result is the
    JAX package's, ids and scores. ``col_scale_per_bin`` asserts the scale
    is constant within each bin (the bin-quantized index): the bin max is
    then taken in int32 and scaled once per bin."""
    q, c, ids, col_scale = _prepare(queries, candidates, ids, device, col_scale)
    return _binned(q, c, k, ids, bin_size, bin_margin, n_valid, col_scale, col_scale_per_bin)


def topk_route(B: int, C: int, D: int, k: int, tile: int = 4096,
               method: str = "auto", on_cuda: bool = False) -> str:
    """The route :func:`topk_scores` takes: the JAX dispatch, with "on the
    TPU" read as "the tensors lie on the card". ``method``: 'auto', or one of
    'binned' | 'streaming' | 'blockwise' to force it. The JAX package sends
    a scaled (int8) catalog to its blockwise scan even on the TPU; the
    streaming kernel computes that scan's function, scales included, so the
    card takes it for every catalog dtype."""
    if method not in ("auto", "binned", "streaming", "blockwise"):
        raise ValueError(f"unknown method {method!r}")
    if method == "auto" and C <= tile:
        return "direct"
    # binned phase B gathers (B, k+margin bins, bin_size, D) f32 candidates
    pool_bytes = B * (k + _BINNED_MARGIN) * _BINNED_BIN_SIZE * D * 4
    if method == "binned" or (method == "auto" and pool_bytes <= _BINNED_POOL_BYTES):
        return "binned"
    if method == "streaming" or (method == "auto" and on_cuda):
        return "streaming"
    return "blockwise"


def topk_scores(
    queries,
    candidates,
    k: int,
    ids=None,
    tile: int = 4096,
    method: str = "auto",
    n_valid: Optional[int] = None,
    col_scale=None,
    col_scale_per_bin: bool = False,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``queries @ candidates.T`` by the route of :func:`topk_route`.
    ``n_valid``: real row count when ``candidates`` was padded at index build.
    ``col_scale`` / ``col_scale_per_bin``: the int8 index's dequantization
    scales (see :func:`binned_topk`). Returns (scores (B, k) f32, ids (B, k)
    int32)."""
    q, c, ids, col_scale = _prepare(queries, candidates, ids, device, col_scale)
    _check_k(k)
    B, D = q.shape
    C = c.shape[0]
    padded = n_valid is not None and n_valid < C
    route = topk_route(B, C, D, k, tile, method, q.device.type == "cuda")
    if route == "direct":
        if k > C:
            raise ValueError(f"k={k} exceeds the {C} candidates")
        scores = _scores(q, c, col_scale)
        if padded:
            scores = torch.where(torch.arange(C, device=q.device)[None, :] < n_valid,
                                 scores, NEG_INF)
        s, pos = stable_topk(scores, k)
        return s, _map_ids(pos, ids)
    if route == "binned":
        return _binned(q, c, k, ids, _BINNED_BIN_SIZE, _BINNED_MARGIN, n_valid, col_scale,
                       col_scale_per_bin)
    if padded:  # the streaming routes score every row: drop the padding
        c = c[:n_valid]
        ids = ids[:n_valid] if ids is not None else None
        col_scale = col_scale[:n_valid] if col_scale is not None else None
    if route == "streaming":
        return streaming_topk(q, c, k, ids=ids, scale=col_scale)
    return _blockwise(q, c, k, ids, tile, col_scale)


def sharded_topk(queries, candidates: torch.Tensor, k: int, mesh, axis: str = "model",
                 ids: Optional[torch.Tensor] = None, tile: int = 4096,
                 col_scale: Optional[torch.Tensor] = None,
                 col_scale_per_bin: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a catalog split by rows over ``axis`` (``models_tpu/ops/
    topk.py::sharded_topk``): ``candidates`` is this rank's contiguous shard
    (C/n, D), ``ids`` its ids (default the global positions), ``col_scale``
    its rows' scales (the int8 index); the queries are the same on every
    rank of the model line. Each rank takes the single-card route on its
    shard: binned (phase B in K5) where the shard has more than 128 k rows,
    as the JAX package's, and where the binned pool holds (the single-card
    bound, ``topk_route``: at 1M x 128 and k = 10 a 4096-row batch would
    gather a 1.6 GB pool), else the streaming K6 (its plain version on the
    CPU). Then the (B, k) lists are all-gathered over the line and merged:
    ties go to the lowest global position, since the shards are contiguous
    and each list ranks by (score desc, position asc). Only (B, k) scores
    and ids move between ranks."""
    from ..parallel.collectives import all_gather

    g = mesh.group(axis)
    q, c, ids, col_scale = _prepare(queries, candidates, ids, candidates.device, col_scale)
    _check_k(k)
    C = c.shape[0]
    if ids is None:
        ids = torch.arange(C, dtype=torch.int32, device=c.device) + g.index * C
    pool_bytes = q.shape[0] * (k + _BINNED_MARGIN) * _BINNED_BIN_SIZE * q.shape[1] * 4
    if C // 128 > k and pool_bytes <= _BINNED_POOL_BYTES:
        s, i = _binned(q, c, k, ids, _BINNED_BIN_SIZE, _BINNED_MARGIN, None, col_scale,
                       col_scale_per_bin)
    else:
        if k > C:
            raise ValueError(f"k={k} exceeds the shard's {C} candidates")
        s, i = streaming_topk(q, c, k, ids=ids, scale=col_scale)
    if g.size == 1:
        return s, i
    B = q.shape[0]
    all_s = all_gather(s.contiguous(), g).view(g.size, B, k).transpose(0, 1).reshape(B, -1)
    all_i = all_gather(i.contiguous(), g).view(g.size, B, k).transpose(0, 1).reshape(B, -1)
    best_s, pos = stable_topk(all_s, k)
    return best_s, torch.gather(all_i, 1, pos)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def ids_agree(s_a, i_a, s_b, i_b, tol: float) -> bool:
    """Two top-k results agree when their scores agree within ``tol`` and
    their ids are equal except inside a near-tie: where the score lies within
    ``tol`` of a neighbour in its list, or of the k-th score (two summation
    orders may swap such candidates, or one may edge the other out)."""
    s_a, s_b = np.asarray(s_a, np.float64), np.asarray(s_b, np.float64)
    if s_a.shape != s_b.shape or np.abs(s_a - s_b).max(initial=0.0) > tol:
        return False
    differ = np.asarray(i_a) != np.asarray(i_b)
    near = np.abs(s_a - s_a[:, -1:]) <= tol
    tie = np.abs(s_a[:, 1:] - s_a[:, :-1]) <= tol
    near[:, 1:] |= tie
    near[:, :-1] |= tie
    return bool(np.all(~differ | near))
