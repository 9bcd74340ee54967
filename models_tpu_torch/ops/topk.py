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
- ``blockwise``: the same function in plain PyTorch, tile by tile, elsewhere.

Every selection ranks by (score descending, position ascending), the order of
``lax.top_k``. Scores are fp32 for fp32 and bf16 catalogs alike, as JAX
promotes an f32 x bf16 product to f32. A padded row scores ``NEG_INF``, the
float32 minimum, not ``-inf``.

A kernel wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from . import kernels

NEG_INF = torch.finfo(torch.float32).min
_BINNED_BIN_SIZE = 64
_BINNED_MARGIN = 2
_BINNED_POOL_BYTES = 512 * 2**20

# streaming kernel geometry (csrc/streaming_topk.cu)
_QB, _TC = 32, 128


def _top(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """k best per row by (score desc, position asc): a stable descending sort."""
    s, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return s[:, :k], idx[:, :k]


def _scores(queries: torch.Tensor, candidates: torch.Tensor) -> torch.Tensor:
    return queries @ candidates.to(torch.float32).T


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
        s = _scores(queries, candidates[t0:t1])
        pos = torch.arange(t0, t1, device=queries.device).expand(B, -1)
        new_s, order = _top(torch.cat([best_s, s], dim=1), k)
        best_p = torch.gather(torch.cat([best_p, pos], dim=1), 1, order)
        best_s = new_s
    return best_s, _map_ids(best_p, ids)


def _streaming_lib():
    lib = kernels.load("streaming_topk")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.streaming_topk.argtypes = [p, p, i, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.streaming_topk.restype = i
        lib.streaming_topk_kmax.restype = i
        lib.streaming_topk_splits_max.restype = i
        lib._typed = True
    return lib


def _check_operands(queries, candidates, ids=None):
    if queries.dtype != torch.float32 or queries.ndim != 2 or not queries.is_contiguous():
        raise ValueError("queries must be a contiguous (B, D) float32 tensor")
    if candidates.dtype not in (torch.float32, torch.bfloat16) or candidates.ndim != 2 \
            or not candidates.is_contiguous():
        raise ValueError("candidates must be a contiguous (C, D) float32 or bfloat16 tensor")
    if candidates.shape[1] != queries.shape[1]:
        raise ValueError(f"width mismatch: queries D={queries.shape[1]}, "
                         f"candidates D={candidates.shape[1]}")
    if candidates.device != queries.device:
        raise ValueError("queries and candidates lie on different devices")
    if ids is not None and (ids.dtype != torch.int32 or ids.shape != candidates.shape[:1]
                            or not ids.is_contiguous() or ids.device != queries.device):
        raise ValueError("ids must be a contiguous (C,) int32 tensor beside the candidates")


def streaming_topk(
    queries: torch.Tensor,
    candidates: torch.Tensor,
    k: int,
    ids: Optional[torch.Tensor] = None,
    n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the whole catalog in one pass that never holds the
    (B, C) scores: (B, k) f32 scores and (B, k) int32 ids (positions when
    ``ids`` is None; -1 where fewer than k rows are valid).

    CUDA tensors go to the kernel of ``csrc/streaming_topk.cu``; CPU tensors to
    :func:`streaming_topk_plain`."""
    _check_k(k)
    _check_operands(queries, candidates, ids)
    c_real = candidates.shape[0] if n_valid is None else int(n_valid)
    if not 0 <= c_real <= candidates.shape[0]:
        raise ValueError(f"n_valid={n_valid} outside [0, {candidates.shape[0]}]")
    if queries.device.type == "cpu":
        return streaming_topk_plain(queries, candidates, k, ids=ids, n_valid=c_real)
    if queries.device.type != "cuda":
        raise ValueError(f"streaming_topk runs on CUDA or the CPU, not {queries.device}")
    lib = _streaming_lib()
    kmax = lib.streaming_topk_kmax()
    if k > kmax:
        raise ValueError(f"streaming_topk holds at most k={kmax} per row; got k={k}")
    B, D = queries.shape
    out_s = torch.empty((B, k), dtype=torch.float32, device=queries.device)
    out_i = torch.empty((B, k), dtype=torch.int32, device=queries.device)
    if B == 0:
        return out_s, out_i
    # cut the catalog into splits so that about four blocks per SM run
    sms = torch.cuda.get_device_properties(queries.device).multi_processor_count
    row_blocks = -(-B // _QB)
    tiles = max(1, -(-c_real // _TC))
    splits = max(1, min(lib.streaming_topk_splits_max(), tiles, -(-4 * sms // row_blocks)))
    chunk = -(-tiles // splits) * _TC
    splits = max(1, -(-c_real // chunk))
    part_s = torch.empty((B, splits, k), dtype=torch.float32, device=queries.device)
    part_p = torch.empty((B, splits, k), dtype=torch.int32, device=queries.device)
    rc = lib.streaming_topk(
        queries.data_ptr(), candidates.data_ptr(), int(candidates.dtype == torch.bfloat16),
        ids.data_ptr() if ids is not None else None,
        part_s.data_ptr(), part_p.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
        B, D, c_real, k, chunk, splits,
        torch.cuda.current_stream(queries.device).cuda_stream,
    )
    kernels.check(lib, rc, "streaming_topk")
    streaming_topk.launches += 1
    return out_s, out_i


streaming_topk.launches = 0


# ---------------------------------------------------------------------------
# K5: binned phase-B rescore
# ---------------------------------------------------------------------------


def binned_rescore_plain(
    queries: torch.Tensor, candidates: torch.Tensor, bin_idx: torch.Tensor, bin_size: int
) -> torch.Tensor:
    """Plain version of :func:`binned_rescore`: gather the selected bins, then
    one einsum. (B, kb*bin_size) f32."""
    B, D = queries.shape
    c3 = candidates.view(-1, bin_size, D)
    gathered = c3[bin_idx.long()].to(torch.float32)  # (B, kb, bs, D)
    return torch.einsum("bd,bksd->bks", queries, gathered).reshape(B, -1)


def _rescore_lib():
    lib = kernels.load("binned_rescore")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.binned_rescore.argtypes = [p, p, i, p, p, i, i, i, i, i, p]
        lib.binned_rescore.restype = i
        lib._typed = True
    return lib


def binned_rescore(
    queries: torch.Tensor, candidates: torch.Tensor, bin_idx: torch.Tensor, bin_size: int
) -> torch.Tensor:
    """Dot each query row with every row of its selected bins: queries (B, D)
    f32, candidates (L*bin_size, D) f32 or bf16, bin_idx (B, kb) int32 in
    [0, L) -> (B, kb*bin_size) f32, bin j's rows at columns j*bin_size...

    CUDA tensors go to the kernel of ``csrc/binned_rescore.cu``; CPU tensors to
    :func:`binned_rescore_plain`."""
    _check_operands(queries, candidates)
    if candidates.shape[0] % bin_size:
        raise ValueError(f"candidates rows {candidates.shape[0]} not a multiple of {bin_size}")
    if bin_idx.dtype != torch.int32 or bin_idx.ndim != 2 or not bin_idx.is_contiguous() \
            or bin_idx.shape[0] != queries.shape[0] or bin_idx.device != queries.device:
        raise ValueError("bin_idx must be a contiguous (B, kb) int32 tensor beside the queries")
    if queries.device.type == "cpu":
        return binned_rescore_plain(queries, candidates, bin_idx, bin_size)
    if queries.device.type != "cuda":
        raise ValueError(f"binned_rescore runs on CUDA or the CPU, not {queries.device}")
    B, D = queries.shape
    kb = bin_idx.shape[1]
    out = torch.empty((B, kb * bin_size), dtype=torch.float32, device=queries.device)
    if B == 0 or kb == 0:
        return out
    lib = _rescore_lib()
    rc = lib.binned_rescore(
        queries.data_ptr(), candidates.data_ptr(), int(candidates.dtype == torch.bfloat16),
        bin_idx.data_ptr(), out.data_ptr(), B, D, kb, bin_size,
        candidates.shape[0] // bin_size,
        torch.cuda.current_stream(queries.device).cuda_stream,
    )
    kernels.check(lib, rc, "binned_rescore")
    binned_rescore.launches += 1
    return out


binned_rescore.launches = 0


# ---------------------------------------------------------------------------
# the top-k functions
# ---------------------------------------------------------------------------


def _prepare(queries, candidates, ids, device):
    dev = resolve_device(device)
    q = torch.as_tensor(queries, device=dev).to(torch.float32).contiguous()
    c = torch.as_tensor(candidates, device=dev)
    if c.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"candidates must be float32 or bfloat16, not {c.dtype} "
                         "(the int8 index is not ported yet)")
    c = c.contiguous()
    if ids is not None:
        ids = torch.as_tensor(ids, device=dev).to(torch.int32).contiguous()
    return q, c, ids


def _blockwise(q, c, k, ids, tile):
    _check_k(k)
    return streaming_topk_plain(q, c, k, ids=ids, tile=tile)


def blockwise_topk(queries, candidates, k: int, ids=None, tile: int = 4096, device=None):
    """Exact top-k, tile by tile, without the (B, C) score matrix: the plain
    PyTorch route. Returns (scores (B, k) f32, ids (B, k) int32)."""
    q, c, ids = _prepare(queries, candidates, ids, device)
    return _blockwise(q, c, k, ids, tile)


def select_bins(q: torch.Tensor, full: torch.Tensor, k: int, bin_size: int = _BINNED_BIN_SIZE,
                bin_margin: int = _BINNED_MARGIN, n_valid: Optional[int] = None) -> torch.Tensor:
    """Phase A of the binned top-k over the full bins ``full`` (L*bin_size, D):
    score every row, keep each bin's max, and return the (B, kb) int32 indices
    of the best ``kb = k + margin`` bins (one more when padding may inflate
    the last bin's max)."""
    B = q.shape[0]
    L = full.shape[0] // bin_size
    bin_max = _scores(q, full).view(B, L, bin_size).amax(dim=2)
    mask_pad = n_valid is not None and n_valid < L * bin_size
    kb = min(k + bin_margin + (1 if mask_pad else 0), L)
    _, bin_idx = _top(bin_max, kb)
    return bin_idx.to(torch.int32).contiguous()


def _binned(q, c, k, ids, bin_size, bin_margin, n_valid):
    _check_k(k)
    B, D = q.shape
    C = c.shape[0]
    L = C // bin_size  # full bins
    r = C - L * bin_size  # tail rows
    if L <= k:
        scores = _scores(q, c)
        if n_valid is not None and n_valid < C:
            col = torch.arange(C, device=q.device)[None, :]
            scores = torch.where(col < n_valid, scores, NEG_INF)
        s, pos = _top(scores, min(k, C))
        return s, _map_ids(pos, ids)

    full = c[: L * bin_size]
    mask_pad = n_valid is not None and n_valid < L * bin_size
    bin_idx = select_bins(q, full, k, bin_size, bin_margin, n_valid)

    # phase B: rescore the rows of the selected bins only
    pool = binned_rescore(q, full, bin_idx, bin_size)
    cols = (bin_idx.long()[:, :, None] * bin_size
            + torch.arange(bin_size, device=q.device)[None, None, :]).reshape(B, -1)
    if mask_pad:
        pool = torch.where(cols < n_valid, pool, NEG_INF)
    if r:
        s_tail = _scores(q, c[L * bin_size:])
        tail_cols = torch.arange(L * bin_size, C, device=q.device)[None, :]
        if n_valid is not None and n_valid < C:
            s_tail = torch.where(tail_cols < n_valid, s_tail, NEG_INF)
        pool = torch.cat([pool, s_tail], dim=1)
        cols = torch.cat([cols, tail_cols.expand(B, -1)], dim=1)
    top_s, top_p = _top(pool, k)
    return top_s, _map_ids(torch.gather(cols, 1, top_p), ids)


def binned_topk(
    queries,
    candidates,
    k: int,
    ids=None,
    bin_size: int = _BINNED_BIN_SIZE,
    bin_margin: int = _BINNED_MARGIN,
    n_valid: Optional[int] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact two-phase top-k (see the JAX docstring for the proof).

    Every row above the true k-th score θ lies in a bin whose max exceeds θ,
    and at most k-1 bins have one, so the k best bins by max hold them all.
    The proof needs both phases to score alike; phase A (a cuBLAS product) and
    phase B may round differently in the last bit, which the ``bin_margin``
    extra bins absorb. ``n_valid`` masks rows padded at index build. Phase B
    is :func:`binned_rescore`; the JAX option ``pallas_rescore``, which picks
    between two phase-B paths on the TPU, has no counterpart."""
    q, c, ids = _prepare(queries, candidates, ids, device)
    return _binned(q, c, k, ids, bin_size, bin_margin, n_valid)


def topk_route(B: int, C: int, D: int, k: int, tile: int = 4096,
               method: str = "auto", on_cuda: bool = False) -> str:
    """The route :func:`topk_scores` takes: the JAX dispatch, with "on the
    TPU" read as "the tensors lie on the card". ``method``: 'auto', or one of
    'binned' | 'streaming' | 'blockwise' to force it."""
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
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``queries @ candidates.T`` by the route of :func:`topk_route`.
    ``n_valid``: real row count when ``candidates`` was padded at index build.
    Returns (scores (B, k) f32, ids (B, k) int32)."""
    q, c, ids = _prepare(queries, candidates, ids, device)
    _check_k(k)
    B, D = q.shape
    C = c.shape[0]
    padded = n_valid is not None and n_valid < C
    route = topk_route(B, C, D, k, tile, method, q.device.type == "cuda")
    if route == "direct":
        if k > C:
            raise ValueError(f"k={k} exceeds the {C} candidates")
        scores = _scores(q, c)
        if padded:
            scores = torch.where(torch.arange(C, device=q.device)[None, :] < n_valid,
                                 scores, NEG_INF)
        s, pos = _top(scores, k)
        return s, _map_ids(pos, ids)
    if route == "binned":
        return _binned(q, c, k, ids, _BINNED_BIN_SIZE, _BINNED_MARGIN, n_valid)
    if padded:  # the streaming routes score every row: drop the padding
        c = c[:n_valid]
        ids = ids[:n_valid] if ids is not None else None
    if route == "streaming":
        return streaming_topk(q, c, k, ids=ids)
    return _blockwise(q, c, k, ids, tile)


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
