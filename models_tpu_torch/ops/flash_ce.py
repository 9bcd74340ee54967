"""Flash sampled-softmax cross-entropy kernels (``models_tpu/ops/flash_ce.py``).

For query row i and negative row j the logit is ``(q_i . neg_j + bias_j) / T``,
with ``MIN_FLOAT`` in place of the sum before the division where
``downscore`` is set and ``neg_id[j] == pos_id[i]``:

- :func:`lse_forward` (K1): the online (max, sum) over all negatives, seeded
  by the positive logit: ``m_i = max(pos_i, max_j x_ij)``,
  ``s_i = exp(pos_i - m_i) + sum_j exp(x_ij - m_i)``;
- :func:`grad_query` (K2): ``dq_i = sum_j gw_i exp(x_ij - lse_i) / T * neg_j``;
- :func:`grad_neg` (K3): ``dneg_j = sum_i gw_i exp(x_ij - lse_i) / T * q_i``.

None of them writes the (Q, N) logits. CUDA tensors go to the kernels of
``csrc/flash_ce.cu``; CPU tensors to the plain versions, which walk the
negatives tile by tile in the order of the JAX scan (``ops/contrastive.py``).
On the card K2 and K3 compute both products on the tensor cores as 3xTF32
(near fp32's error), K1 in fp32 FMAs. Inputs are float32: bf16 operands wait
for the mixed-precision slice.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..core.constants import MIN_FLOAT
from . import kernels

TILE = 2048  # negatives per step of the plain versions


def _tile_logits(query, neg_t, pos_id, neg_id_t, bias_t, temperature, downscore):
    s = query @ neg_t.T
    if bias_t is not None:
        s = s + bias_t[None, :]
    if downscore and pos_id is not None and neg_id_t is not None:
        s = torch.where(neg_id_t[None, :] == pos_id[:, None], MIN_FLOAT, s)
    return s / temperature


def _tiles(neg_emb, neg_id, bias, tile):
    for t0 in range(0, neg_emb.shape[0], tile):
        t1 = t0 + tile
        yield (t0, t1, neg_emb[t0:t1], None if neg_id is None else neg_id[t0:t1],
               None if bias is None else bias[t0:t1])


def lse_forward_plain(query, pos_logit, neg_emb, pos_id, neg_id, bias, temperature: float,
                      downscore: bool, tile: int = TILE) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`lse_forward`: the JAX scan's online update."""
    m = pos_logit.clone()
    s = torch.ones_like(pos_logit)
    for _, _, neg_t, nid_t, bias_t in _tiles(neg_emb, neg_id, bias, tile):
        logits = _tile_logits(query, neg_t, pos_id, nid_t, bias_t, temperature, downscore)
        new_m = torch.maximum(m, logits.amax(dim=1))
        s = s * torch.exp(m - new_m) + torch.exp(logits - new_m[:, None]).sum(dim=1)
        m = new_m
    return m, s


def _coef(query, neg_t, lse, gw, pos_id, nid_t, bias_t, temperature, downscore):
    logits = _tile_logits(query, neg_t, pos_id, nid_t, bias_t, temperature, downscore)
    return gw[:, None] * torch.exp(logits - lse[:, None]) / temperature


def grad_query_plain(query, neg_emb, lse, gw, pos_id, neg_id, bias, temperature: float,
                     downscore: bool, tile: int = TILE) -> torch.Tensor:
    """Plain version of :func:`grad_query`: the tiled recompute."""
    dq = torch.zeros_like(query)
    for _, _, neg_t, nid_t, bias_t in _tiles(neg_emb, neg_id, bias, tile):
        dq += _coef(query, neg_t, lse, gw, pos_id, nid_t, bias_t, temperature, downscore) @ neg_t
    return dq


def grad_neg_plain(query, neg_emb, lse, gw, pos_id, neg_id, bias, temperature: float,
                   downscore: bool, tile: int = TILE) -> torch.Tensor:
    """Plain version of :func:`grad_neg`: the tiled recompute."""
    dneg = torch.empty_like(neg_emb)
    for t0, t1, neg_t, nid_t, bias_t in _tiles(neg_emb, neg_id, bias, tile):
        coef = _coef(query, neg_t, lse, gw, pos_id, nid_t, bias_t, temperature, downscore)
        dneg[t0:t1] = coef.T @ query
    return dneg


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------


def _lib():
    lib = kernels.load("flash_ce")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_ce_dmax.restype = i
        lib.flash_ce_lse_splits.argtypes = [i, i, i]
        lib.flash_ce_lse_splits.restype = i
        lib.flash_ce_lse_forward.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, f, i, i, p]
        lib.flash_ce_lse_forward.restype = i
        lib.flash_ce_grad_splits.argtypes = [i, i, i, i]
        lib.flash_ce_grad_splits.restype = i
        lib.flash_ce_grad_smem.argtypes = [i]
        lib.flash_ce_grad_smem.restype = i
        for fn in (lib.flash_ce_grad_query, lib.flash_ce_grad_neg):
            fn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, f, i, i, p]
            fn.restype = i
        lib._typed = True
    return lib


def _check_matrix(name, x, D=None, device=None):
    if x.dtype == torch.bfloat16:
        raise ValueError(f"{name}: bf16 inputs to the flash-CE kernels wait for the "
                         "mixed-precision slice (ROADMAP.md queue 1); pass float32")
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 2-D float32 tensor")
    if D is not None and x.shape[1] != D:
        raise ValueError(f"{name} has width {x.shape[1]}, the queries {D}")
    if device is not None and x.device != device:
        raise ValueError(f"{name} lies on {x.device}, the queries on {device}")


def _check_vector(name, x, n, dtype, device):
    if x is None:
        return
    if x.dtype != dtype or x.shape != (n,) or not x.is_contiguous() or x.device != device:
        raise ValueError(f"{name} must be a contiguous ({n},) {dtype} tensor beside the queries")


def _check(query, neg_emb, pos_id, neg_id, bias, per_query):
    _check_matrix("query", query)
    _check_matrix("neg_emb", neg_emb, query.shape[1], query.device)
    Q, N, dev = query.shape[0], neg_emb.shape[0], query.device
    _check_vector("pos_id", pos_id, Q, torch.int32, dev)
    _check_vector("neg_id", neg_id, N, torch.int32, dev)
    _check_vector("bias", bias, N, torch.float32, dev)
    for name, x in per_query.items():
        _check_vector(name, x, Q, torch.float32, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the flash-CE kernels run on CUDA or the CPU, not {dev}")
    if dev.type == "cuda":
        dmax = _lib().flash_ce_dmax()
        if query.shape[1] > dmax:
            raise ValueError(f"the flash-CE kernels hold D <= {dmax}; got D={query.shape[1]}")


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def lse_forward(query, pos_logit, neg_emb, pos_id, neg_id, bias, temperature: float,
                downscore: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m, s), each (Q,) f32: the running max and the sum of exponentials
    relative to it over the positive logit and every negative. ``pos_id``
    (Q,) / ``neg_id`` (N,) int32 and ``bias`` (N,) f32 may be None."""
    _check(query, neg_emb, pos_id, neg_id, bias, {"pos_logit": pos_logit})
    if query.device.type == "cpu":
        return lse_forward_plain(query, pos_logit, neg_emb, pos_id, neg_id, bias,
                                 temperature, downscore)
    (Q, D), N = query.shape, neg_emb.shape[0]
    m, s = torch.empty_like(pos_logit), torch.empty_like(pos_logit)
    if Q == 0:
        return m, s
    lib = _lib()
    splits = lib.flash_ce_lse_splits(Q, N, D)
    if splits < 0:
        kernels.check(lib, -splits, "flash_ce_lse_splits")
    part_m = torch.empty((splits, Q), dtype=torch.float32, device=query.device)
    part_s = torch.empty_like(part_m)
    rc = lib.flash_ce_lse_forward(
        query.data_ptr(), pos_logit.data_ptr(), neg_emb.data_ptr(), _ptr(pos_id), _ptr(neg_id),
        _ptr(bias), part_m.data_ptr(), part_s.data_ptr(), m.data_ptr(), s.data_ptr(),
        Q, N, D, float(temperature), int(bool(downscore)), splits, _stream(query),
    )
    kernels.check(lib, rc, "flash_ce_lse_forward")
    lse_forward.launches += 1
    return m, s


def _grad(entry, counter, out, query, neg_emb, lse, gw, pos_id, neg_id, bias, temperature,
          downscore):
    (Q, D), N = query.shape, neg_emb.shape[0]
    if Q == 0 or N == 0:
        return out.zero_()
    lib = _lib()
    # the kernel cuts the streamed side into chunks that fill the card; each
    # chunk's partial sum goes to scratch, summed in chunk order
    splits = lib.flash_ce_grad_splits(Q, N, D, int(entry == "flash_ce_grad_query"))
    if splits < 0:
        kernels.check(lib, -splits, "flash_ce_grad_splits")
    part = None if splits == 1 else torch.empty((splits, *out.shape), dtype=torch.float32,
                                                device=out.device)
    rc = getattr(lib, entry)(
        query.data_ptr(), neg_emb.data_ptr(), lse.data_ptr(), gw.data_ptr(), _ptr(pos_id),
        _ptr(neg_id), _ptr(bias), _ptr(part), out.data_ptr(), Q, N, D, float(temperature),
        int(bool(downscore)), splits, _stream(query),
    )
    kernels.check(lib, rc, entry)
    counter.launches += 1
    return out


def grad_query(query, neg_emb, lse, gw, pos_id, neg_id, bias, temperature: float,
               downscore: bool) -> torch.Tensor:
    """The negatives' part of d loss / d query, (Q, D) f32, for the log-sum-exp
    ``lse`` (Q,) of the forward and the row weights ``gw`` (Q,)."""
    _check(query, neg_emb, pos_id, neg_id, bias, {"lse": lse, "gw": gw})
    if query.device.type == "cpu":
        return grad_query_plain(query, neg_emb, lse, gw, pos_id, neg_id, bias, temperature,
                                downscore)
    return _grad("flash_ce_grad_query", grad_query, torch.empty_like(query), query, neg_emb,
                 lse, gw, pos_id, neg_id, bias, temperature, downscore)


def grad_neg(query, neg_emb, lse, gw, pos_id, neg_id, bias, temperature: float,
             downscore: bool) -> torch.Tensor:
    """d loss / d neg_emb, (N, D) f32; query rows with ``gw = 0`` add nothing."""
    _check(query, neg_emb, pos_id, neg_id, bias, {"lse": lse, "gw": gw})
    if query.device.type == "cpu":
        return grad_neg_plain(query, neg_emb, lse, gw, pos_id, neg_id, bias, temperature,
                              downscore)
    return _grad("flash_ce_grad_neg", grad_neg, torch.empty_like(neg_emb), query, neg_emb,
                 lse, gw, pos_id, neg_id, bias, temperature, downscore)


lse_forward.launches = 0
grad_query.launches = 0
grad_neg.launches = 0
