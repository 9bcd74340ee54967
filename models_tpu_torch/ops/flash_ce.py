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
Query and negatives are both float32 or both bf16 (the ``mixed_bfloat16``
policy); the per-row inputs and every output are float32. On the card the
float32 forms compute their products on the tensor cores as 3xTF32 (near
fp32's error); the bf16 forms take the logits as one bf16 product into fp32,
on ``wgmma`` where :func:`lse_route` and :func:`grad_route` say so (one
rule: bf16, D a multiple of 8 up to 128, 16-byte aligned rows), else on
``mma.sync``. On ``wgmma`` the forward forms each exponential as one fma
and one ``ex2`` (:func:`lse_forward_ex2` models that arithmetic on the CPU,
for the tests). The gradient products split each fp32 coefficient into three
bf16 parts, whose products with the bf16 rows are exact
(:func:`grad_query_split3` and :func:`grad_neg_split3` model that arithmetic),
on ``wgmma``, else as 2xTF32 on ``mma.sync``. The plain versions widen
bf16 operands to float32 before each product: bf16 products are exact in
float32, so they compute what the kernels compute, up to the order of the
sums. The kernels hold widths up to :data:`DMAX`; :func:`fits` tells a
caller whether its operands may go to them.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..core.constants import MIN_FLOAT
from . import kernels

TILE = 2048  # negatives per step of the plain versions
DMAX = 256  # the widest D the card's kernels hold (csrc/flash_ce.cu, flash_ce_dmax)


def fits(D: int, device) -> bool:
    """Whether operands of width D on ``device`` may go to :func:`lse_forward`,
    :func:`grad_query` and :func:`grad_neg`: always on the CPU, whose plain
    versions take any width; on the card up to :data:`DMAX`. A route chosen
    from the shape, as the JAX package's ``_use_flash`` chooses one."""
    return torch.device(device).type == "cpu" or D <= DMAX


def _tile_logits(query, neg_t, pos_id, neg_id_t, bias_t, temperature, downscore):
    s = query.float() @ neg_t.float().T
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
    dq = torch.zeros(query.shape, dtype=torch.float32, device=query.device)
    for _, _, neg_t, nid_t, bias_t in _tiles(neg_emb, neg_id, bias, tile):
        coef = _coef(query, neg_t, lse, gw, pos_id, nid_t, bias_t, temperature, downscore)
        dq += coef @ neg_t.float()
    return dq


def grad_neg_plain(query, neg_emb, lse, gw, pos_id, neg_id, bias, temperature: float,
                   downscore: bool, tile: int = TILE) -> torch.Tensor:
    """Plain version of :func:`grad_neg`: the tiled recompute."""
    dneg = torch.empty(neg_emb.shape, dtype=torch.float32, device=neg_emb.device)
    for t0, t1, neg_t, nid_t, bias_t in _tiles(neg_emb, neg_id, bias, tile):
        coef = _coef(query, neg_t, lse, gw, pos_id, nid_t, bias_t, temperature, downscore)
        dneg[t0:t1] = coef.T @ query.float()
    return dneg


SPLIT_ROWS = 32  # rows of the bf16 kernels' gradient product summed from zero


def split3_bf16(c: torch.Tensor):
    """(hi, mid, lo), bf16: ``hi`` is ``c`` rounded to nearest, ``mid`` and
    ``lo`` the remainders after the parts before, rounded alike. Each
    remainder is exact in float32, and the three parts sum to ``c`` exactly
    where ``|c| >= 2**-110``, within ``2**-134`` below (csrc/hopper.cuh,
    ``split3_bf16``)."""
    hi = c.to(torch.bfloat16)
    rest = c - hi.float()
    mid = rest.to(torch.bfloat16)
    return hi, mid, (rest - mid.float()).to(torch.bfloat16)


def split3_product(coef: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``coef @ rows`` as the bf16 kernels take it: (M, K) float32
    coefficients split in three bf16 parts, times (K, D) bf16 rows, each
    product exact in float32; each :data:`SPLIT_ROWS` rows summed from zero
    (the small parts first), then added to the (M, D) float32 result."""
    out = torch.zeros(coef.shape[0], rows.shape[1], dtype=torch.float32, device=coef.device)
    for k0 in range(0, coef.shape[1], SPLIT_ROWS):
        r = rows[k0:k0 + SPLIT_ROWS].float()
        hi, mid, lo = split3_bf16(coef[:, k0:k0 + SPLIT_ROWS].contiguous())
        out += lo.float() @ r + mid.float() @ r + hi.float() @ r
    return out


def grad_query_split3(query, neg_emb, lse, gw, pos_id, neg_id, bias, temperature: float,
                      downscore: bool) -> torch.Tensor:
    """:func:`grad_query` in the bf16 kernels' arithmetic (the tests' model
    of it): the coefficients as the plain version computes them, the product
    by :func:`split3_product`."""
    coef = _coef(query, neg_emb, lse, gw, pos_id, neg_id, bias, temperature, downscore)
    return split3_product(coef, neg_emb)


def grad_neg_split3(query, neg_emb, lse, gw, pos_id, neg_id, bias, temperature: float,
                    downscore: bool) -> torch.Tensor:
    """:func:`grad_neg` in the bf16 kernels' arithmetic, as
    :func:`grad_query_split3`."""
    coef = _coef(query, neg_emb, lse, gw, pos_id, neg_id, bias, temperature, downscore)
    return split3_product(coef.T, query)


LOGIT_PART = 32  # depth of each bf16 logit part summed from zero
WG_TILE = 64  # negatives per tile of the wgmma kernels
LOG2E = 1.4426950408889634


def logit_parts(query: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """``query @ neg.T`` as the bf16 kernels sum it: exact products in
    float32, each :data:`LOGIT_PART` deep summed from zero, the parts added
    in depth order."""
    out = None
    for k0 in range(0, query.shape[1], LOGIT_PART):
        part = query[:, k0:k0 + LOGIT_PART].float() @ neg[:, k0:k0 + LOGIT_PART].float().T
        out = part if out is None else out + part
    return out


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def lse_forward_ex2(query, pos_logit, neg_emb, pos_id, neg_id, bias, temperature: float,
                    downscore: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`lse_forward` in ``lse_wg``'s arithmetic (the tests' model of
    it): the logits by :func:`logit_parts`; per tile of :data:`WG_TILE`
    negatives the max over ``x' + bias`` (``MIN_FLOAT`` where masked),
    scaled once by ``1 / T``; each exponential as
    ``2 ** fma(x' + bias, log2(e) / T, -m log2(e))`` against the running max
    (the fma's one rounding taken in float64, then float32); the running
    sum rescaled by ``exp``; the positive logit merged last, as ``lse_merge``
    merges it. One split: the card's splits merge alike."""
    Q, N = query.shape[0], neg_emb.shape[0]
    inv_t = _f32(1.0) / _f32(temperature)
    scale = inv_t * _f32(LOG2E)
    v = logit_parts(query, neg_emb)
    if bias is not None:
        v = v + bias[None, :]
    if downscore and pos_id is not None and neg_id is not None:
        v = torch.where(neg_id[None, :] == pos_id[:, None], MIN_FLOAT, v)
    m = torch.full((Q,), -torch.finfo(torch.float32).max)
    s = torch.zeros(Q)
    for c0 in range(0, N, WG_TILE):
        vt = v[:, c0:c0 + WG_TILE]
        mn = torch.maximum(m, vt.amax(dim=1) * inv_t)
        s = s * torch.exp(m - mn)
        nml = torch.clamp(-mn * _f32(LOG2E), max=torch.finfo(torch.float32).max)
        e = (vt.double() * scale.double() + nml.double()[:, None]).float()
        s = s + torch.exp2(e.double()).float().sum(dim=1)
        m = mn
    mm = torch.maximum(pos_logit, m)
    return mm, torch.exp(pos_logit - mm) + s * torch.exp(m - mm)


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------


def _lib():
    lib = kernels.load("flash_ce")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_ce_dmax.restype = i
        lib.flash_ce_lse_splits.argtypes = [i, i, i, p, p, i]
        lib.flash_ce_lse_splits.restype = i
        lib.flash_ce_lse_forward.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, f, i, i, i, p]
        lib.flash_ce_lse_forward.restype = i
        lib.flash_ce_grad_splits.argtypes = [i, i, i, i, i]
        lib.flash_ce_grad_splits.restype = i
        lib.flash_ce_grad_smem.argtypes = [i, i]
        lib.flash_ce_grad_smem.restype = i
        for fn in (lib.flash_ce_grad_wg_smem, lib.flash_ce_lse_wg_smem):
            fn.argtypes = [i]
            fn.restype = i
        lib.flash_ce_grad_route.argtypes = [i, p, p, i]
        lib.flash_ce_grad_route.restype = i
        lib.flash_ce_logit_probe.argtypes = [p, p, p, p, i, p]
        lib.flash_ce_logit_probe.restype = i
        for fn in (lib.flash_ce_grad_query, lib.flash_ce_grad_neg):
            fn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, f, i, i, i, p]
            fn.restype = i
        lib._typed = True
    return lib


def _check_matrix(name, x, like=None):
    if x.dtype not in (torch.float32, torch.bfloat16) or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 2-D float32 or bfloat16 tensor")
    if like is None:
        return
    if x.dtype != like.dtype:
        raise ValueError(f"{name} is {x.dtype}, the queries {like.dtype}: both float32 or "
                         "both bfloat16")
    if x.shape[1] != like.shape[1]:
        raise ValueError(f"{name} has width {x.shape[1]}, the queries {like.shape[1]}")
    if x.device != like.device:
        raise ValueError(f"{name} lies on {x.device}, the queries on {like.device}")


def _check_vector(name, x, n, dtype, device):
    if x is None:
        return
    if x.dtype != dtype or x.shape != (n,) or not x.is_contiguous() or x.device != device:
        raise ValueError(f"{name} must be a contiguous ({n},) {dtype} tensor beside the queries")


def _check(query, neg_emb, pos_id, neg_id, bias, per_query):
    _check_matrix("query", query)
    _check_matrix("neg_emb", neg_emb, query)
    Q, N, dev = query.shape[0], neg_emb.shape[0], query.device
    _check_vector("pos_id", pos_id, Q, torch.int32, dev)
    _check_vector("neg_id", neg_id, N, torch.int32, dev)
    _check_vector("bias", bias, N, torch.float32, dev)
    for name, x in per_query.items():
        _check_vector(name, x, Q, torch.float32, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the flash-CE kernels run on CUDA or the CPU, not {dev}")
    if dev.type == "cuda" and not fits(query.shape[1], dev):
        raise ValueError(f"the flash-CE kernels hold D <= {DMAX}; got D={query.shape[1]}")


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def _bf16(x: torch.Tensor) -> int:
    """The kernels' operand form: 1 for bf16 query and negatives, 0 for fp32."""
    return int(x.dtype == torch.bfloat16)


def _count(wrapper, x: torch.Tensor) -> None:
    """One launch more on the wrapper's count of the form ``x`` takes:
    ``launches`` (fp32) or ``launches_bf16``."""
    if _bf16(x):
        wrapper.launches_bf16 += 1
    else:
        wrapper.launches += 1


def lse_forward(query, pos_logit, neg_emb, pos_id, neg_id, bias, temperature: float,
                downscore: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m, s), each (Q,) f32: the running max and the sum of exponentials
    relative to it over the positive logit and every negative. ``query``
    (Q, D) and ``neg_emb`` (N, D) f32 or bf16; ``pos_id`` (Q,) / ``neg_id``
    (N,) int32 and ``bias`` (N,) f32 may be None."""
    _check(query, neg_emb, pos_id, neg_id, bias, {"pos_logit": pos_logit})
    if query.device.type == "cpu":
        return lse_forward_plain(query, pos_logit, neg_emb, pos_id, neg_id, bias,
                                 temperature, downscore)
    (Q, D), N = query.shape, neg_emb.shape[0]
    if Q == 0 or N == 0:  # no negative: the positive alone
        return pos_logit.clone(), torch.ones_like(pos_logit)
    m, s = torch.empty_like(pos_logit), torch.empty_like(pos_logit)
    lib = _lib()
    splits = lib.flash_ce_lse_splits(Q, N, D, query.data_ptr(), neg_emb.data_ptr(),
                                     _bf16(query))
    if splits < 0:
        kernels.check(lib, -splits, "flash_ce_lse_splits")
    part_m = torch.empty((splits, Q), dtype=torch.float32, device=query.device)
    part_s = torch.empty_like(part_m)
    rc = lib.flash_ce_lse_forward(
        query.data_ptr(), pos_logit.data_ptr(), neg_emb.data_ptr(), _ptr(pos_id), _ptr(neg_id),
        _ptr(bias), part_m.data_ptr(), part_s.data_ptr(), m.data_ptr(), s.data_ptr(),
        Q, N, D, float(temperature), int(bool(downscore)), splits, _bf16(query), _stream(query),
    )
    kernels.check(lib, rc, "flash_ce_lse_forward")
    _count(lse_forward, query)
    return m, s


def _grad(entry, counter, out, query, neg_emb, lse, gw, pos_id, neg_id, bias, temperature,
          downscore):
    (Q, D), N = query.shape, neg_emb.shape[0]
    if Q == 0 or N == 0:
        return out.zero_()
    lib = _lib()
    # the kernel cuts the streamed side into chunks that fill the card; each
    # chunk's partial sum goes to scratch, summed in chunk order
    splits = lib.flash_ce_grad_splits(Q, N, D, int(entry == "flash_ce_grad_query"),
                                      _bf16(query))
    if splits < 0:
        kernels.check(lib, -splits, "flash_ce_grad_splits")
    part = None if splits == 1 else torch.empty((splits, *out.shape), dtype=torch.float32,
                                                device=out.device)
    rc = getattr(lib, entry)(
        query.data_ptr(), neg_emb.data_ptr(), lse.data_ptr(), gw.data_ptr(), _ptr(pos_id),
        _ptr(neg_id), _ptr(bias), _ptr(part), out.data_ptr(), Q, N, D, float(temperature),
        int(bool(downscore)), splits, _bf16(query), _stream(query),
    )
    kernels.check(lib, rc, entry)
    _count(counter, query)
    return out


def _wg(query: torch.Tensor, neg_emb: torch.Tensor) -> bool:
    """Whether these CUDA operands take the wgmma kernels: bf16, D a multiple
    of 8 up to 128, 16-byte aligned rows (``flash_ce_grad_route``)."""
    return bool(_lib().flash_ce_grad_route(query.shape[1], query.data_ptr(),
                                           neg_emb.data_ptr(), _bf16(query)))


def grad_route(query: torch.Tensor, neg_emb: torch.Tensor) -> str:
    """The kernel :func:`grad_query` and :func:`grad_neg` launch for these CUDA
    operands, chosen from the shape and the pointers: ``"grad_wg"`` (bf16, D
    a multiple of 8 up to 128, 16-byte aligned rows: wgmma, a TMA ring, the
    three-part bf16 product) or ``"grad_rows"`` (mma.sync)."""
    return "grad_wg" if _wg(query, neg_emb) else "grad_rows"


def lse_route(query: torch.Tensor, neg_emb: torch.Tensor) -> str:
    """The kernel :func:`lse_forward` launches for these CUDA operands, by the
    rule of :func:`grad_route`: ``"lse_wg"`` (wgmma, a TMA ring, the logits
    bit for bit ``grad_wg``'s) where K2 / K3 take ``grad_wg``, else
    ``"lse_partial"`` (mma.sync)."""
    return "lse_wg" if _wg(query, neg_emb) else "lse_partial"


def grad_query(query, neg_emb, lse, gw, pos_id, neg_id, bias, temperature: float,
               downscore: bool) -> torch.Tensor:
    """The negatives' part of d loss / d query, (Q, D) f32, for the log-sum-exp
    ``lse`` (Q,) of the forward and the row weights ``gw`` (Q,)."""
    _check(query, neg_emb, pos_id, neg_id, bias, {"lse": lse, "gw": gw})
    if query.device.type == "cpu":
        return grad_query_plain(query, neg_emb, lse, gw, pos_id, neg_id, bias, temperature,
                                downscore)
    return _grad("flash_ce_grad_query", grad_query,
                 torch.empty(query.shape, dtype=torch.float32, device=query.device), query,
                 neg_emb, lse, gw, pos_id, neg_id, bias, temperature, downscore)


def grad_neg(query, neg_emb, lse, gw, pos_id, neg_id, bias, temperature: float,
             downscore: bool) -> torch.Tensor:
    """d loss / d neg_emb, (N, D) f32; query rows with ``gw = 0`` add nothing."""
    _check(query, neg_emb, pos_id, neg_id, bias, {"lse": lse, "gw": gw})
    if query.device.type == "cpu":
        return grad_neg_plain(query, neg_emb, lse, gw, pos_id, neg_id, bias, temperature,
                              downscore)
    return _grad("flash_ce_grad_neg", grad_neg,
                 torch.empty(neg_emb.shape, dtype=torch.float32, device=neg_emb.device), query,
                 neg_emb, lse, gw, pos_id, neg_id, bias, temperature, downscore)


for _wrapper in (lse_forward, grad_query, grad_neg):
    _wrapper.launches = _wrapper.launches_bf16 = 0
