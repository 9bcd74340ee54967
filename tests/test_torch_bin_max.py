"""Phase A of the port's binned top-k (models_tpu_torch.ops.topk: bin_max,
K4's plain version, and select_bins) against the JAX package's phase A on
the CPU: the same seeded numpy inputs go to both. Also the choice between
K4's two designs (``bin_max_design``) and a model of the wgmma design's bf16
arithmetic (``bin_max_split3`` below), held to JAX's phase A at HIGHEST and, on
tie-free data, to the exact top-k through the binned route.

The JAX package computes phase A inside ``binned_topk``
(models_tpu/ops/topk.py:416-443: the einsum over (L, bs, D) bins, each bin's
max, scaled per bin after the max or per row before it, then
``lax.top_k`` of the (B, L) maxima); ``jax_phase_a`` below evaluates those
lines with ``jnp``. fp32 and bf16 bin maxima agree within REL_TOL of the
largest |maximum| (fp32 sums of D products taken in another order), and the
selected bins are equal outside near-ties (``ops/topk.py::ids_agree``); int8
sums are exact, so the int8 maxima and bins are bit-equal. The CUDA kernel
(``csrc/bin_max.cu``) runs only on the card: ``chip_smoke.py`` holds it to
``bin_max_plain`` there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from models_tpu_torch.ops import topk as ttopk

REL_TOL = 2e-6
BS = 64
K = 10
MARGIN = 2

DTYPES = ["fp32", "bf16", "int8_bin", "int8_row"]


def _inputs(seed, B, C, D, dtype, integer=False):
    """Queries (B, D) f32; candidates (C, D) in the dtype; for int8 positive
    scales, constant within each 64-row bin (``int8_bin``, the bin-quantized
    index) or one a row (``int8_row``)."""
    rng = np.random.default_rng(seed)
    if integer:  # every product and sum exact: equal bins tie exactly
        q = rng.integers(-3, 4, size=(B, D)).astype(np.float32)
        c = rng.integers(-3, 4, size=(C, D)).astype(np.float32)
    else:
        q = rng.standard_normal((B, D)).astype(np.float32)
        c = rng.standard_normal((C, D)).astype(np.float32)
    scale = None
    if dtype.startswith("int8"):
        c = rng.integers(-127, 128, size=(C, D)).astype(np.int8)
        if dtype == "int8_bin":
            scale = np.repeat(rng.uniform(0.002, 0.032, -(-C // BS)), BS)[:C]
        else:
            scale = rng.uniform(0.002, 0.032, C)
        scale = scale.astype(np.float32)
    return q, c, scale


def _jax_cand(c, dtype):
    return jnp.asarray(c).astype(jnp.bfloat16) if dtype == "bf16" else jnp.asarray(c)


def _torch_cand(c, dtype):
    t = torch.from_numpy(c)
    return t.to(torch.bfloat16) if dtype == "bf16" else t


def jax_quantize(q):
    """The JAX binned route's per-row int8 queries (models_tpu/ops/topk.py:373-379)."""
    q_amax = jnp.max(jnp.abs(q), axis=1)
    q_scale = jnp.where(q_amax > 0, q_amax, 1.0) / 127.0
    return jnp.clip(jnp.round(q / q_scale[:, None]), -127, 127).astype(jnp.int8)


def jax_phase_a(q, c, k, bs, n_valid, col_scale, per_bin, precision=None):
    """(bin maxima (B, L), selected bins (B, kb)) as models_tpu/ops/topk.py
    computes them at :416-443 (``precision``: its ``phase_a_precision``)."""
    B, D = q.shape
    C = c.shape[0]
    L = C // bs
    acc_dt = jnp.int32 if jnp.issubdtype(c.dtype, jnp.integer) else jnp.float32
    c3 = c[: L * bs].reshape(L, bs, D)
    raw = jnp.einsum("bd,lsd->bls", q, c3, preferred_element_type=acc_dt, precision=precision)
    if col_scale is not None and per_bin:
        sc_bin = col_scale[: L * bs].reshape(L, bs)[:, 0]
        bin_max = jnp.max(raw, axis=2).astype(jnp.float32) * sc_bin[None, :]
    else:
        s = raw.astype(jnp.float32)
        if col_scale is not None:
            s = s * col_scale[: L * bs].reshape(1, L, bs)
        bin_max = jnp.max(s, axis=2)
    mask_pad = n_valid is not None and n_valid < L * bs
    kb = min(k + MARGIN + (1 if mask_pad else 0), L)
    _, idx = jax.lax.top_k(bin_max, kb)
    return np.asarray(bin_max), np.asarray(idx)


def _both(q, c, scale, dtype, k=K, bs=BS, n_valid=None):
    """The JAX phase A and the port's (bin_max_plain, select_bins) on the
    same inputs: ((maxima, bins), (maxima, bins)) as numpy."""
    is_int = dtype.startswith("int8")
    per_bin = dtype == "int8_bin"
    jq = jnp.asarray(q)
    tq = torch.from_numpy(q)
    if is_int:
        jq = jax_quantize(jq)
        tq, _ = ttopk.quantize_queries(tq)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    jscale = None if scale is None else jnp.asarray(scale)
    tscale = None if scale is None else torch.from_numpy(scale)
    ref = jax_phase_a(jq, _jax_cand(c, dtype), k, bs, n_valid, jscale, per_bin)
    tc = _torch_cand(c, dtype)
    maxima = ttopk.bin_max_plain(tq, tc, bs, tscale, per_bin)
    bins = ttopk.select_bins(tq, tc, k, bs, MARGIN, n_valid, tscale, per_bin, device="cpu")
    assert bins.dtype == torch.int32 and bins.is_contiguous()
    return ref, (maxima.numpy(), bins.numpy())


def _assert_agree(ref, port, dtype):
    (jm, ji), (pm, pi) = ref, port
    assert pm.shape == jm.shape and pi.shape == ji.shape
    if dtype.startswith("int8"):
        np.testing.assert_array_equal(pm.view(np.uint32), jm.view(np.uint32))
        np.testing.assert_array_equal(pi, ji)
        return
    tol = REL_TOL * max(1.0, float(np.nanmax(np.abs(jm))))
    np.testing.assert_allclose(pm, jm, rtol=0, atol=tol)
    # the selected bins, each with its maximum: equal outside near-ties
    js = np.take_along_axis(jm, ji.astype(np.int64), 1)
    ps = np.take_along_axis(pm, pi.astype(np.int64), 1)
    assert ttopk.ids_agree(ps, pi, js, ji, tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [32, 128, 130])
@pytest.mark.parametrize("B", [1, 17, 256])
def test_phase_a_matches_jax(dtype, D, B):
    q, c, scale = _inputs(B * 1000 + D, B, 64 * 37, D, dtype)
    ref, port = _both(q, c, scale, dtype)
    _assert_agree(ref, port, dtype)
    assert port[1].shape == (B, K + MARGIN)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_valid", [64 * 40 - 23, 64 * 40 - 63])
def test_padding_takes_the_extra_margin_bin(dtype, n_valid):
    """An index padded to whole bins at build time (zero rows past
    ``n_valid``, as ``BruteForce.index`` pads): one more bin is selected."""
    q, c, scale = _inputs(7, 19, 64 * 40, 32, dtype)
    c[n_valid:] = 0
    ref, port = _both(q, c, scale, dtype, n_valid=n_valid)
    _assert_agree(ref, port, dtype)
    assert port[1].shape == (19, K + MARGIN + 1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_tied_bin_maxima_go_to_the_lowest_bin(dtype):
    """Integer-valued rows: every score is exact, many bins share a maximum,
    and bin 30 is a copy of bin 4, so both rank alike; lax.top_k takes tied
    bins in ascending order, and so must select_bins."""
    q, c, scale = _inputs(11, 17, 64 * 32, 32, dtype, integer=True)
    c[30 * BS:31 * BS] = c[4 * BS:5 * BS]
    if scale is not None:
        scale[30 * BS:31 * BS] = scale[4 * BS:5 * BS]
    (jm, ji), (pm, pi) = _both(q, c, scale, dtype)
    np.testing.assert_array_equal(pm.view(np.uint32), jm.view(np.uint32))
    np.testing.assert_array_equal(pi, ji)
    sel = np.take_along_axis(pm, pi.astype(np.int64), 1)
    tied = sel[:, 1:] == sel[:, :-1]
    assert tied.any()  # the case holds ties among the selected bins
    assert (pi[:, 1:][tied] > pi[:, :-1][tied]).all()
    np.testing.assert_array_equal(pm[:, 30], pm[:, 4])


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_nan_query_row_gives_nan_maxima(dtype):
    """A NaN query row scores NaN everywhere (fp32, bf16): its bin maxima
    are NaN, as torch.amax and jnp.max keep it, and its bins are the first
    kb, as lax.top_k ranks NaN. The int8 route quantizes the row first (its
    scale is NaN); both packages get the same int8 row."""
    q, c, scale = _inputs(13, 17, 64 * 30, 32, dtype)
    q[5] = np.nan
    ref, port = _both(q, c, scale, dtype)
    (jm, ji), (pm, pi) = ref, port
    if not dtype.startswith("int8"):
        assert np.isnan(pm[5]).all() and np.isnan(jm[5]).all()
        np.testing.assert_array_equal(pi[5], np.arange(K + MARGIN))
        np.testing.assert_array_equal(ji[5], pi[5])
        keep = np.arange(17) != 5
        ref, port = (jm[keep], ji[keep]), (pm[keep], pi[keep])
    _assert_agree(ref, port, dtype)


@pytest.mark.parametrize("bs", [8, 40, 128])
@pytest.mark.parametrize("dtype", ["fp32", "int8_row"])
def test_other_bin_sizes_match_jax(dtype, bs):
    """The public binned_topk takes any bin size: bins of 8 and 40 rows (the
    kernel's reduction through shared memory) and of 128 (two tiles a bin);
    rows past the last full bin are not read."""
    q, c, scale = _inputs(17, 9, 64 * 20 + 5, 32, dtype)
    ref, port = _both(q, c, scale, dtype, bs=bs)
    _assert_agree(ref, port, dtype)
    assert port[0].shape == (9, (64 * 20 + 5) // bs)


@pytest.mark.parametrize("dtype", DTYPES)
def test_the_operator_is_the_plain_version_on_the_cpu(dtype):
    """torch.ops.models_tpu_torch.bin_max (what an exported program holds)
    and the wrapper give the plain version's bits on CPU tensors, and the
    kernel's launch count does not move."""
    q, c, scale = _inputs(19, 17, 64 * 20, 32, dtype)
    tq = torch.from_numpy(q)
    if dtype.startswith("int8"):
        tq, _ = ttopk.quantize_queries(tq)
    tc = _torch_cand(c, dtype)
    tscale = None if scale is None else torch.from_numpy(scale)
    per_bin = dtype == "int8_bin"
    before = ttopk.bin_max.launches
    want = ttopk.bin_max_plain(tq, tc, BS, tscale, per_bin)
    for got in (torch.ops.models_tpu_torch.bin_max(tq, tc, BS, tscale, per_bin),
                ttopk.bin_max(tq, tc, BS, tscale, per_bin)):
        assert got.dtype == torch.float32 and got.shape == (17, 20)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert ttopk.bin_max.launches == before


def test_bin_max_refuses_what_it_cannot_take():
    q = torch.zeros(4, 32)
    c8 = torch.zeros(128, 32, dtype=torch.int8)
    with pytest.raises(ValueError, match="int8"):
        ttopk.bin_max(q, c8)  # int8 rows take the int8 queries
    with pytest.raises(ValueError, match="width"):
        ttopk.bin_max(q, torch.zeros(128, 16))
    with pytest.raises(ValueError, match="scale"):
        ttopk.bin_max(q, torch.zeros(128, 32), scale=torch.ones(64))
    with pytest.raises(ValueError, match="bin_size"):
        ttopk.bin_max(q, torch.zeros(128, 32), bin_size=0)


# ---------------------------------------------------------------------------
# K4's two designs: the choice by shape, the wgmma design's bf16 arithmetic
# ---------------------------------------------------------------------------

_TORCH_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def bin_max_split3(queries, candidates, bin_size, scale=None, per_bin=False):
    """``bin_max`` over bf16 rows in the wgmma design's arithmetic (a model
    of ``csrc/bin_max.cu``'s bf16 form): the fp32 queries in three bf16
    parts (``split3_bf16``) times the bf16 rows, each product exact in
    float32, each ``LOGIT_PART`` deep summed from zero (the small parts
    first) and the parts added in depth order; then each bin's max, scaled
    as ``bin_max_plain`` scales it."""
    from models_tpu_torch.ops.flash_ce import LOGIT_PART, split3_bf16

    B, D = queries.shape
    L = candidates.shape[0] // bin_size
    rows = candidates[: L * bin_size].float()
    s = None
    for k0 in range(0, D, LOGIT_PART):
        r = rows[:, k0:k0 + LOGIT_PART].T
        hi, mid, lo = split3_bf16(queries[:, k0:k0 + LOGIT_PART].contiguous())
        part = lo.float() @ r + mid.float() @ r + hi.float() @ r
        s = part if s is None else s + part
    s = s.view(B, L, bin_size)
    if scale is not None and per_bin:
        return s.amax(dim=2) * scale[: L * bin_size].view(L, bin_size)[:, 0][None]
    if scale is not None:
        s = s * scale[: L * bin_size].view(1, L, bin_size)
    return s.amax(dim=2)


@pytest.mark.parametrize("bs", [64, 128])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_serving_shapes_take_the_wgmma_design(dtype, D, bs):
    """The serving paths' widths (128: the two-tower and the 1M / 2**24
    layers, 64: the MF, 32: YouTube-DNN) on 16-byte-aligned rows, at bins of
    a multiple of 64 rows, take the wgmma design (TMA ring, wgmma)."""
    assert ttopk.bin_max_design(_TORCH_DTYPES[dtype], D, bs) == "wgmma"


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("D,bs,aligned", [(130, 64, True), (300, 64, True), (128, 64, False),
                                          (128, 8, True), (128, 40, True), (64, 96, True)])
def test_other_shapes_keep_the_first_design(dtype, D, bs, aligned):
    """Rows wider than 128 or not whole 16-byte pieces (D = 130, 300), rows
    off a 16-byte address, and bins that are not multiples of 64 rows keep
    the first design (cp.async and mma.sync)."""
    assert ttopk.bin_max_design(_TORCH_DTYPES[dtype], D, bs, aligned) == "mma_sync"


@pytest.mark.parametrize("dtype,D", [("fp32", 4), ("fp32", 96), ("bf16", 8), ("bf16", 120),
                                     ("int8", 16), ("int8", 48)])
def test_any_whole_16_byte_row_up_to_128_takes_the_wgmma_design(dtype, D):
    """Widths between the serving ones (a whole number of 16-byte pieces, at
    most 128 elements) take the wgmma design too; one element more (two for
    int8), off a whole piece, does not."""
    t = _TORCH_DTYPES[dtype]
    assert ttopk.bin_max_design(t, D, 64) == "wgmma"
    assert ttopk.bin_max_design(t, D + 2 if dtype == "int8" else D + 1, 64) == "mma_sync"


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("B", [1, 17, 200])
def test_split3_bf16_arithmetic_matches_jax_highest(D, B):
    """The wgmma design's bf16 arithmetic (the fp32 query in three bf16
    parts, times the bf16 rows, exact products summed in fp32 32 deep at a
    time) against JAX's phase A at ``phase_a_precision=HIGHEST``: within
    REL_TOL of the largest |maximum|, the selected bins equal outside
    near-ties; its parts sum to the query exactly, so it also agrees with the
    plain version."""
    q, c, _ = _inputs(B * 100 + D, B, 64 * 37, D, "bf16")
    ref = jax_phase_a(jnp.asarray(q), _jax_cand(c, "bf16"), K, BS, None, None, False,
                      precision=jax.lax.Precision.HIGHEST)
    tq, tc = torch.from_numpy(q), _torch_cand(c, "bf16")
    maxima = bin_max_split3(tq, tc, BS)
    _, bins = ttopk.stable_topk(maxima, K + MARGIN)
    _assert_agree(ref, (maxima.numpy(), bins.to(torch.int32).numpy()), "bf16")
    plain = ttopk.bin_max_plain(tq, tc, BS)
    tol = REL_TOL * max(1.0, float(plain.abs().max()))
    np.testing.assert_allclose(maxima.numpy(), plain.numpy(), rtol=0, atol=tol)


@pytest.mark.parametrize("bs", [64, 128])
def test_split3_bf16_keeps_nan_and_scales(bs):
    """A NaN query row gives NaN maxima in the model as in the plain
    version; a per-row scale multiplies before the max, a per-bin one
    after."""
    q, c, _ = _inputs(29, 9, 64 * 12, 64, "bf16")
    q[4] = np.nan
    tq, tc = torch.from_numpy(q), _torch_cand(c, "bf16")
    scale = torch.from_numpy(np.random.default_rng(3).uniform(0.5, 2.0, 64 * 12)
                             .astype(np.float32))
    for sc, per_bin in ((None, False), (scale, False), (scale, True)):
        got = bin_max_split3(tq, tc, bs, sc, per_bin)
        want = ttopk.bin_max_plain(tq, tc, bs, sc, per_bin)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.isnan(got[4]).all()
        ok = ~torch.isnan(want)
        tol = REL_TOL * max(1.0, float(want[ok].abs().max()))
        assert float((got[ok] - want[ok]).abs().max()) <= tol


@pytest.mark.parametrize("seed", [0, 1])
def test_binned_topk_on_the_split3_model_is_exact(seed):
    """On tie-free data the binned top-k built on the bf16 model (bins by
    its maxima, k + margin of them; the pool rescored in phase B's fp32
    arithmetic, ``binned_rescore_plain``) returns the exact top-k: the ids of
    the float64 scores of the same bf16 rows, and JAX's ``binned_topk`` at
    ``phase_a_precision=HIGHEST``. Tie-free: the exact k-th and (k+1)-th
    scores of every row lie further apart than fp32's error of a sum of D
    products."""
    from models_tpu.ops import topk as jtopk

    B, C, D = 33, 64 * 200, 128
    q, c, _ = _inputs(seed + 40, B, C, D, "bf16")
    c16 = _torch_cand(c, "bf16")
    exact = q.astype(np.float64) @ c16.float().numpy().astype(np.float64).T
    order = np.argsort(-exact, axis=1, kind="stable")
    kth = np.take_along_axis(exact, order[:, K - 1:K + 1], 1)
    assert (kth[:, 0] - kth[:, 1] > 1e-3).all()  # the data is tie-free at the k-th score
    tq = torch.from_numpy(q)
    maxima = bin_max_split3(tq, c16, BS)
    _, bins = ttopk.stable_topk(maxima, K + MARGIN)
    pool = ttopk.binned_rescore_plain(tq, c16, bins.to(torch.int32), BS)  # (B, kb * BS)
    _, pos = ttopk.stable_topk(pool, K)
    ids = (bins.long()[:, :, None] * BS + torch.arange(BS)).reshape(B, -1)
    got = torch.gather(ids, 1, pos.long()).numpy()
    np.testing.assert_array_equal(got, order[:, :K])
    _, jids = jtopk.binned_topk(jnp.asarray(q), _jax_cand(c, "bf16"), K,
                                phase_a_precision=jax.lax.Precision.HIGHEST)
    np.testing.assert_array_equal(got, np.asarray(jids))
