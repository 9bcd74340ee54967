"""Phase A of the port's binned top-k (models_tpu_torch.ops.topk: bin_max,
K4's plain version, and select_bins) against the JAX package's phase A on
the CPU: the same seeded numpy inputs go to both.

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


def jax_phase_a(q, c, k, bs, n_valid, col_scale, per_bin):
    """(bin maxima (B, L), selected bins (B, kb)) as models_tpu/ops/topk.py
    computes them at :416-443."""
    B, D = q.shape
    C = c.shape[0]
    L = C // bs
    acc_dt = jnp.int32 if jnp.issubdtype(c.dtype, jnp.integer) else jnp.float32
    c3 = c[: L * bs].reshape(L, bs, D)
    raw = jnp.einsum("bd,lsd->bls", q, c3, preferred_element_type=acc_dt)
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
