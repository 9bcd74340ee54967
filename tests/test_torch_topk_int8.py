"""The port's int8 index and int8 top-k (models_tpu_torch.outputs.topk,
models_tpu_torch.ops.topk) against the JAX package's, on the CPU.

- The bin-quantized index equals JAX's BruteForce.index(dtype=int8) bit for
  bit: candidates, ids and scales.
- The binned route scores int8 x int8 in exact int32 in both packages, so its
  ids are equal and its scores bit-equal (phase A is torch._int_mm here).
- The direct and blockwise routes score fp32 queries against the int8 rows
  widened to fp32: scores within 1e-5 absolute (fp32 sums taken in another
  order), ids equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import models_tpu.ops.topk as jtopk
from models_tpu.outputs.topk import BruteForce as JBruteForce
from models_tpu_torch.ops import topk as ttopk
from models_tpu_torch.outputs.topk import BruteForce

ATOL = 1e-5


def _catalog(seed, n, D, dup=True):
    rng = np.random.default_rng(seed)
    # rows of several norms, so that the sort moves them; planted rows of
    # equal max |element| test that the sort is stable
    c = (rng.standard_normal((n, D)) * rng.uniform(0.2, 3.0, (n, 1))).astype(np.float32)
    if dup:
        c[n // 3] = c[5]
        c[n // 2] = -c[5]
        c[7, 0] = 0.0
        c[7] = 0.0  # an all-zero row
    ids = rng.permutation(10 * n)[:n].astype(np.int32)
    q = rng.standard_normal((24, D)).astype(np.float32)
    return q, c, ids


def _index_pair(c, ids):
    jbf = JBruteForce(k=10).index(jnp.asarray(c), jnp.asarray(ids), dtype=jnp.int8)
    tbf = BruteForce(k=10).index(c, ids, dtype=torch.int8, device="cpu")
    return jbf, tbf


@pytest.mark.parametrize("n", [64 * 9, 64 * 9 - 23, 50])
def test_int8_index_equals_jax_bit_for_bit(n):
    _, c, ids = _catalog(1, n, 16)
    jbf, tbf = _index_pair(c, ids)
    assert tbf.candidates.dtype == torch.int8 and tbf.n_valid == jbf.n_valid == n
    np.testing.assert_array_equal(tbf.candidates.numpy(), np.asarray(jbf.candidates.value))
    np.testing.assert_array_equal(tbf.ids.numpy(), np.asarray(jbf.ids.value))
    np.testing.assert_array_equal(tbf.scales.numpy().view(np.uint32),
                                  np.asarray(jbf.scales.value).view(np.uint32))
    assert tbf.scales_per_bin and jbf.scales_per_bin


@pytest.mark.parametrize("D", [32, 20])
@pytest.mark.parametrize("B", [1, 24])
@pytest.mark.parametrize("n", [64 * 80, 64 * 80 - 37])
def test_int8_index_serves_as_jax(n, B, D):
    """The layer's call: past one 4096-row tile the binned route, ids equal
    and scores bit-equal (both packages run eagerly here; under ``jax.jit``
    XLA may divide the query scale by 127 as a product with the reciprocal,
    one ulp off). D = 20 is no multiple of 8: the int8 product pads it."""
    q, c, ids = _catalog(2, n, D)
    jbf, tbf = _index_pair(c, ids)
    js, ji = jbf(jnp.asarray(q[:B]), k=10)
    tp = tbf(torch.from_numpy(q[:B]), k=10)
    np.testing.assert_array_equal(tp.identifiers.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tp.scores.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    # score_all: the (B, n) matrix of the dequantized rows, padding dropped
    jsa, jid = jbf.score_all(jnp.asarray(q[:B]))
    tsa, tid = tbf.score_all(torch.from_numpy(q[:B]))
    np.testing.assert_allclose(tsa.numpy(), np.asarray(jsa), rtol=0,
                               atol=ATOL * max(1.0, float(np.abs(jsa).max())))
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))


def _quantized(seed, C, D, per_bin=True):
    q, c, ids = _catalog(seed, C, D, dup=False)
    rng = np.random.default_rng(seed + 1)
    if per_bin:
        scale = np.repeat(rng.uniform(0.005, 0.03, -(-C // 64)), 64)[:C].astype(np.float32)
    else:
        scale = rng.uniform(0.005, 0.03, C).astype(np.float32)
    c8 = np.clip(np.round(c / scale[:, None]), -127, 127).astype(np.int8)
    return q, c8, ids, scale


# (C, n_valid, per_bin, scaled): whole bins, padding masked by n_valid, a
# tail of rows past the last bin, per-row scales, no scale at all, and a
# catalog of fewer than k + 1 bins
BINNED = {
    "bins": (64 * 30, None, True, True),
    "padded": (64 * 30, 64 * 30 - 41, True, True),
    "tail": (64 * 30 + 17, None, True, True),
    "per-row": (64 * 30, 64 * 30 - 5, False, True),
    "unscaled": (64 * 30, None, True, False),
    "few-bins": (64 * 8 + 3, 64 * 8 - 1, True, True),
}


@pytest.mark.parametrize("D", [32, 13])
@pytest.mark.parametrize("case", sorted(BINNED))
def test_binned_int8_equals_jax_bit_for_bit(case, D):
    """Every case at D = 32 and at D = 13, which the int8 product pads to a
    multiple of 8 with zeros."""
    C, n_valid, per_bin, scaled = BINNED[case]
    q, c8, ids, scale = _quantized(3, C, D, per_bin)
    k = 10
    js, ji = jtopk.binned_topk(jnp.asarray(q), jnp.asarray(c8), k, ids=jnp.asarray(ids),
                               n_valid=n_valid, col_scale=jnp.asarray(scale) if scaled else None,
                               col_scale_per_bin=per_bin)
    ts, ti = ttopk.binned_topk(q, torch.from_numpy(c8), k, ids=ids, n_valid=n_valid,
                               col_scale=scale if scaled else None, col_scale_per_bin=per_bin,
                               device="cpu")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))


def test_int8_rescore_plain_matches_jax_gather_einsum():
    """K5's int8 form (its plain version here): the exact int32 dot of each
    int8 query row with the rows of its selected bins, JAX's XLA gather and
    integer einsum."""
    rng = np.random.default_rng(4)
    B, D, L, bs, kb = 9, 40, 20, 64, 5
    q8 = rng.integers(-127, 128, (B, D)).astype(np.int8)
    c8 = rng.integers(-127, 128, (L * bs, D)).astype(np.int8)
    idx = rng.integers(0, L, (B, kb)).astype(np.int32)
    gathered = jnp.take(jnp.asarray(c8).reshape(L, bs, D), jnp.asarray(idx), axis=0)
    ref = jnp.einsum("bd,bksd->bks", jnp.asarray(q8), gathered,
                     preferred_element_type=jnp.int32).reshape(B, kb * bs)
    got = ttopk.binned_rescore(torch.from_numpy(q8), torch.from_numpy(c8),
                               torch.from_numpy(idx), bs)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="int8"):  # int8 rows want int8 queries
        ttopk.binned_rescore(torch.from_numpy(q8).float(), torch.from_numpy(c8),
                             torch.from_numpy(idx), bs)


@pytest.mark.parametrize("C,n_valid", [(3000, None), (64 * 100, 64 * 100 - 9)])
def test_direct_and_blockwise_int8_match_jax(C, n_valid):
    """fp32 queries against int8 rows times each row's scale, not quantized:
    the direct route (C <= tile) and the blockwise scan (forced)."""
    q, c8, ids, scale = _quantized(5, C, 32, per_bin=False)
    k = 10
    for method in ("auto", "blockwise"):
        js, ji = jtopk.topk_scores(jnp.asarray(q), jnp.asarray(c8), k, ids=jnp.asarray(ids),
                                   tile=4096 if method == "auto" else 1024, method=method,
                                   n_valid=n_valid, col_scale=jnp.asarray(scale))
        ts, ti = ttopk.topk_scores(q, torch.from_numpy(c8), k, ids=ids,
                                   tile=4096 if method == "auto" else 1024, method=method,
                                   n_valid=n_valid, col_scale=scale, device="cpu")
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=ATOL)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # the streaming kernel's plain version computes the blockwise function
    c_t = torch.from_numpy(c8)[:n_valid] if n_valid else torch.from_numpy(c8)
    ss, si = ttopk.streaming_topk(torch.from_numpy(q), c_t.contiguous(), k,
                                  scale=torch.from_numpy(scale[: c_t.shape[0]]).contiguous())
    js, ji = jtopk.blockwise_topk(jnp.asarray(q), jnp.asarray(c8[: c_t.shape[0]]), k,
                                  col_scale=jnp.asarray(scale[: c_t.shape[0]]))
    np.testing.assert_allclose(ss.numpy(), np.asarray(js), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(si.numpy(), np.asarray(ji))


@pytest.mark.parametrize("B", [1, 64, 8192])
def test_int8_dispatch_takes_jax_route(B, monkeypatch):
    """topk_scores on an int8 index takes the route JAX takes (off the TPU):
    direct, binned while the pool fits, blockwise beyond (C > tile)."""
    C, D, k = 64 * 80, 32, 10
    q = np.random.default_rng(6).standard_normal((B, D)).astype(np.float32)
    _, c8, ids, scale = _quantized(6, C, D)
    calls = []
    for name in ("binned_topk", "blockwise_topk"):
        orig = getattr(jtopk, name)
        monkeypatch.setattr(jtopk, name,
                            lambda *a, _o=orig, _n=name, **kw: calls.append(_n) or _o(*a, **kw))
    for tile in (8192, 4096):
        calls.clear()
        js, ji = jtopk.topk_scores(jnp.asarray(q), jnp.asarray(c8), k, ids=jnp.asarray(ids),
                                   tile=tile, col_scale=jnp.asarray(scale),
                                   col_scale_per_bin=True)
        route = ttopk.topk_route(B, C, D, k, tile=tile)
        jroute = calls[0].replace("_topk", "") if calls else "direct"
        assert route == jroute, (B, tile, calls)
        ts, ti = ttopk.topk_scores(q, torch.from_numpy(c8), k, ids=ids, tile=tile,
                                   col_scale=scale, col_scale_per_bin=True, device="cpu")
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=ATOL)
    assert ttopk.topk_route(8192, C, D, k, on_cuda=True) == "streaming"
