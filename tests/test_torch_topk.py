"""The port's top-k (models_tpu_torch.ops.topk) against the JAX package's
(models_tpu.ops.topk) on the CPU: the same seeded numpy inputs go to both.

The Pallas kernels run in interpret mode, as tests/unit/test_ops.py runs them;
the port's kernel wrappers take their plain versions on CPU tensors. Scores
agree within 1e-5 absolute (fp32 sums taken in another order); ids are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import models_tpu.ops.topk as jtopk
from models_tpu_torch.ops import topk as ttopk

ATOL = 1e-5


def _inputs(seed, B, C, D, integer=False):
    rng = np.random.default_rng(seed)
    if integer:  # every product and sum is exact: ties are exact in any order
        q = rng.integers(-3, 4, size=(B, D)).astype(np.float32)
        c = rng.integers(-3, 4, size=(C, D)).astype(np.float32)
    else:
        q = rng.standard_normal((B, D)).astype(np.float32)
        c = rng.standard_normal((C, D)).astype(np.float32)
    ids = rng.permutation(10 * C)[:C].astype(np.int32)
    return q, c, ids


def _jax_cand(c, dtype):
    return jnp.asarray(c).astype(jnp.bfloat16 if dtype == "bf16" else jnp.float32)


def _torch_cand(c, dtype):
    return torch.from_numpy(c).to(torch.bfloat16 if dtype == "bf16" else torch.float32)


def _assert_same(port, ref):
    (ps, pi), (rs, ri) = port, ref
    np.testing.assert_allclose(np.asarray(ps), np.asarray(rs), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(np.asarray(pi), np.asarray(ri))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("C,k,n_valid", [(300, 7, None), (300, 7, 260), (40, 50, None)])
def test_streaming_plain_matches_pallas_topk(dtype, C, k, n_valid):
    """streaming_topk on CPU tensors (its plain version) == pallas_topk
    (interpret) == blockwise_topk, padding and k > C included."""
    q, c, ids = _inputs(1, 6, C, 16)
    n = C if n_valid is None else n_valid
    ref = jtopk.pallas_topk(jnp.asarray(q), _jax_cand(c, dtype)[:n], k,
                            ids=jnp.asarray(ids[:n]), tile=128, interpret=True)
    ref_bw = jtopk.blockwise_topk(jnp.asarray(q), _jax_cand(c, dtype)[:n], k,
                                  ids=jnp.asarray(ids[:n]), tile=128)
    before = ttopk.streaming_topk.launches
    port = ttopk.streaming_topk(torch.from_numpy(q), _torch_cand(c, dtype), k,
                                ids=torch.from_numpy(ids), n_valid=n_valid)
    assert ttopk.streaming_topk.launches == before  # CPU tensors: no kernel
    _assert_same(port, ref)
    _assert_same(port, ref_bw)
    port_bw = ttopk.blockwise_topk(q, _torch_cand(c, dtype)[:n], k, ids=ids[:n],
                                   tile=128, device="cpu")
    _assert_same(port_bw, ref)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_streaming_plain_matches_blockwise_at_large_k(dtype):
    """k = 600 over 1,000 rows, past the 512 the card's earlier kernel held:
    streaming_topk on CPU tensors (its plain version) == JAX's blockwise_topk
    (pallas_topk in interpret mode unrolls k rounds, too slow at this k),
    with padding rows that never rank."""
    q, c, ids = _inputs(6, 5, 1000, 16)
    n, k = 990, 600
    ref = jtopk.blockwise_topk(jnp.asarray(q), _jax_cand(c, dtype)[:n], k,
                               ids=jnp.asarray(ids[:n]), tile=256)
    port = ttopk.streaming_topk(torch.from_numpy(q), _torch_cand(c, dtype), k,
                                ids=torch.from_numpy(ids), n_valid=n)
    _assert_same(port, ref)


def test_planted_ties_resolve_to_lowest_position():
    """Duplicated rows score bitwise alike; every route ranks the copy at the
    lowest position first, as lax.top_k and pallas_topk do."""
    q, c, ids = _inputs(2, 5, 600, 16, integer=True)
    for dup in (100, 377, 599):
        c[dup] = c[3]
    c[450] = c[200]
    qj, cj, ij = jnp.asarray(q), jnp.asarray(c), jnp.asarray(ids)
    qt, ct, it = torch.from_numpy(q), torch.from_numpy(c), torch.from_numpy(ids)
    k = 40
    ref = jtopk.pallas_topk(qj, cj, k, ids=ij, tile=128, interpret=True)
    _assert_same(ttopk.streaming_topk(qt, ct, k, ids=it), ref)
    _assert_same(ttopk.blockwise_topk(q, c, k, ids=ids, tile=128, device="cpu"), ref)
    _assert_same(ttopk.binned_topk(q, c, 3, ids=ids, device="cpu"),
                 jtopk.binned_topk(qj, cj, 3, ids=ij))
    _assert_same(ttopk.topk_scores(q, c, k, ids=ids, device="cpu"),
                 jtopk.topk_scores(qj, cj, k, ids=ij))
    # the kernel's own order: within a run of equal scores, positions ascend
    s, pos = ttopk.streaming_topk(qt, ct, k)
    s, pos = s.numpy(), pos.numpy()
    same = s[:, 1:] == s[:, :-1]
    assert same.any()
    assert (pos[:, 1:][same] > pos[:, :-1][same]).all()


@pytest.mark.parametrize("dtype,B", [("fp32", 13), ("bf16", 8)])
def test_binned_rescore_plain_matches_pallas(dtype, B):
    from models_tpu.ops.topk import _binned_rescore

    rng = np.random.default_rng(B)
    D, kb, bs, L = 128, 3, 64, 20
    c = rng.standard_normal((L * bs, D)).astype(np.float32)
    q = rng.standard_normal((B, D)).astype(np.float32)
    idx = rng.integers(0, L, size=(B, kb)).astype(np.int32)
    ref = _binned_rescore(jnp.asarray(q), _jax_cand(c, dtype), jnp.asarray(idx), bs,
                          interpret=True)
    before = ttopk.binned_rescore.launches
    port = ttopk.binned_rescore(torch.from_numpy(q), _torch_cand(c, dtype),
                                torch.from_numpy(idx), bs)
    assert ttopk.binned_rescore.launches == before
    assert port.shape == (B, kb * bs) and port.dtype == torch.float32
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        port.numpy(),
        ttopk.binned_rescore_plain(torch.from_numpy(q), _torch_cand(c, dtype),
                                   torch.from_numpy(idx), bs).numpy(),
    )


def _padded(c, ids, n_valid):
    pad = (-n_valid) % 64
    c = np.concatenate([c[:n_valid], np.zeros((pad, c.shape[1]), np.float32)])
    ids = np.concatenate([ids[:n_valid], np.full(pad, -1, np.int32)])
    return c, ids


# (C, k, n_valid): n_valid padding; a tail r > 0; L <= k; the pool at its edge
BINNED_CASES = [(1000, 10, 1000), (1000, 5, None), (300, 5, None), (1280, 7, 1250),
                (4200, 10, None)]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("C,k,n_valid", BINNED_CASES)
def test_binned_topk_matches_jax(dtype, C, k, n_valid):
    q, c, ids = _inputs(3, 9, C, 32)
    if n_valid is not None:
        c, ids = _padded(c, ids, n_valid)
    ref = jtopk.binned_topk(jnp.asarray(q), _jax_cand(c, dtype), k, ids=jnp.asarray(ids),
                            n_valid=n_valid)
    port = ttopk.binned_topk(q, _torch_cand(c, dtype), k, ids=ids, n_valid=n_valid,
                             device="cpu")
    _assert_same(port, ref)
    # the same through the dispatch, which takes the binned route above one tile
    _assert_same(
        ttopk.topk_scores(q, _torch_cand(c, dtype), k, ids=ids, n_valid=n_valid,
                          tile=256, device="cpu"),
        jtopk.topk_scores(jnp.asarray(q), _jax_cand(c, dtype), k, ids=jnp.asarray(ids),
                          n_valid=n_valid, tile=256),
    )


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("method", ["auto", "blockwise"])
def test_topk_scores_direct_and_blockwise_match_jax(dtype, method):
    """C <= tile takes the direct route; 'blockwise' drops the padding."""
    q, c, ids = _inputs(4, 7, 700, 24)
    c, ids = _padded(c, ids, 700)
    ref = jtopk.topk_scores(jnp.asarray(q), _jax_cand(c, dtype), 9, ids=jnp.asarray(ids),
                            n_valid=700, method=method)
    port = ttopk.topk_scores(q, _torch_cand(c, dtype), 9, ids=ids, n_valid=700,
                             method=method, device="cpu")
    _assert_same(port, ref)
    assert port[1].dtype == torch.int32


SHAPES = [  # (B, C, D, k)
    (256, 1000, 128, 10),  # one tile: direct
    (256, 56704, 128, 10),  # binned
    (1365, 56704, 128, 10),  # the pool just fits: binned
    (1366, 56704, 128, 10),  # one row more: streaming on the card
    (4096, 56704, 128, 10),
    (2048, 1_000_000, 128, 10),
]


@pytest.mark.parametrize("on_card", [False, True])
def test_dispatch_picks_the_jax_route(monkeypatch, on_card):
    """topk_route names the route JAX's topk_scores takes for the same shapes,
    with JAX's "on the TPU" read as "on the card"."""
    taken = []

    def recorder(name):
        def fn(q, c, k, *a, **kw):
            taken.append(name)
            return None, None
        return fn

    monkeypatch.setattr(jtopk, "binned_topk", recorder("binned"))
    monkeypatch.setattr(jtopk, "pallas_topk", recorder("streaming"))
    monkeypatch.setattr(jtopk, "blockwise_topk", recorder("blockwise"))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu" if on_card else "cpu")
    for B, C, D, k in SHAPES:
        taken.clear()
        q = np.zeros((B, D), np.float32)
        c = np.broadcast_to(np.zeros((1, D), np.float32), (C, D))
        if C <= 4096:
            jtopk.topk_scores(jnp.asarray(q), jnp.asarray(c), k)
        else:
            jtopk.topk_scores(q, c, k)
        jax_route = taken[0] if taken else "direct"
        assert ttopk.topk_route(B, C, D, k, on_cuda=on_card) == jax_route, (B, C)


def test_ids_agree_allows_only_near_ties():
    s = np.array([[3.0, 2.0, 2.0 + 1e-7, 1.0]])
    assert ttopk.ids_agree(s, [[1, 2, 3, 4]], s, [[1, 3, 2, 4]], 1e-5)
    assert not ttopk.ids_agree(s, [[1, 2, 3, 4]], s, [[2, 1, 3, 4]], 1e-5)
    assert not ttopk.ids_agree(s, [[1, 2, 3, 4]], s + 1e-3, [[1, 2, 3, 4]], 1e-5)


@pytest.mark.parametrize("k", [1, 10, 300, 400])
@pytest.mark.parametrize("ties", [False, True])
def test_stable_topk_ranks_as_lax_top_k(ties, k):
    """The CPU's selection (torch.topk where it is unambiguous, else the
    stable sort) ranks by (score desc, position asc), as lax.top_k does;
    with ties also over -0.0 and +0.0 (equal scores) and NEG_INF padding,
    against a stable sort. k past the width gives every column."""
    rng = np.random.default_rng(11)
    if ties:
        x = (rng.integers(-3, 4, size=(64, 300)) * 0.5).astype(np.float32)
    else:
        x = rng.standard_normal((64, 300)).astype(np.float32)
    s, i = ttopk.stable_topk(torch.from_numpy(x), k)
    js, ji = jax.lax.top_k(jnp.asarray(x), min(k, 300))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(s.numpy().view(np.uint32), np.asarray(js).view(np.uint32))
    if ties:
        y = torch.from_numpy(x)
        y[y == 0] = -0.0
        y[:, ::7] = 0.0
        y[:, 5] = ttopk.NEG_INF
        ws, wi = torch.sort(y, dim=1, descending=True, stable=True)
        s, i = ttopk.stable_topk(y, k)
        assert torch.equal(i, wi[:, :k])
        assert torch.equal(s.view(torch.int32), ws[:, :k].view(torch.int32))
