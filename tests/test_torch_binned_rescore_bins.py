"""The bin-major schedule of the card's K5 (``csrc/binned_rescore.cu::
rescore_bins``), modelled on the CPU by ``models_tpu_torch.ops.topk.
rescore_schedule``, against the JAX package's phase-B rescore.

A bin's pairs from one group of query rows form a key; each block owns the
keys ``key % blocks == g``, scans the selections a window at a time, and takes
its keys in items of a few pairs, each one copy of the bin scored against the
item's query rows; block 0 fills the positions of bins out of range. The
model follows that schedule with plain products: fp32 and bf16 catalogs
within 1e-5 (rtol and atol) of JAX's ``_binned_rescore`` run in interpret
mode (fp32 sums in another order), int8 bit for bit the port's
``binned_rescore_plain`` (exact int32 sums) on
``tests/test_torch_topk_int8``'s inputs. Every output has exactly one writer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from models_tpu.ops.topk import _binned_rescore
from models_tpu_torch.ops import topk as T
from tests.test_torch_topk_int8 import _quantized

D, BS, L = 128, 64, 12
NAN_BITS, INT_MISSING = 0x7FC00000, np.iinfo(np.int32).min


def _selections(case):
    """(bin_idx (B, kb), blocks, window, query_group, pairs_per_item) of each
    case."""
    rng = np.random.default_rng(len(case))
    if case == "random":  # groups of 4 query rows, items of 2 pairs
        return rng.integers(0, L, (13, 3)).astype(np.int32), 4, 4096, 4, 2
    if case == "every query the same bins":  # one group: 11 pairs a bin, 3 items
        return np.tile(np.array([[2, 7, 5]], np.int32), (11, 1)), 4, 4096, 64, 4
    if case == "one block owns every pair":  # one group, bins 1, 5, 9: all 1 mod 4
        return rng.choice([1, 5, 9], (9, 3)).astype(np.int32), 4, 4096, 64, 16
    if case == "kb=1 B=1":
        return np.array([[L - 1]], np.int32), 4, 4096, 64, 16
    if case == "out of range":
        idx = rng.integers(0, L, (8, 3)).astype(np.int32)
        idx[1, 2], idx[6, 0] = -1, L
        return idx, 4, 4096, 2, 16
    if case == "windows":  # 39 selections in windows of 8: bins read more than once
        return rng.integers(0, 5, (13, 3)).astype(np.int32), 3, 8, 64, 16
    raise ValueError(case)


CASES = ["random", "every query the same bins", "one block owns every pair", "kb=1 B=1",
         "out of range", "windows"]


def _by_bins(q, c, idx, blocks, window, qg, ppi):
    """K5 by the schedule: per block, per window, per item one copy of its
    bin (counted) and one product with the query rows of its pairs."""
    B, kb = idx.shape
    groups = -(-B // qg)
    plan, missing = T.rescore_schedule(idx, c.shape[0] // BS, blocks, window, qg, ppi)
    is_int = c.dtype == torch.int8
    out = torch.zeros(B * kb, BS, dtype=torch.int32 if is_int else torch.float32)
    writers = torch.zeros(B * kb, dtype=torch.int64)
    copies = 0
    for g, windows in enumerate(plan):
        assert len(windows) == -(-B * kb // window)
        for w, items in enumerate(windows):
            keys = []
            for n, entries in items:
                e = torch.tensor(entries)
                assert 1 <= len(entries) <= ppi
                assert ((e >= w * window) & (e < (w + 1) * window)).all()
                assert (idx.reshape(-1)[e] == n).all()
                key = {n * groups + b // qg for b in (e // kb).tolist()}
                assert len(key) == 1 and min(key) % blocks == g  # one key, this block's
                keys.append(min(key))
                rows = c[n * BS:(n + 1) * BS]
                copies += 1
                if is_int:
                    out[e] = (q[e // kb].long() @ rows.long().T).to(torch.int32)
                else:
                    out[e] = q[e // kb] @ rows.float().T
                writers[e] += 1
            assert keys == sorted(keys)
    m = torch.tensor(missing, dtype=torch.int64)
    out[m] = INT_MISSING if is_int else torch.tensor(NAN_BITS, dtype=torch.int32).view(
        torch.float32)
    writers[m] += 1
    assert (writers == 1).all()  # one writer an output
    return out.reshape(B, kb * BS), copies, missing


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("case", CASES)
def test_bin_major_schedule_matches_the_rescore(case, dtype):
    idx, blocks, window, qg, ppi = _selections(case)
    B, kb = idx.shape
    if dtype == "int8":
        _, c8, _, _ = _quantized(3, L * BS, D)
        q8 = np.random.default_rng(5).integers(-127, 128, (B, D)).astype(np.int8)
        q, c = torch.from_numpy(q8), torch.from_numpy(c8)
    else:
        rng = np.random.default_rng(B + kb)
        q = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
        c = torch.from_numpy(rng.standard_normal((L * BS, D)).astype(np.float32))
        c = c.to(torch.bfloat16) if dtype == "bf16" else c
    got, copies, missing = _by_bins(q, c, torch.from_numpy(idx), blocks, window, qg, ppi)

    # copies: each (window, bin, group of query rows) once per ppi of its pairs
    flat = idx.reshape(-1)
    per_key = {}
    for e, n in enumerate(flat.tolist()):
        if 0 <= n < L:
            key = (e // window, n, e // kb // qg)
            per_key[key] = per_key.get(key, 0) + 1
    assert copies == sum(-(-m // ppi) for m in per_key.values())
    assert missing == [e for e, n in enumerate(flat) if not 0 <= n < L]

    clamped = np.clip(idx, 0, L - 1)  # the reference's in-range stand-in
    bad = np.repeat(~((idx >= 0) & (idx < L)), BS, axis=1)
    if dtype == "int8":
        want = T.binned_rescore_plain(q, c, torch.from_numpy(clamped), BS).numpy()
        g = got.numpy()
        np.testing.assert_array_equal(g[~bad], want[~bad])
        assert (g[bad] == INT_MISSING).all()
        return
    cj = jnp.asarray(c.float().numpy()).astype(jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    want = np.asarray(_binned_rescore(jnp.asarray(q.numpy()), cj, jnp.asarray(clamped), BS,
                                      interpret=True))
    g = got.numpy()
    np.testing.assert_allclose(g[~bad], want[~bad], rtol=1e-5, atol=1e-5)
    assert (g[bad].view(np.uint32) == NAN_BITS).all()


def test_a_popular_bin_is_spread_over_blocks_by_query_group():
    """Skew: every position on one bin. In one group of query rows its owner
    holds all B * kb pairs in one window (items of 16 pairs, the bin copied
    once an item); in groups of 8 rows the bin's keys fall to different
    blocks."""
    idx = torch.full((40, 5), 6, dtype=torch.int32)
    plan, missing = T.rescore_schedule(idx, L, 4, 4096, 64, 16)
    assert missing == []
    assert [len(w[0]) for w in plan] == [0, 0, 13, 0]
    assert [e for _, pairs in plan[2][0] for e in pairs] == list(range(200))
    plan, _ = T.rescore_schedule(idx, L, 4, 4096, 8, 16)
    # keys 6 * 5 + h for the groups h = 0..4: blocks 2, 3, 0, 1, 2
    assert [sum(len(p) for _, p in w[0]) for w in plan] == [40, 40, 80, 40]
