"""The port's row scatters against the JAX package's, on the CPU.

The JAX scatters run their Pallas kernels in interpret mode: D = 128 and
R % 8 == 0, because any other width takes their XLA route. The port's
wrappers take their plain versions for CPU tensors. Writes and adds are held
to exact equality (one fp32 add or one copy per element on both sides, and
round-to-nearest of a bf16 sum on both); ``dedup_rows``'s segment sums to
rtol 1e-6, atol 1e-6 (fp32 sums in another order); ``stochastic_round``
bit for bit, fed the same ``jax.random.bits``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from models_tpu.ops import scatter as J

from models_tpu_torch.ops import scatter as S

R, D = 64, 128
# ids of a deduplicated batch: a stale duplicate (3), an id out of range and a
# negative one on invalid positions, the table's first and last rows
IDS = np.array([3, 9, 3, 17, 999_999, 63, 0, -5, 40, 41], np.int32)
VALID = np.array([1, 1, 0, 1, 0, 1, 1, 0, 1, 1], bool)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((R, D)).astype(np.float32),
            rng.standard_normal((len(IDS), D)).astype(np.float32))


def _bits(x: torch.Tensor) -> np.ndarray:
    """The raw bits of a float32 or bfloat16 tensor."""
    x = x.contiguous()
    return (x.view(torch.int32) if x.dtype == torch.float32 else x.view(torch.int16)).numpy()


def _jax_bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int32 if x.dtype == np.float32 else np.int16)


def test_dedup_rows_matches_jax():
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 40, 257).astype(np.int32)  # many repeats
    rows = rng.standard_normal((257, 16)).astype(np.float32)
    jsids, jsum, jstart = (np.asarray(a) for a in J.dedup_rows(jnp.asarray(ids),
                                                               jnp.asarray(rows)))
    sids, summed, start = S.dedup_rows(torch.tensor(ids), torch.tensor(rows))
    np.testing.assert_array_equal(sids.numpy(), jsids)
    np.testing.assert_array_equal(start.numpy(), jstart)
    np.testing.assert_allclose(summed.numpy(), jsum, rtol=1e-6, atol=1e-6)
    assert summed.shape == rows.shape and int(start.sum()) == len(np.unique(ids))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_scatter_add_matches_the_pallas_kernel(dtype):
    table, upd = _inputs(1)
    jt = jnp.asarray(table, dtype)
    want = J.pallas_row_scatter_add(jt, jnp.asarray(IDS), jnp.asarray(upd), jnp.asarray(VALID),
                                    block=4, n_buf=2, interpret=True)
    tt = torch.tensor(np.asarray(jt, np.float32)).to(getattr(torch, dtype))
    got = S.row_scatter_add(tt, torch.tensor(IDS), torch.tensor(upd), torch.tensor(VALID))
    assert got is tt and got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_bits(got), _jax_bits(want))


def _batch(n, rows, seed):
    """n positions of a deduplicated batch into ``rows`` rows: unique valid
    ids, and invalid positions (about a fifth) holding -7 or rows + 7."""
    rng = np.random.default_rng(seed)
    ids = rng.permutation(rows)[:n].astype(np.int32)
    valid = rng.uniform(size=n) < 0.8
    at = np.arange(n)
    ids[~valid] = np.where(at[~valid] % 2 == 0, -7, rows + 7)
    return ids, valid


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 31, 33, 257])
def test_row_scatter_add_matches_the_pallas_kernel_at_batch_edges(n, dtype):
    """N around the card kernel's batches of positions (8 a warp, 32 ids a
    load): one position, ragged last batches, N past 32 * 8."""
    rows = 512
    ids, valid = _batch(n, rows, n)
    rng = np.random.default_rng(n + 1)
    table = rng.standard_normal((rows, D)).astype(np.float32)
    upd = rng.standard_normal((n, D)).astype(np.float32)
    jt = jnp.asarray(table, dtype)
    want = J.pallas_row_scatter_add(jt, jnp.asarray(ids), jnp.asarray(upd), jnp.asarray(valid),
                                    block=4, n_buf=2, interpret=True)
    tt = torch.tensor(np.asarray(jt, np.float32)).to(getattr(torch, dtype))
    got = S.row_scatter_add(tt, torch.tensor(ids), torch.tensor(upd), torch.tensor(valid))
    assert got is tt
    np.testing.assert_array_equal(_bits(got), _jax_bits(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_scatter_write_matches_the_pallas_kernel(dtype):
    table, rows = _inputs(2)
    jt, jr = jnp.asarray(table, dtype), jnp.asarray(rows, dtype)
    want = J.pallas_row_scatter_write(jt, jnp.asarray(IDS), jr, jnp.asarray(VALID),
                                      block=4, n_buf=2, interpret=True)
    tdt = getattr(torch, dtype)
    tt = torch.tensor(np.asarray(jt, np.float32)).to(tdt)
    got = S.row_scatter_write(tt, torch.tensor(IDS), torch.tensor(np.asarray(jr, np.float32))
                              .to(tdt), torch.tensor(VALID))
    assert got is tt
    np.testing.assert_array_equal(_bits(got), _jax_bits(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 7, 9, 31, 33, 257])
def test_row_scatter_write_matches_the_pallas_kernel_at_batch_edges(n, dtype):
    """N around the card kernel's batches (8 positions a warp, their ids in
    one load, the batch's rows one run of 16-byte pieces): one position, a
    batch short by one, one past a batch, ragged last batches, N past 32 * 8.
    Out-of-range ids sit on invalid positions only (the Pallas kernel writes
    a valid position's id as it is)."""
    rows = 512
    ids, valid = _batch(n, rows, 100 + n)
    rng = np.random.default_rng(n + 2)
    table = rng.standard_normal((rows, D)).astype(np.float32)
    src = rng.standard_normal((n, D)).astype(np.float32)
    jt, jr = jnp.asarray(table, dtype), jnp.asarray(src, dtype)
    want = J.pallas_row_scatter_write(jt, jnp.asarray(ids), jr, jnp.asarray(valid),
                                      block=4, n_buf=2, interpret=True)
    tdt = getattr(torch, dtype)
    tt = torch.tensor(np.asarray(jt, np.float32)).to(tdt)
    got = S.row_scatter_write(tt, torch.tensor(ids), torch.tensor(np.asarray(jr, np.float32))
                              .to(tdt), torch.tensor(valid))
    assert got is tt
    np.testing.assert_array_equal(_bits(got), _jax_bits(want))


def test_rows_of_invalid_positions_and_of_no_id_stay():
    table, upd = _inputs(3)
    got = S.row_scatter_add(torch.tensor(table), torch.tensor(IDS), torch.tensor(upd),
                            torch.tensor(VALID)).numpy()
    touched = sorted(set(IDS[VALID].tolist()))
    assert touched == [0, 3, 9, 17, 40, 41, 63]
    others = np.setdiff1d(np.arange(R), touched)
    np.testing.assert_array_equal(got[others], table[others])
    # no valid position at all, and valid=None (every position)
    t = torch.tensor(table)
    S.row_scatter_add(t, torch.tensor(IDS), torch.tensor(upd), torch.zeros(len(IDS), dtype=bool))
    np.testing.assert_array_equal(t.numpy(), table)
    ids = torch.tensor([5], dtype=torch.int32)
    S.row_scatter_write(t, ids, torch.tensor(upd[:1]))
    np.testing.assert_array_equal(t.numpy()[5], upd[0])


def test_stochastic_round_matches_jax_bit_for_bit():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(4096) * 10.0 ** rng.integers(-40, 38, 4096)).astype(np.float32)
    special = np.array([0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000, 0x7F800001,
                        0xFFABCDEF, 0x7F7FFFFF, 0xFF7FFFFF, 0x00000001, 0x80000000,
                        0x3F800000, 0xBF7FFFFF], np.uint32).view(np.float32)
    x[:len(special)] = special
    x = x.reshape(64, 64)
    key = jax.random.key(3)
    want = J.stochastic_round(jnp.asarray(x), key)
    noise = np.asarray(jax.random.bits(key, x.shape, jnp.uint32)).view(np.int32)
    got = S.stochastic_round(torch.tensor(x), torch.tensor(noise))
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    np.testing.assert_array_equal(_bits(got), _jax_bits(want))
    with pytest.raises(ValueError, match="noise"):
        S.stochastic_round(torch.tensor(x), torch.tensor(noise[:2]))


def test_wrappers_take_the_plain_version_for_cpu_tensors():
    table, upd = _inputs(6)
    before = S.row_scatter_add.launches, S.row_scatter_write.launches
    want = S.row_scatter_add_plain(torch.tensor(table), torch.tensor(IDS), torch.tensor(upd),
                                   torch.tensor(VALID))
    got = S.row_scatter_add(torch.tensor(table), torch.tensor(IDS), torch.tensor(upd),
                            torch.tensor(VALID))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    want = S.row_scatter_write_plain(torch.tensor(table), torch.tensor(IDS), torch.tensor(upd),
                                     torch.tensor(VALID))
    got = S.row_scatter_write(torch.tensor(table), torch.tensor(IDS), torch.tensor(upd),
                              torch.tensor(VALID))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (S.row_scatter_add.launches, S.row_scatter_write.launches) == before


BAD = {
    "ids int64": lambda t, i, u, v: (t, i.long(), u, v),
    "ids 2-D": lambda t, i, u, v: (t, i[None], u, v),
    "rows too few": lambda t, i, u, v: (t, i, u[:-1], v),
    "rows too narrow": lambda t, i, u, v: (t, i, u[:, :-1].contiguous(), v),
    "rows not contiguous": lambda t, i, u, v: (t, i, u.T.contiguous().T, v),
    "rows bf16": lambda t, i, u, v: (t, i, u.bfloat16(), v),
    "valid int": lambda t, i, u, v: (t, i, u, v.int()),
    "valid short": lambda t, i, u, v: (t, i, u, v[:-1]),
    "table int": lambda t, i, u, v: (t.int(), i, u, v),
    "table float64": lambda t, i, u, v: (t.double(), i, u, v),
    "table 1-D": lambda t, i, u, v: (t[0], i, u, v),
}


@pytest.mark.parametrize("fn", ["row_scatter_add", "row_scatter_write"])
@pytest.mark.parametrize("case", sorted(BAD))
def test_wrappers_refuse_mismatched_shapes_and_dtypes(fn, case):
    table, upd = _inputs(7)
    args = BAD[case](torch.tensor(table), torch.tensor(IDS), torch.tensor(upd),
                     torch.tensor(VALID))
    with pytest.raises(ValueError):
        getattr(S, fn)(*args)


def test_write_refuses_rows_of_another_dtype_than_the_table():
    table, rows = _inputs(8)
    with pytest.raises(ValueError, match="bfloat16"):
        S.row_scatter_write(torch.tensor(table).bfloat16(), torch.tensor(IDS),
                            torch.tensor(rows), torch.tensor(VALID))
