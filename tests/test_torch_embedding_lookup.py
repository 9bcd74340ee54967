"""The port's row gather (models_tpu_torch.ops.embedding_lookup, K9) against
the JAX package's pallas_gather, on the CPU.

pallas_gather runs in interpret mode, as tests/unit/test_ops.py runs it; the
port's wrapper takes its plain version on CPU tensors. A gather copies rows,
so the results are equal bit for bit. Ids outside the table are clamped, as
the JAX package's jnp.take(mode="clip") fallback does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from models_tpu.ops.embedding_lookup import pallas_gather as jax_gather
from models_tpu_torch.ops import embedding_lookup as E

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
          "fp16": (jnp.float16, torch.float16)}


def _bits(x):
    return np.asarray(x).view(np.uint32 if np.asarray(x).dtype.itemsize == 4 else np.uint16)


def _pair(seed, shape, dtype):
    jdt, tdt = DTYPES[dtype]
    t = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(t, jdt), torch.from_numpy(t).to(tdt)


def _assert_same(port, ref):
    port = port.view(torch.int32 if port.element_size() == 4 else torch.int16).numpy()
    assert port.shape == np.asarray(ref).shape
    np.testing.assert_array_equal(port.view(_bits(ref).dtype), _bits(ref))


# the cases of tests/unit/test_ops.py: duplicates and a batch that is not a
# multiple of the grid block (fp32), every in-block offset and block
# boundaries for 16-bit tables, odd shapes (R % 8 != 0 takes jnp.take, D = 7)
CASES = {
    "fp32-dups-padding": (3, (64, 8), "fp32", [0, 63, 7, 7, 7, 12, 1], 4),
    "bf16-block-select": (4, (32, 8), "bf16", [0, 1, 30, 31, 7, 8, 7, 16, 23, 9], 4),
    "fp16-block-select": (4, (32, 8), "fp16", [0, 1, 30, 31, 7, 8, 7, 16, 23, 9], 4),
    "bf16-rows-not-8": (5, (33, 8), "bf16", [0, 32, 3], 256),
    "bf16-odd-width": (5, (32, 7), "bf16", [0, 31, 3], 256),
    "fp32-one-id": (6, (50, 7), "fp32", [49], 256),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_row_gather_matches_pallas_gather(case):
    seed, shape, dtype, ids, block = CASES[case]
    jt, tt = _pair(seed, shape, dtype)
    ref = jax_gather(jt, jnp.asarray(ids, jnp.int32), block=block, interpret=True)
    got = E.row_gather(tt, torch.tensor(ids, dtype=torch.int32))
    assert got.dtype == tt.dtype
    _assert_same(got, ref)
    assert E.pallas_gather is E.row_gather


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_out_of_range_ids_clamp_as_jnp_take_clip(dtype):
    jt, tt = _pair(7, (33, 6), dtype)
    ids = [-5, 0, 32, 33, 1000, -1, 17]
    ref = jnp.take(jt, jnp.asarray(ids, jnp.int32), axis=0, mode="clip")
    _assert_same(E.row_gather(tt, torch.tensor(ids, dtype=torch.int32)), ref)
    if dtype != "fp32":  # a 16-bit table of R % 8 != 0 is pallas_gather's own clip route
        _assert_same(E.row_gather(tt, torch.tensor(ids, dtype=torch.int32)),
                     jax_gather(jt, jnp.asarray(ids, jnp.int32), interpret=True))


def test_row_gather_refuses_what_the_kernel_does_not_take():
    table = torch.zeros(8, 4)
    with pytest.raises(ValueError, match="int32"):
        E.row_gather(table, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        E.row_gather(torch.zeros(4, 8).T, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        E.row_gather(torch.zeros(8, 4, dtype=torch.float64), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="no rows"):
        E.row_gather(torch.zeros(0, 4), torch.zeros(3, dtype=torch.int32))
    assert E.row_gather(table, torch.zeros(0, dtype=torch.int32)).shape == (0, 4)


def test_int32_pack_rows_match_jnp_take_clip():
    """The device-resident training route gathers rows of its packed (n, 26)
    int32 columns (2**20 rows, one chunk of 16 batches of 8192 ids): the
    copy takes int32 tables as it takes float32 ones, clamped ids included,
    equal to the JAX chunk step's jnp.take(mode="clip")."""
    rng = np.random.default_rng(11)
    table = rng.integers(-2**31, 2**31 - 1, size=(1 << 20, 26), dtype=np.int64).astype(np.int32)
    ids = rng.integers(0, 1 << 20, size=16 * 8192).astype(np.int32)
    ids[:4] = [0, (1 << 20) - 1, -1, 1 << 20]
    ref = jnp.take(jnp.asarray(table), jnp.asarray(ids), axis=0, mode="clip")
    got = E.row_gather(torch.from_numpy(table), torch.from_numpy(ids))
    assert got.dtype == torch.int32 and E.TABLE_DTYPES[1] == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
