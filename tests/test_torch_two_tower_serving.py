"""The port's two-tower serving path against the JAX package's, on the CPU.

Both packages draw the same rows from one seed; the JAX model's parameters are
carried over with ``load_jax_params``. Tower outputs agree within rtol 1e-5,
atol 1e-6 (fp32 sums in another order); top-k scores within 1e-5 absolute,
and ids are equal except inside near-ties of 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from models_tpu.core.types import SequenceFeature as JSequenceFeature
from models_tpu.core.types import to_device_batch as jax_batch
from models_tpu.data import Loader as JLoader
from models_tpu.data import generate_data as jax_generate
from models_tpu.models import TwoTowerModel as JTwoTowerModel

import models_tpu_torch as mt
from models_tpu_torch.core.types import SequenceFeature, to_device_batch
from models_tpu_torch.data import Loader
from models_tpu_torch.ops.topk import ids_agree


def jax_flat_params(model):
    return {
        "/".join(str(p) for p in path): np.asarray(var[...])
        for path, var in nnx.state(model, nnx.Param).flat_state()
    }


def build_pair(name, num_rows, seed, **kw):
    jds = jax_generate(name, num_rows=num_rows, seed=seed)
    tds = mt.generate_data(name, num_rows=num_rows, seed=seed)
    jm = JTwoTowerModel(jds.schema, **kw)
    jm.compile()
    jm.build(JLoader(jds, 64))
    tm = mt.TwoTowerModel(tds.schema, device="cpu", **kw)
    mt.load_jax_params(tm, jax_flat_params(jm))
    return jds, tds, jm, tm


@pytest.fixture(scope="module")
def ecommerce():
    return build_pair("e-commerce", 300, 5, query_tower=(16, 8))


@pytest.fixture(scope="module")
def movielens():
    return build_pair("movielens-25m", 200, 9, query_tower=(16, 8), embedding_dim=8)


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["e-commerce", "movielens-25m"])
def test_generated_rows_and_catalog_match(name):
    jd = jax_generate(name, num_rows=150, seed=11)
    td = mt.generate_data(name, num_rows=150, seed=11)
    item_id = td.schema.item_id_column.name
    for jds, tds in ((jd, td), (jd.unique_by(item_id), td.unique_by(item_id))):
        jcols, tcols = jds.to_numpy_dict(), tds.to_numpy_dict()
        for col, arr in tcols.items():
            if col == "title":  # bytes; the JAX loader hashes it, neither model reads it
                continue
            np.testing.assert_array_equal(arr, jcols[col], err_msg=col)
    assert td.unique_by(item_id).num_rows < td.num_rows


def test_loader_batches_match():
    jd = jax_generate("movielens-25m", num_rows=100, seed=2)
    td = mt.generate_data("movielens-25m", num_rows=100, seed=2)
    jb, tb = list(JLoader(jd, 48, prefetch=0)), list(Loader(td, 48))
    assert len(jb) == len(tb) == 3
    for (jx, jy), (tx, ty) in zip(jb, tb):
        assert sorted(jx) == sorted(tx)
        for name, v in tx.items():
            if isinstance(v, SequenceFeature):
                assert isinstance(jx[name], JSequenceFeature)
                np.testing.assert_array_equal(v.values, jx[name].values)
                np.testing.assert_array_equal(v.mask, jx[name].mask)
            else:
                np.testing.assert_array_equal(v, jx[name], err_msg=name)
        for name in jy:
            np.testing.assert_array_equal(ty[name], jy[name])
    assert tb[-1][0]["__row_valid__"].sum() == 4


@pytest.mark.parametrize("fixture", ["ecommerce", "movielens"])
def test_tower_outputs_match(fixture, request):
    jds, tds, jm, tm = request.getfixturevalue(fixture)
    (jx, _), (tx, _) = next(iter(JLoader(jds, 64, prefetch=0))), next(iter(Loader(tds, 64)))
    with torch.no_grad():
        tq = tm.query_encoder(to_device_batch(tx, "cpu"))
        tc = tm.candidate_encoder(to_device_batch(tx, "cpu"))
    _close(tq, jm.query_encoder(jax_batch(jx)))
    _close(tc, jm.candidate_encoder(jax_batch(jx)))


def test_candidate_embeddings_match(ecommerce):
    jds, tds, jm, tm = ecommerce
    jc = jm.candidate_embeddings(jds, batch_size=64).to_numpy_dict()
    tc = tm.candidate_embeddings(tds, batch_size=64, device="cpu").to_numpy_dict()
    np.testing.assert_array_equal(tc["id"], jc["id"])
    _close(tc["embedding"], jc["embedding__values"].reshape(len(jc["id"]), -1))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_top_k_encoder_predict_matches(ecommerce, dtype):
    jds, tds, jm, tm = ecommerce
    jenc = jm.to_top_k_encoder(jds, k=5, batch_size=64,
                               candidate_dtype=jnp.bfloat16 if dtype == "bf16" else None)
    tenc = tm.to_top_k_encoder(tds, k=5, batch_size=64, device="cpu",
                               candidate_dtype=torch.bfloat16 if dtype == "bf16" else None)
    jout = jenc.predict(jds, batch_size=64)
    tout = tenc.predict(tds, batch_size=64, device="cpu")
    assert tout["scores"].shape == (tds.num_rows, 5) and tout["scores"].dtype == np.float32
    assert tout["ids"].dtype == np.int32
    np.testing.assert_allclose(tout["scores"], jout["scores"], rtol=0, atol=1e-5)
    assert ids_agree(tout["scores"], tout["ids"], jout["scores"], jout["ids"], 1e-5)


def test_load_jax_params_refuses_partial_or_foreign_keys(ecommerce):
    jds, tds, jm, tm = ecommerce
    flat = jax_flat_params(jm)
    fresh = mt.TwoTowerModel(tds.schema, query_tower=(16, 8), device="cpu")
    with pytest.raises(KeyError):
        mt.load_jax_params(fresh, {**flat, "_query/layers/9/kernel": np.zeros((2, 2))})
    partial = {k: v for k, v in flat.items() if not k.endswith("bias")}
    with pytest.raises(ValueError, match="left unset"):
        mt.load_jax_params(fresh, partial)
