"""The port's row-sparse and bf16-at-rest embedding training against the JAX
package's, on the CPU.

Both packages draw the same rows from one seed; the JAX model's parameters
(and, where a case says so, its optimizer slots) are carried over with
``load_jax_params``. Both fit two epochs in batches of 64 with
``shuffle=False``, ``metrics=[]`` and a row-sparse ``embedding_optimizer``
(the JAX scatters take their XLA route on the CPU, the port's the plain
versions of K7 and K8). Per-epoch losses agree within rtol 1e-5; parameters
and slots within rtol 1e-4, atol 1e-6 (fp32 sums in another order,
compounded over 8 steps), and within atol 1e-5 (2e-4 of the learning rate)
for LazyAdam, whose step ``lr * m / (sqrt(v) + 1e-8)`` turns the rounding of
a gradient of the order of eps into a visible move. The dense optimizer is
adagrad or sgd: dense Adam would normalise the last candidate bias's
gradient, which is zero but for rounding.

bf16 tables are carried over as bf16 and round with JAX's own noise: the
port's ``SparseEmbeddingOptimizer.noise`` is set to the bits
``jax.random.bits(fold_in(key(salt), step), shape, uint32)`` that the JAX
package draws. The bf16 tables are then held bit-equal to JAX's: at these
sizes the fp32 rows they round from agree exactly. The port's bf16
trajectory also tracks its own fp32 one (rtol 2e-2, as the JAX package holds
its own).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from models_tpu.blocks.optimizer import SparseEmbeddingOptimizer as JSparse
from models_tpu.data import Dataset as JDataset
from models_tpu.data import Loader as JLoader
from models_tpu.data import generate_data as jax_generate
from models_tpu.inputs.embedding import EmbeddingTable as JTable
from models_tpu.models import TwoTowerModel as JTwoTowerModel
from models_tpu.schema import Schema as JSchema
from models_tpu.schema import Tags as JTags
from models_tpu.schema import create_categorical_column as jcat

import models_tpu_torch as mt
from models_tpu_torch.blocks.optimizer import SparseEmbeddingOptimizer, draw_noise
from models_tpu_torch.data import Loader
from models_tpu_torch.inputs.embedding import EmbeddingTable
from models_tpu_torch.schema import create_categorical_column as tcat


def jax_flat(model, kind=nnx.Param):
    return {"/".join(str(p) for p in path): np.asarray(var[...])
            for path, var in nnx.state(model, kind).flat_state()}


def jax_slots(model):
    return {k: v for k, v in jax_flat(model, nnx.Variable).items() if "/sparse_slots/" in k}


def port_state(model):
    """The port's parameters and slots under the JAX package's flat names."""
    out = {}
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        parts = name.split(".")
        value = t.detach().float().numpy()
        if parts[-1] == "weight":
            parts, value = parts[:-1] + ["kernel"], value.T
        out["/".join(parts)] = value
    return out


def jax_noise(shape, salt, step, device):
    """The stochastic-rounding bits the JAX package draws for (salt, step)."""
    key = jax.random.fold_in(jax.random.key(salt), jnp.asarray(step, jnp.uint32))
    bits = np.asarray(jax.random.bits(key, tuple(shape), jnp.uint32)).view(np.int32)
    return torch.from_numpy(bits.copy()).to(device)


def assert_bf16_equal(got: torch.Tensor, want, err_msg=""):
    """Two bf16 tables, bit for bit."""
    want = np.asarray(want)
    assert got.dtype == torch.bfloat16 and want.dtype.name == "bfloat16", err_msg
    np.testing.assert_array_equal(got.detach().contiguous().view(torch.int16).numpy(),
                                  want.view(np.int16), err_msg=err_msg)


def assert_state_close(tm, jm, atol=1e-6):
    want = {**jax_flat(jm), **jax_slots(jm)}
    got = port_state(tm)
    assert sorted(got) == sorted(want)
    params = dict(tm.named_parameters())
    for key, value in want.items():
        if np.asarray(value).dtype.name == "bfloat16":
            assert_bf16_equal(params[key.replace("/", ".")], value, err_msg=key)
            continue
        np.testing.assert_allclose(got[key], np.asarray(value, np.float32), rtol=1e-4,
                                   atol=atol, err_msg=key)


def shared_domain_data(num_rows=300, seed=13):
    """Two user columns that share one table (domain ``fav``), so that the
    table takes two updates per step, one per column."""
    rng = np.random.default_rng(seed)
    cols = {"user_id": rng.integers(1, 200, num_rows), "item_id": rng.integers(1, 50, num_rows),
            "fav_a": rng.integers(1, 30, num_rows), "fav_b": rng.integers(1, 30, num_rows)}
    cols = {k: v.astype(np.int32) for k, v in cols.items()}
    out = []
    for cat, Schema, Tags, Dataset in ((jcat, JSchema, JTags, JDataset),
                                       (tcat, mt.Schema, mt.Tags, mt.Dataset)):
        schema = Schema([
            cat("user_id", 199, tags=(Tags.USER, Tags.USER_ID)),
            cat("fav_a", 29, tags=(Tags.USER,), domain_name="fav"),
            cat("fav_b", 29, tags=(Tags.USER,), domain_name="fav"),
            cat("item_id", 49, tags=(Tags.ITEM, Tags.ITEM_ID)),
        ])
        out.append(Dataset({k: v.copy() for k, v in cols.items()}, schema=schema))
    return out


def build_pair(name, seed=13, tkw=None, **kw):
    if name == "shared-domain":
        jds, tds = shared_domain_data(seed=seed)
    else:
        jds = jax_generate(name, num_rows=300, seed=seed)
        tds = mt.generate_data(name, num_rows=300, seed=seed)
    jm = JTwoTowerModel(jds.schema, **kw)
    jm.compile()
    jm.build(JLoader(jds, 64))
    tm = mt.TwoTowerModel(tds.schema, device="cpu", **{**kw, **(tkw or {})})
    mt.load_jax_params(tm, jax_flat(jm))
    return jds, tds, jm, tm


SMALL = dict(query_tower=(16, 8), embedding_dim=8)
CASES = {
    "movielens-adagrad": ("movielens-25m", "adagrad", None, "adagrad", None),
    "e-commerce-sgd": ("e-commerce", "sgd", None, "adagrad", None),
    # padded genres ids touch row 0 with zero gradients: LazyAdam moves there
    "movielens-lazy_adam": ("movielens-25m", "lazy_adam", None, "adagrad", None),
    # genres (21 rows) stays on the dense optimizer, the ids tables go sparse
    "movielens-threshold": ("movielens-25m", "adagrad", 100, "adagrad", None),
    "shared-domain-adagrad": ("shared-domain", "sparse_adagrad", None, "adagrad", None),
    # bf16 tables: old + delta in fp32, stochastic rounding, the row write
    "movielens-adagrad-bf16": ("movielens-25m", "adagrad", None, "adagrad", "bfloat16"),
    "e-commerce-sgd-bf16": ("e-commerce", "sgd", None, "adagrad", "bfloat16"),
    # a bf16 table (genres) goes sparse below the threshold too
    "movielens-threshold-bf16": ("movielens-25m", "adagrad", 100, "adagrad", "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sparse_fit_trajectory_matches_jax(case):
    name, emb, thr, dense, dtype = CASES[case]
    kw = dict(SMALL, table_dtype=getattr(jnp, dtype)) if dtype else SMALL
    jds, tds, jm, tm = build_pair(name, tkw=dict(table_dtype=getattr(torch, dtype))
                                  if dtype else {}, **kw)
    for m in (jm, tm):
        m.compile(optimizer=dense, learning_rate=0.05, metrics=[], embedding_optimizer=emb,
                  sparse_threshold=thr)
    tm._emb_opt.noise = jax_noise
    jh = jm.fit(jds, epochs=2, batch_size=64, shuffle=False, verbose=0)
    th = tm.fit(tds, epochs=2, batch_size=64, shuffle=False, device="cpu")
    assert sorted(th.history) == sorted(jh.history)
    np.testing.assert_allclose(th.history["loss"], jh.history["loss"], rtol=1e-5)
    assert th.history["loss"][1] < th.history["loss"][0]
    assert_state_close(tm, jm, atol=1e-5 if emb == "lazy_adam" else 1e-6)
    routed = {t.block_name for t in tm._sparse_tables}
    assert routed == ({"userId", "movieId"} | ({"genres"} if dtype else set()) if thr else
                      {t.block_name for t in tm._embedding_tables()})
    assert all(t.table.dtype == getattr(torch, dtype or "float32")
               for t in tm._embedding_tables())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["sgd", "adagrad", "adam"])
def test_sparse_optimizer_apply_matches_jax(kind, dtype):
    """Three updates of one table from duplicated ids, at steps 4 to 6 (the
    step drives Adam's correction and a bf16 table's rounding noise)."""
    rng = np.random.default_rng(9)
    jt = JTable(128, jcat("item", 63), seed=2, dtype=getattr(jnp, dtype))
    tt = EmbeddingTable(128, tcat("item", 63), dtype=getattr(torch, dtype), device="cpu")
    mt.load_jax_params(tt, {"table": np.asarray(jt.table[...])})
    assert tt.table.dtype == getattr(torch, dtype)
    jopt, topt = JSparse(kind, learning_rate=0.1), SparseEmbeddingOptimizer(kind, 0.1)
    topt.noise = jax_noise
    jopt.init_slots(jt)
    topt.init_slots(tt)
    for step in range(3):
        ids = rng.integers(0, 64, (5, 7)).astype(np.int32)
        grads = rng.standard_normal((5, 7, 128)).astype(np.float32)
        jopt.apply(jt, jnp.asarray(ids), jnp.asarray(grads), jnp.asarray(step + 4))
        topt.apply(tt, torch.tensor(ids), torch.tensor(grads), step + 4)
    if dtype == "bfloat16":
        assert_bf16_equal(tt.table, jt.table[...])
    else:
        np.testing.assert_allclose(tt.table.detach().numpy(), np.asarray(jt.table[...]),
                                   rtol=1e-5, atol=1e-6)
    assert sorted(tt.sparse_slots.keys()) == sorted(jt.sparse_slots)
    for name in jt.sparse_slots:
        np.testing.assert_allclose(tt.sparse_slots[name].numpy(),
                                   np.asarray(jt.sparse_slots[name][...]), rtol=1e-5,
                                   atol=1e-7, err_msg=name)


def test_slots_carry_over_and_persist():
    """The JAX model's slots after a fit land on the port's tables bit for
    bit; the port's fit keeps them (rows it does not touch stay) and a
    second fit continues from them."""
    jds, tds, jm, tm = build_pair("movielens-25m", **SMALL)
    jm.compile(optimizer="adagrad", learning_rate=0.05, metrics=[], embedding_optimizer="adagrad")
    jm.fit(jds, epochs=1, batch_size=64, shuffle=False, verbose=0)
    slots = jax_slots(jm)
    assert len(slots) == 3
    mt.load_jax_params(tm, jax_flat(jm), slots)
    state = port_state(tm)
    for key, value in {**jax_flat(jm), **slots}.items():
        np.testing.assert_array_equal(state[key], np.asarray(value, np.float32), err_msg=key)
    user = tm._query.layers[0].branches["categorical"].branches["userId"]
    assert user.table.dtype == torch.float32
    carried = user.sparse_slots["acc"].clone()
    tm.compile(optimizer="adagrad", learning_rate=0.05, metrics=[], embedding_optimizer="adagrad")
    tm.fit(tds.take(64), epochs=1, batch_size=64, shuffle=False, device="cpu")
    acc = user.sparse_slots["acc"]
    seen = np.unique(tds.take(64).to_numpy_dict()["userId"])
    others = np.setdiff1d(np.arange(acc.shape[0]), seen)
    assert torch.equal(acc[others], carried[others])
    assert bool((acc[seen] >= carried[seen]).all()) and not torch.equal(acc[seen], carried[seen])
    with pytest.raises(ValueError, match="float32"):
        mt.load_jax_params(tm, jax_flat(jm), {k: v[:8] for k, v in slots.items()})


def identity_pair(table_dtype, seed=0, n=50, rows=400):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, n, size=rows).astype(np.int32)
    schema = mt.Schema([tcat("user_id", n - 1, tags=(mt.Tags.USER, mt.Tags.USER_ID)),
                        tcat("item_id", n - 1, tags=(mt.Tags.ITEM, mt.Tags.ITEM_ID))])
    ds = mt.Dataset({"user_id": users, "item_id": users.copy()}, schema=schema)
    return ds, mt.TwoTowerModel(schema, query_tower=(16,), embedding_dim=16,
                                table_dtype=table_dtype, seed=seed, device="cpu")


def test_bf16_tables_track_fp32_and_stay_bf16():
    losses = {}
    for dt in (None, torch.bfloat16):
        ds, m = identity_pair(dt)
        m.compile(optimizer="adagrad", learning_rate=0.2, metrics=[],
                  embedding_optimizer="adagrad")
        losses[dt] = m.fit(ds, epochs=12, batch_size=64, shuffle=False,
                           device="cpu").history["loss"]
        tables = m._embedding_tables()
        assert tables and all(t.table.dtype == (dt or torch.float32) for t in tables)
        assert all(t.sparse_slots["acc"].dtype == torch.float32 for t in tables)
    l32, lbf = losses[None], losses[torch.bfloat16]
    assert l32[-1] < l32[0] - 0.03 and lbf[-1] < lbf[0] - 0.03
    np.testing.assert_allclose(lbf, l32, rtol=2e-2)

    ds, m = identity_pair(torch.bfloat16)
    m.compile(optimizer="adam", learning_rate=0.05, metrics=[])
    with pytest.raises(ValueError, match="stochastic"):
        m.fit(ds, epochs=1, batch_size=64, device="cpu")


def test_stochastic_rounding_lands_tiny_updates_in_expectation():
    """A bf16 row takes 300 updates of 1e-5, far below half its ulp:
    rounding to nearest would drop them all; stochastic rounding moves the
    row by 3e-3 on average."""
    t = EmbeddingTable(8, tcat("item", 99), dtype=torch.bfloat16, seed=3, device="cpu")
    opt = SparseEmbeddingOptimizer("sgd", learning_rate=1.0)
    opt.init_slots(t)
    before = t.table.detach().clone()
    for step in range(300):
        opt.apply(t, torch.tensor([5]), torch.full((1, 8), -1e-5), step)
    after = t.table.detach()
    drift = float((after[5].float() - before[5].float()).mean())
    np.testing.assert_allclose(drift, 3e-3, rtol=0.5)
    assert after.dtype == torch.bfloat16
    assert torch.equal(after[:5], before[:5]) and torch.equal(after[6:], before[6:])
    # the same (salt, step) gives the same bits; another step other bits
    a, b = draw_noise((4, 8), 7, 1, "cpu"), draw_noise((4, 8), 7, 1, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, draw_noise((4, 8), 7, 2, "cpu"))
    assert int(a.min()) >= 0 and int(a.max()) < 1 << 16


def test_rows_never_looked_up_stay():
    ds = mt.generate_data("movielens-25m", num_rows=256, seed=4)
    m = mt.TwoTowerModel(ds.schema, device="cpu", **SMALL)
    tables = {t.block_name: t for t in m._embedding_tables()}
    before = {n: t.table.detach().clone() for n, t in tables.items()}
    m.compile(optimizer="adagrad", learning_rate=0.05, metrics=[], embedding_optimizer="adagrad")
    m.fit(ds, epochs=1, batch_size=64, shuffle=False, device="cpu")
    batches = [x for x, _ in Loader(ds, 64, drop_last=True)]
    for name in ("userId", "movieId", "genres"):
        # the padded ids, as the lookups saw them (0 pads genres)
        seen = np.unique(np.concatenate([np.ravel(getattr(x[name], "values", x[name]))
                                         for x in batches]))
        t, acc = tables[name].table.detach(), tables[name].sparse_slots["acc"]
        others = np.setdiff1d(np.arange(t.shape[0]), seen)
        assert torch.equal(t[others], before[name][others]), name
        assert bool((acc[others] == 0.1).all()), name
        assert not torch.equal(t[seen], before[name][seen]), name


def test_fit_then_fit_equals_one_long_fit():
    def build():
        ds, m = identity_pair(None, seed=1)
        m.compile(optimizer="adam", learning_rate=0.05, metrics=[],
                  embedding_optimizer="lazy_adam")
        return ds, m

    ds, m = build()
    one = m.fit(ds, epochs=6, batch_size=64, shuffle=False, device="cpu").history["loss"]
    ds, m = build()
    a = m.fit(ds, epochs=3, batch_size=64, shuffle=False, device="cpu").history["loss"]
    b = m.fit(ds, epochs=3, batch_size=64, shuffle=False, device="cpu").history["loss"]
    np.testing.assert_allclose(a + b, one, rtol=1e-5)


def test_compile_names_the_ported_embedding_optimizers():
    ds, m = identity_pair(None)
    with pytest.raises(ValueError, match="ported: sgd, adagrad, adam"):
        m.compile(metrics=[], embedding_optimizer="rmsprop")
    with pytest.raises(TypeError, match="SparseEmbeddingOptimizer"):
        m.compile(metrics=[], embedding_optimizer=0.1)
    m.compile(metrics=[], learning_rate=0.3, embedding_optimizer="lazy_adam")
    assert m._emb_opt.kind == "adam" and m._emb_opt.learning_rate == 0.3
    m.compile(metrics=[], embedding_optimizer="sparse_sgd")
    assert m._emb_opt.kind == "sgd" and m._emb_opt.learning_rate == 0.05


def test_threshold_routing_keeps_bf16_sparse_and_warns_when_all_dense():
    ds, m = identity_pair(None)
    m.compile(optimizer="adagrad", metrics=[], embedding_optimizer="adagrad",
              sparse_threshold=10_000)
    with pytest.warns(UserWarning, match="routed every"):
        m.fit(ds, epochs=1, batch_size=64, device="cpu")
    assert m._sparse_tables == []
    dense = {id(p) for g in m._optimizer.param_groups for p in g["params"]}
    assert all(id(t.table) in dense for t in m._embedding_tables())

    ds, m = identity_pair(torch.bfloat16)
    m.compile(optimizer="adagrad", metrics=[], embedding_optimizer="adagrad",
              sparse_threshold=10_000)
    m.fit(ds, epochs=1, batch_size=64, device="cpu")
    assert len(m._sparse_tables) == 2
    dense = {id(p) for g in m._optimizer.param_groups for p in g["params"]}
    assert not any(id(t.table) in dense for t in m._embedding_tables())
