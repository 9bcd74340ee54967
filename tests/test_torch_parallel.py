"""The port's mesh distribution against the JAX package's, on the CPU.

Four gloo ranks (``models_tpu_torch.parallel.launch.spawn``) run every case
of ``torch_mesh_workers.parallel_suite`` once for the file; the ranks import
the port and nothing of JAX. The parent builds each JAX model, carries its
parameters into the port with ``load_jax_params`` and hands the ranks that
state, then fits the JAX models while the ranks run: on one device and on a
mesh of 4 forced host devices of the same shape (``tests/conftest.py``).

- ``fit(mesh=)`` on ``{4,1}``, ``{2,2}`` and ``{1,4}``: the two-tower model
  (movielens-100k, 128 rows, batch 16, two epochs) with dense Adam, with
  row-sparse adagrad on fp32 and on bf16 tables (stochastic rounding, the
  bits JAX draws), and the DLRM (e-commerce): each epoch's loss against
  JAX's mesh fit, JAX's single-device fit and the port's single-process
  fit, rtol 2e-4 (the JAX tests' tolerance); ``evaluate`` after it
  likewise; on ``{2,2}`` the dense fit also trains with its top-k metrics;
- no collective of a two-tower fit that moves rows or ids moves as many
  bytes as the smallest table a rank holds, and its all-reduces are no
  larger than the dense parameters (the collective layer's byte counter);
- the layout: the rank map, the sharding rules, ``shard_batch``;
- ``to_top_k_encoder(mesh=)`` evaluates as JAX's does, fp32 and int8;
- a checkpoint resumed on the mesh stitches the uninterrupted trajectory,
  and a model exported (and saved) from mesh state serves its ``predict``;
- ``Loader(global_size=, global_rank=)`` yields JAX's batches; without a
  cluster ``initialize()`` does nothing; a rank that fails or hangs fails
  the run (``launch.spawn``).

The JAX DLRM's binary head trains with ``softplus(x) - x y`` (its
``binary_crossentropy`` has a wrong gradient at a zero logit: ROADMAP.md
queue 3).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import models_tpu.losses as jlosses
from models_tpu.data import Dataset as JDataset
from models_tpu.data import Loader as JLoader
from models_tpu.data import generate_data as jax_generate
from models_tpu.models import DLRMModel as JDLRM
from models_tpu.models import MatrixFactorizationModel as JMF
from models_tpu.models import TwoTowerModel as JTwoTower
from models_tpu.parallel.mesh import make_mesh as jax_make_mesh
from models_tpu.schema import Schema as JSchema
from models_tpu.schema import Tags as JTags
from models_tpu.schema import create_categorical_column as jcat

import models_tpu_torch as mt
import torch_mesh_workers as W
from models_tpu_torch.parallel import distributed, mesh as pmesh
from models_tpu_torch.parallel.launch import spawn
from models_tpu_torch.utils.io import model_state

RTOL = 2e-4
KINDS = ("dense", "sparse", "bf16", "dlrm")
SKIP_KEYS = ("examples_per_sec",)


def jax_state(model):
    return {"/".join(str(p) for p in path): np.asarray(var[...])
            for path, var in nnx.state(model, nnx.Variable).flat_state()
            if "sparse_slots" not in path}


def jax_noise_bits(shape, salt, step):
    key = jax.random.fold_in(jax.random.key(salt), jnp.asarray(step, jnp.uint32))
    return np.asarray(jax.random.bits(key, tuple(shape), jnp.uint32)).view(np.int32)


def _bce_softplus(labels, logits, sample_weight=None):
    labels = labels.reshape(logits.shape).astype(logits.dtype)
    return jlosses._weighted_mean(jax.nn.softplus(logits) - logits * labels, sample_weight)


def jax_mesh(shape):
    return jax_make_mesh(shape, devices=jax.devices("cpu")[:4])


def jax_model(kind):
    if kind == "dlrm":
        jds = jax_generate("e-commerce", num_rows=128, seed=0)
        return jds, JDLRM(jds.schema, embedding_dim=8, bottom_block=(8,), top_block=(8,))
    jds = jax_generate("movielens-100k", num_rows=128, seed=0)
    dt = jnp.bfloat16 if kind == "bf16" else None
    return jds, JTwoTower(jds.schema, query_tower=(16, 8), embedding_dim=8, table_dtype=dt)


def jax_compile(model, kind, metrics):
    kw = {} if kind in ("dense", "dlrm") else {"embedding_optimizer": "sparse_adagrad"}
    model.compile(optimizer="adam", learning_rate=0.05, metrics=metrics, **kw)


def metrics_of(kind, shape):
    return None if (kind == "dense" and shape == {"data": 2, "model": 2}) else []


def jax_fit(kind, shape):
    """JAX's fit of a fresh model (the seeded weights the port carried),
    and its evaluate after it."""
    jds, jm = jax_model(kind)
    jm.build(JLoader(jds, 16))
    jax_compile(jm, kind, metrics_of(kind, shape or {}))
    mesh = jax_mesh(shape) if shape is not None else None
    h = jm.fit(jds, epochs=2, batch_size=16, shuffle=False, verbose=0, mesh=mesh)
    return {"history": h.history, "evaluate": jm.evaluate(jds, batch_size=24)}


def mf_jax_schema():
    return JSchema([jcat("user_id", 23, tags=(JTags.USER, JTags.USER_ID)),
                    jcat("item_id", 23, tags=(JTags.ITEM, JTags.ITEM_ID))])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setitem(jlosses.loss_registry._store, "binary_crossentropy", _bce_softplus)
    try:
        # the JAX weights of every case, carried into port states
        states, single = {}, {}
        noise = {}
        for kind in KINDS:
            jds, jm = jax_model(kind)
            jm.build(JLoader(jds, 16))
            ds = W.dlrm_data() if kind == "dlrm" else W.two_tower_data()
            tm = W.make_model(kind, ds)
            mt.load_jax_params(tm, jax_state(jm))
            states[kind] = {k: v.clone() for k, v in model_state(tm).items()}
            # the port on one process; for bf16 tables with JAX's bits, each
            # draw recorded for the ranks
            W.compile_case(tm, kind, metrics_of(kind, {}))
            if kind == "bf16":
                bits = noise.setdefault(kind, {})

                def record(shape, salt, step, device, bits=bits):
                    b = jax_noise_bits(shape, salt, step)
                    bits[(tuple(shape), int(salt), int(step))] = b
                    return torch.from_numpy(b.copy()).to(device)

                tm._emb_opt.noise = record
            h = tm.fit(ds, epochs=2, batch_size=16, shuffle=False, device="cpu")
            single[kind] = {"history": h.history,
                            "evaluate": tm.evaluate(ds, batch_size=24, device="cpu")}
        jds = jax_generate("e-commerce", num_rows=64, seed=0)
        jtop = JTwoTower(jds.schema, query_tower=(16, 8))
        jtop.build(JLoader(jds, 16))
        ttop = mt.TwoTowerModel(mt.generate_data("e-commerce", num_rows=64, seed=0).schema,
                                query_tower=(16, 8), device="cpu")
        mt.load_jax_params(ttop, jax_state(jtop))
        states["topk"] = model_state(ttop)
        jmf = JMF(mf_jax_schema(), dim=8)
        tmf = mt.MatrixFactorizationModel(W.mf_schema(), dim=8, device="cpu")
        mt.load_jax_params(tmf, jax_state(jmf))
        states["mf"] = model_state(tmf)

        box = {}

        def ranks():
            try:
                box["out"] = spawn(W.parallel_suite, 4,
                                   (states, noise, str(tmp_path_factory.mktemp("mesh"))),
                                   timeout=600)
            except BaseException as err:  # reported below, after the JAX side
                box["err"] = err

        thread = threading.Thread(target=ranks)
        thread.start()
        try:
            ref = {}
            for kind in KINDS:
                ref[(kind, None)] = jax_fit(kind, None)
                for shape in W.MESHES:
                    ref[(kind, W.key(shape))] = jax_fit(kind, shape)
            topk = {}
            for name, shape in (("1x4", {"data": 1, "model": 4}),
                                ("2x2", {"data": 2, "model": 2}), ("single", None)):
                mesh = jax_mesh(shape) if shape is not None else None
                for tag, dtype in (("fp32", None), ("int8", jnp.int8)):
                    enc = jtop.to_top_k_encoder(jds, k=5, mesh=mesh, candidate_dtype=dtype)
                    topk[(name, tag)] = enc.evaluate(jds, batch_size=16)
        finally:
            thread.join()
        if "err" in box:
            raise box["err"]
        return {"ranks": box["out"], "jax": ref, "single": single, "topk": topk}
    finally:
        mp.undo()


def assert_logs_close(got, want, what):
    keys = [k for k in want if k in got and k not in SKIP_KEYS]
    assert "loss" in keys, (what, sorted(got), sorted(want))
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=1e-6,
                                   err_msg=f"{what}: {k}")


@pytest.mark.parametrize("shape", W.MESHES, ids=W.key)
@pytest.mark.parametrize("kind", KINDS)
def test_fit_on_mesh_matches_jax_and_single_device(runs, kind, shape):
    case = f"fit/{kind}/{W.key(shape)}"
    for rank, out in enumerate(runs["ranks"]):
        what = f"{case} rank {rank}"
        assert_logs_close(out[case]["history"], runs["jax"][(kind, W.key(shape))]["history"],
                          what + " vs JAX's mesh fit")
        np.testing.assert_allclose(out[case]["history"]["loss"],
                                   runs["jax"][(kind, None)]["history"]["loss"], rtol=RTOL,
                                   err_msg=what + " vs JAX's single device")
        np.testing.assert_allclose(out[case]["history"]["loss"],
                                   runs["single"][kind]["history"]["loss"], rtol=RTOL,
                                   err_msg=what + " vs the port on one process")
        assert_logs_close(out[case]["evaluate"], runs["jax"][(kind, W.key(shape))]["evaluate"],
                          what + " evaluate vs JAX's")
    if metrics_of(kind, shape) is None:  # trained with its metrics, reduced over the data axis
        assert "recall_at_10" in runs["ranks"][0][case]["history"]


@pytest.mark.parametrize("shape", W.MESHES, ids=W.key)
@pytest.mark.parametrize("kind", ("dense", "sparse", "bf16"))
def test_no_step_moves_a_table(runs, kind, shape):
    """The collectives that move rows and ids (gathers, all-to-alls) stay
    smaller than the smallest real table a rank holds (its shard, or the
    whole table on a model axis of one), and no all-reduce is larger than
    the dense parameters': lookups and updates move (B, D) rows, never a
    table."""
    for out in runs["ranks"]:
        rec = out[f"fit/{kind}/{W.key(shape)}"]
        largest = rec["traffic"]["largest"]
        assert rec["min_table_bytes"], "no table of 512 rows or more"
        rows = max(largest.get("all_gather", 0), largest.get("all_to_all", 0))
        assert 0 < rows < rec["min_table_bytes"], rec["traffic"]
        assert 0 < largest["all_reduce"] <= rec["dense_bytes"], rec["traffic"]
        if shape["model"] > 1:
            assert rec["traffic"]["calls"].get("all_to_all", 0) >= 2  # the a2a lookup ran


@pytest.mark.parametrize("shape", W.MESHES, ids=W.key)
def test_mesh_layout(runs, shape):
    """Rank r at (r // model, r % model), as JAX reshapes its devices; the
    rules shard a table whose padded rows divide the model axis; each rank
    keeps its data slice of a batch's divisible leaves."""
    n, dp = shape["model"], shape["data"]
    for rank, out in enumerate(runs["ranks"]):
        lay = out["layout"][W.key(shape)]
        d, m = rank // n, rank % n
        assert tuple(lay["coords"]) == (d, m)
        assert tuple(lay["model_ranks"]) == tuple(d * n + i for i in range(n))
        assert tuple(lay["data_ranks"]) == tuple(i * n + m for i in range(dp))
        # 99 -> 104 rows and 6 -> 8 rows divide every model axis of 4 ranks
        specs = {k.split(".")[-2]: v for k, v in lay["specs"].items()}
        assert specs == {"item": ("model", None), "tiny": ("model", None)}
        b = 16 // dp
        np.testing.assert_array_equal(lay["a"], np.arange(48).reshape(16, 3)[d * b:(d + 1) * b])
        np.testing.assert_array_equal(lay["b"], np.arange(7))  # 7 rows: kept whole
        np.testing.assert_array_equal(lay["s"][0], np.arange(32).reshape(16, 2)[d * b:(d + 1) * b])
    assert "does not match 4 ranks" in runs["ranks"][0]["bad_shape"]


def test_sharding_rules_skip_indivisible():
    """A spec applies only where the sharded dimension divides its axis."""

    class Shape:
        shape = {"data": 2, "model": 2}

        def size(self, axis):
            return self.shape.get(axis, 1)

    assert pmesh._spec_fits(("model", None), (104, 8), Shape())
    assert not pmesh._spec_fits(("model", None), (7, 8), Shape())
    specs = pmesh.sharding_for_tree({"a/table": torch.zeros(7, 8), "b/table": torch.zeros(8, 8),
                                     "dense/kernel": torch.zeros(8, 8)}, Shape())
    assert specs == {"a/table": None, "b/table": ("model", None), "dense/kernel": None}


@pytest.mark.parametrize("dtype", ("fp32", "int8"))
@pytest.mark.parametrize("mesh_key", ("1x4", "2x2"))
def test_top_k_encoder_on_mesh_matches_jax(runs, mesh_key, dtype):
    """``to_top_k_encoder(mesh=)`` evaluates as JAX's mesh encoder does
    (and, fp32, as the one-device encoder: the int8 index of a mesh
    quantizes its shards); every rank serves the same lists."""
    refs = [runs["topk"][(mesh_key, dtype)]]
    if dtype == "fp32":
        refs.append(runs["topk"][("single", dtype)])
    for out in runs["ranks"]:
        got = out["topk"][mesh_key][dtype]
        for ref in refs:
            assert sorted(got) == sorted(ref)
            for k in ref:
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-7, err_msg=k)
    first = runs["ranks"][0]["topk"][mesh_key][dtype + "_predict"]
    for out in runs["ranks"][1:]:
        np.testing.assert_array_equal(out["topk"][mesh_key][dtype + "_predict"]["ids"],
                                      first["ids"])


def test_mesh_checkpoint_resume_stitches(runs):
    """ModelCheckpoint on a {2,2} mesh (the chief writes the gathered
    state), restore_training(mesh=) on a fresh model, fit(initial_epoch=):
    the uninterrupted four epochs (dry run 7)."""
    for out in runs["ranks"]:
        res = out["resume"]
        assert res["step"] == 1
        np.testing.assert_allclose(res["stitched"], res["full"], rtol=1e-6)


def test_export_from_mesh_state_equals_predict(runs):
    """export_serving and save from mesh-trained state (gathered through the
    host, written by the chief) serve what predict gives (dry run 8)."""
    for out in runs["ranks"]:
        res = out["export"]
        np.testing.assert_allclose(res["served"], res["predict"][:16], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(res["loaded"], res["predict"], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode,message", [("raise", "(?s)rank 1 failed:.*rank 1 refuses"),
                                          ("hang", "did not finish within 5 s")])
def test_a_failing_or_stuck_rank_fails_the_run(mode, message):
    """``spawn`` raises with the failed rank's traceback, or at its
    deadline, and kills every rank it started. The failing rank's deadline
    lies past the children's start-up (importing torch and the port), which
    must not decide the case; the call returns when the traceback arrives."""
    with pytest.raises(RuntimeError, match=message):
        spawn(W.failing_rank, 2, (mode,), timeout=120 if mode == "raise" else 5)


def test_initialize_without_a_cluster_does_nothing(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is None
    assert not torch.distributed.is_initialized()
    assert distributed.local_loader_kwargs() == {"global_size": 1, "global_rank": 0}
    ds = mt.generate_data("e-commerce", num_rows=64)
    assert len(mt.Loader(ds, 16, **distributed.local_loader_kwargs())) == 4


@pytest.mark.parametrize("pad", ("max", "bucket"))
@pytest.mark.parametrize("shuffle", (False, True))
def test_loader_global_rank_batches_match_jax(shuffle, pad):
    """Each rank's batches, strided over the (shuffled) rows, with the pad
    lengths agreed over the global step under pad="bucket"."""
    name = "sequence-testing"
    jds, tds = jax_generate(name, num_rows=70, seed=3), mt.generate_data(name, num_rows=70,
                                                                         seed=3)
    for rank in range(3):
        kw = dict(shuffle=shuffle, drop_last=False, seed=5, global_size=3, global_rank=rank,
                  pad=pad)
        jl, tl = JLoader(jds, 8, **kw), mt.Loader(tds, 8, **kw)
        assert len(jl) == len(tl)
        jb, tb = list(jl), list(tl)
        assert len(jb) == len(tb)
        for (jx, jy), (tx, ty) in zip(jb, tb):
            assert sorted(jx) == sorted(tx)
            for k in jx:
                jv, tv = jx[k], tx[k]
                if hasattr(jv, "mask"):
                    np.testing.assert_array_equal(np.asarray(tv.values), np.asarray(jv.values))
                    np.testing.assert_array_equal(np.asarray(tv.mask), np.asarray(jv.mask))
                else:
                    np.testing.assert_array_equal(np.asarray(tv), np.asarray(jv))
