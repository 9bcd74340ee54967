"""The last mesh configurations of the JAX package's multi-chip dry runs on
the port's mesh, against the JAX package's, on the CPU.

Four gloo ranks (``models_tpu_torch.parallel.launch.spawn``) run every case
of ``torch_mesh_breadth_workers.mesh_suite`` once for the file; the ranks
import the port and nothing of JAX. The parent builds each JAX model,
carries its parameters into the port with ``load_jax_params`` and hands the
ranks that state, fits the port's model in one process, then fits the JAX
models while the ranks run: on one device and on a mesh of 4 forced host
devices of the same shape (``tests/conftest.py``). Losses agree within rtol
2e-4 (the JAX mesh tests' tolerance); a dynamic table's keys and
allocations are equal.

- dry run 11: dynamic-vocabulary tables with dense Adam on ``{2, 2}`` and on
  the data axis alone (``{4, 1}``: four ranks race for slots);
- a row-sparse dynamic fit (adagrad on the slots) where the items overflow
  their probe windows, and its mesh checkpoint resumed;
- dry run 4: the session transformer with in-batch negatives over the
  global flattened positions, also from a ``pad="bucket"`` loader;
- the tied full-catalog ``NextItemPredictionTask(table=)`` over a table split
  by rows: the head's logits and gradients, and two epochs' losses in
  float32 and under ``mixed_bfloat16``;
- dry run 3: the multi-task DLRM on ``music-streaming`` (click, like,
  play_percentage);
- ``examples/06``'s flow: ``get_movielens("ml-25m")`` synthesized (320 rows,
  its own 20,000) and the two-tower model ``(64, 32)`` at dim 32, one epoch
  of batch 32 (its own 1024).

The JAX binary heads train with ``softplus(x) - x y`` (their
``binary_crossentropy`` has a wrong gradient at a zero logit: ROADMAP.md
queue 3). Under ``mixed_bfloat16`` the port and JAX round in other orders:
the tied head's mixed fit is held to JAX's within rtol 1e-4 as the session
tests hold it, and to the port's one process within 2e-4.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import nnx

import models_tpu as mm
import models_tpu.losses as jlosses
from models_tpu.core.policy import set_dtype_policy as jax_set_policy
from models_tpu.data import Loader as JLoader
from models_tpu.data import generate_data as jax_generate
from models_tpu.data.datasets import get_movielens as jax_get_movielens
from models_tpu.inputs.dynamic import DynamicEmbeddingTable as JDyn
from models_tpu.inputs.embedding import EmbeddingTable as JTable
from models_tpu.models.session import _find_item_table as jfind_table
from models_tpu.models.session import _ProjectToTableDim as JProject
from models_tpu.models.session import _SequenceConcat as JConcat
from models_tpu.outputs.base import EmbeddingTablePrediction as JTied
from models_tpu.parallel.mesh import make_mesh as jax_make_mesh
from models_tpu.schema import Schema as JSchema
from models_tpu.schema import Tags as JTags
from models_tpu.schema import create_categorical_column as jcat
from models_tpu.transformer.block import GPT2Block as JGPT2
from models_tpu.transforms.sequence import SequencePredictNext as JNext

import models_tpu_torch as mt
import torch_mesh_breadth_workers as W
from models_tpu_torch.parallel.launch import spawn
from models_tpu_torch.utils.io import model_state

RTOL = 2e-4
MIXED_RTOL = 1e-4
SKIP_KEYS = ("examples_per_sec",)


def _bce_softplus(labels, logits, sample_weight=None):
    labels = labels.reshape(logits.shape).astype(logits.dtype)
    return jlosses._weighted_mean(jax.nn.softplus(logits) - logits * labels, sample_weight)


def jax_mesh(shape):
    return jax_make_mesh(shape, devices=jax.devices("cpu")[:4])


# ---- the JAX side of each case ---------------------------------------------

def jax_dyn11():
    schema = JSchema([jcat("item", 1_000_000, tags=(JTags.ITEM_ID,)),
                      jcat("click", 1, tags=(JTags.TARGET, JTags.BINARY_CLASSIFICATION))])
    raw = (np.arange(64, dtype=np.int64) % 24) * 1009 + 7
    ds = mm.data.Dataset({"item": raw, "click": (raw % 2).astype(np.float32)}, schema=schema)
    return ds, jax_dyn_model(ds, {"item": 64}, 8, 16)


def jax_dyn_race():
    schema = JSchema([jcat("item", 10**9, tags=(JTags.ITEM_ID,)),
                      jcat("user", 10**9, tags=(JTags.USER_ID,)),
                      jcat("click", 1, tags=(JTags.TARGET, JTags.BINARY_CLASSIFICATION))])
    cols = W.dyn_race_data().to_numpy_dict()
    ds = mm.data.Dataset({k: cols[k] for k in ("item", "user", "click")}, schema=schema)
    return ds, jax_dyn_model(ds, {"item": 40, "user": 32}, 4, 8)


def jax_dyn_model(ds, capacity, dim, hidden):
    emb = mm.Embeddings(ds.schema.categorical.excluding_by_tag(JTags.TARGET), dim=dim,
                        dynamic=True, dynamic_capacity=capacity)
    body = mm.SequentialBlock([mm.InputBlockV2(ds.schema, categorical=emb),
                               mm.MLPBlock([hidden])])
    return mm.Model(body, mm.BinaryOutput("click"))


def jax_session():
    ds = jax_generate("sequence-testing", num_rows=64, seed=7)
    return ds, mm.SessionBasedTransformerModel(
        ds.schema, transformer=JGPT2(d_model=32, n_head=2, n_layer=1, dropout=0.0),
        embedding_dim=16)


def jax_tied():
    ds = jax_generate("sequence-testing", num_rows=64, seed=7)
    schema = ds.schema
    inputs = mm.SequentialBlock([mm.InputBlockV2(schema.excluding_by_tag(JTags.TARGET), dim=16,
                                                 aggregation=None), JConcat()])
    table = jfind_table(inputs, schema.select_by_tag(JTags.ITEM_ID).first.domain_name)
    body = mm.SequentialBlock([inputs, JGPT2(d_model=16, n_head=2, n_layer=1, dropout=0.0),
                               JProject(table.dim)])
    return ds, mm.Model(body, mm.NextItemPredictionTask(schema, table=table))


def jax_music():
    ds = jax_generate("music-streaming", num_rows=64, seed=7)
    return ds, mm.DLRMModel(ds.schema, embedding_dim=16, top_block=(16,))


def jax_ex06():
    ds = jax_get_movielens(variant="ml-25m", num_rows=320)[0]
    return ds, mm.TwoTowerModel(ds.schema, query_tower=(64, 32), embedding_dim=32)


JAX_CASES = {"dyn11": jax_dyn11, "dyn_sparse": jax_dyn_race, "session": jax_session,
             "tied": jax_tied, "music": jax_music, "ex06": jax_ex06}
DYNAMIC = ("dyn11", "dyn_sparse")


def jax_state(name, model):
    kind = nnx.Variable if name in DYNAMIC else nnx.Param
    return {"/".join(str(p) for p in path): np.asarray(v[...])
            for path, v in nnx.state(model, kind).flat_state()
            if "sparse_slots" not in path}


def jax_pre(name, ds):
    return JNext(ds.schema, target="item_id_seq") if name in ("session", "tied") else None


def jax_keys(model) -> list:
    return [np.asarray(m.hash_keys.value) for _, m in nnx.iter_graph(model)
            if isinstance(m, JDyn)]


def jax_fit(name, shape, bucket=False, mixed=False):
    """JAX's fit of a fresh model (the seeded weights the port carried):
    its history, its dynamic tables' keys, its evaluate."""
    ds, jm = JAX_CASES[name]()
    _, _, batch, epochs, compile_kw, _ = W.case(name)
    kw = dict(compile_kw)
    if kw.pop("embedding_optimizer", None):
        kw["embedding_optimizer"] = "sparse_adagrad"
    jm.compile(**kw)
    data = JLoader(ds, batch, pad="bucket", drop_last=True) if bucket else ds
    mesh = jax_mesh(shape) if shape is not None else None
    if mixed:
        jax_set_policy("mixed_bfloat16")
    try:
        h = jm.fit(data, epochs=epochs, batch_size=batch, shuffle=False, verbose=0, mesh=mesh,
                   pre=jax_pre(name, ds))
    finally:
        jax_set_policy("float32")
    out = {"history": h.history, "keys": jax_keys(jm)}
    if name not in ("tied", "session"):
        out["evaluate"] = jm.evaluate(ds, batch_size=batch)
    return out


def head_case():
    """A tied head's inputs: a 40-row table (JAX's seeded rows), 16 queries
    of width 8, the weights of ``sum(logits * w)``; JAX's logits and
    gradients of it."""
    rng = np.random.default_rng(8)
    C, D, B = 40, 8, 16
    head = JTied(JTable(D, jcat("item", C - 1), seed=1))
    x = rng.normal(size=(B, D)).astype(np.float32)
    w = rng.normal(size=(B, C)).astype(np.float32)
    graphdef, params, rest = nnx.split(head, nnx.Param, ...)

    def loss(p, xv):
        return jnp.sum(nnx.merge(graphdef, p, rest)(xv) * w)

    (g_table,), g_x = (lambda g: ([v[...] for _, v in g[0].flat_state()], g[1]))(
        jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x)))
    table = np.asarray(head.table.table.value)
    arrays = {"table": table, "x": x, "w": w, "catalog": C}
    want = {"logits": np.asarray(head(jnp.asarray(x))), "table_grad": np.asarray(g_table),
            "x_grad": np.asarray(g_x)}
    return arrays, want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setitem(jlosses.loss_registry._store, "binary_crossentropy", _bce_softplus)
    try:
        states, single = {}, {}
        for name in W.CASES:
            ds, jm = JAX_CASES[name]()
            jm.build(JLoader(ds, 16))
            tm = W.built(name)
            mt.load_jax_params(tm, jax_state(name, jm))
            states[name] = {k: v.clone() for k, v in model_state(tm).items()}
            single[name] = W.fit_case(name, states[name])
        single["session_bucket"] = W.fit_case("session", states["session"], bucket=True)
        single["tied_mixed"] = W.fit_case("tied", states["tied"], mixed=True)
        head_arrays, head_want = head_case()
        box = {}

        def ranks():
            try:
                box["out"] = spawn(W.mesh_suite, 4,
                                   (states, head_arrays, str(tmp_path_factory.mktemp("mesh"))),
                                   timeout=600)
            except BaseException as err:  # reported below, after the JAX side
                box["err"] = err

        thread = threading.Thread(target=ranks)
        thread.start()
        try:
            ref = {}
            for name in W.CASES:
                ref[(name, None)] = jax_fit(name, None)
                ref[(name, W.key(W.MESH))] = jax_fit(name, W.MESH)
            ref[("dyn11", "4x1")] = jax_fit("dyn11", {"data": 4, "model": 1})
            ref[("session_bucket", "2x2")] = jax_fit("session", W.MESH, bucket=True)
            ref[("tied_mixed", "2x2")] = jax_fit("tied", W.MESH, mixed=True)
        finally:
            thread.join()
        if "err" in box:
            raise box["err"]
        return {"ranks": box["out"], "jax": ref, "single": single, "head": head_want}
    finally:
        mp.undo()


def assert_logs_close(got, want, what, rtol=RTOL):
    keys = [k for k in want if k in got and k not in SKIP_KEYS]
    assert "loss" in keys, (what, sorted(got), sorted(want))
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-6, err_msg=f"{what}: {k}")


def check_fit(runs, name, mesh_key, jax_name=None, single_name=None, rtol=RTOL):
    """Every rank's fit against JAX's mesh fit, JAX's one device and the
    port's one process; the dynamic tables' keys equal to JAX's mesh fit's
    and alike on every rank."""
    rec_key = f"{name}/{mesh_key}" if jax_name is None else jax_name
    want = runs["jax"][(jax_name or name, mesh_key)]
    one = runs["single"][single_name or name]
    for rank, out in enumerate(runs["ranks"]):
        got = out[rec_key]
        what = f"{rec_key} rank {rank}"
        assert_logs_close(got["history"], want["history"], what + " vs JAX's mesh fit", rtol)
        np.testing.assert_allclose(got["history"]["loss"], one["history"]["loss"], rtol=RTOL,
                                   err_msg=what + " vs the port on one process")
        if "evaluate" in want:
            assert_logs_close(got["evaluate"], want["evaluate"], what + " evaluate")
        keys = [got["keys"][k] for k in sorted(got["keys"])]
        assert len(keys) == len(want["keys"])
        for mine, theirs, alone in zip(keys, want["keys"],
                                       [one["keys"][k] for k in sorted(one["keys"])]):
            np.testing.assert_array_equal(mine, theirs, err_msg=what + " keys vs JAX")
            np.testing.assert_array_equal(mine, alone, err_msg=what + " keys vs one process")
    if jax_name is None and (name, None) in runs["jax"]:
        np.testing.assert_allclose(runs["ranks"][0][rec_key]["history"]["loss"],
                                   runs["jax"][(name, None)]["history"]["loss"], rtol=rtol,
                                   err_msg=f"{rec_key} vs JAX's one device")


@pytest.mark.parametrize("mesh_key", ["2x2", "4x1"])
def test_dynamic_tables_dense_adam_on_mesh_match_jax(runs, mesh_key):
    """Dry run 11: Adam over a dynamic table on the mesh; 24 ids allocate 24
    slots, as in JAX's dry run."""
    check_fit(runs, "dyn11", mesh_key)
    for out in runs["ranks"]:
        assert out[f"dyn11/{mesh_key}"]["allocated"] == {"item": 24}


def test_dynamic_tables_row_sparse_on_mesh_match_jax(runs):
    """Row-sparse adagrad on the slots at capacity 40 for 60 distinct items:
    ids of different ranks race for slots and overflow to the fallback slot
    as JAX's one scatter over the global batch resolves them."""
    check_fit(runs, "dyn_sparse", "2x2")
    allocated = runs["ranks"][0]["dyn_sparse/2x2"]["allocated"]
    assert allocated["item"] == 40  # every slot taken: some ids fell back


def test_dynamic_mesh_checkpoint_resumes_the_trajectory(runs):
    """ModelCheckpoint on the mesh after epoch 2 of 3, restore_training
    (mesh=) into a fresh model, fit(initial_epoch=): the uninterrupted
    losses and keys (the keys ride the checkpoint)."""
    for out in runs["ranks"]:
        res = out["resume"]
        assert res["step"] == 1
        assert res["restored_keys_equal"] and res["keys_equal"]
        np.testing.assert_allclose(res["stitched"], res["full"], rtol=1e-6)


def test_dynamic_model_saved_and_exported_from_mesh_state_serves_predict(runs):
    """save and export_serving from a mesh-trained dynamic model (the
    chief writes the gathered tables and the keys): the loaded model's keys
    are the trained ones, and it and the served program give ``predict``."""
    for out in runs["ranks"]:
        res = out["export"]
        assert res["keys_equal"]
        np.testing.assert_allclose(res["loaded"], res["predict"], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(res["served"], res["predict"][:32], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("bucket", [False, True], ids=["max", "bucket"])
def test_session_transformer_on_mesh_matches_jax(runs, bucket):
    """Dry run 4: in-batch negatives over the global flattened positions;
    with ``pad="bucket"`` the pad length agreed over the global batch."""
    if bucket:
        check_fit(runs, "session", "2x2", jax_name="session_bucket",
                  single_name="session_bucket")
    else:
        check_fit(runs, "session", "2x2")


def test_tied_head_logits_and_gradients_over_a_split_table_match_jax(runs):
    """The tied head over a table split by rows on {2, 2}: each rank's
    logits and query gradients are its rows of JAX's; its shard's gradient,
    the data line's mean, is its rows of JAX's over the data line's size."""
    want = runs["head"]
    for rank, out in enumerate(runs["ranks"]):
        got = out["tied_head"]
        lo, hi = got["rows"]
        np.testing.assert_allclose(got["logits"], want["logits"][lo:hi], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["x_grad"], want["x_grad"][lo:hi], rtol=1e-5, atol=1e-6)
        n = got["shard_grad"].shape[0]
        np.testing.assert_allclose(got["shard_grad"] * got["dp"],
                                   want["table_grad"][got["lo"]:got["lo"] + n], rtol=1e-5,
                                   atol=1e-5, err_msg=f"rank {rank}")


def test_tied_next_item_head_trains_on_mesh_like_jax(runs):
    """``NextItemPredictionTask(table=)`` over the item table split by rows:
    two epochs on {2, 2} against JAX's mesh fit and one process."""
    check_fit(runs, "tied", "2x2")


def test_tied_next_item_head_trains_on_mesh_under_mixed_bfloat16(runs):
    check_fit(runs, "tied", "2x2", jax_name="tied_mixed", single_name="tied_mixed",
              rtol=MIXED_RTOL)


def test_music_streaming_multi_task_dlrm_on_mesh_matches_jax(runs):
    """Dry run 3: three heads (click, like, play_percentage) on {2, 2}."""
    check_fit(runs, "music", "2x2")
    heads = {"loss/click/BinaryOutput", "loss/like/BinaryOutput",
             "loss/play_percentage/RegressionOutput"}
    for out in runs["ranks"]:
        assert heads <= set(out["music/2x2"]["history"])


def test_example_06_flow_on_mesh_matches_jax(runs):
    """``get_movielens("ml-25m")`` synthesized into the two-tower model,
    trained on {2, 2}."""
    check_fit(runs, "ex06", "2x2")
