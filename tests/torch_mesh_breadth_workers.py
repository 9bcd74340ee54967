"""Rank workers of ``test_torch_mesh_breadth.py``: the last mesh
configurations of the JAX package's multi-chip dry runs (dynamic-vocabulary
tables, the session transformer, the tied full-catalog next-item head, the
music-streaming multi-task DLRM) and example 06's flow, each rank a process
of its own started by ``models_tpu_torch.parallel.launch.spawn``. This
module imports the port and nothing of JAX: the parent builds each JAX
model, carries its parameters into a port state and hands the ranks that
state; the ranks return host values."""

from __future__ import annotations

import os

import numpy as np
import torch

import models_tpu_torch as mt
from models_tpu_torch.core.types import ModelContext
from models_tpu_torch.inputs.dynamic import DynamicEmbeddingTable
from models_tpu_torch.models.session import (_find_item_table, _ProjectToTableDim,
                                             _SequenceConcat)
from models_tpu_torch.outputs import EmbeddingTablePrediction
from models_tpu_torch.parallel import barrier, initialize, make_mesh, shard_state, shutdown
from models_tpu_torch.transformer.block import GPT2Block
from models_tpu_torch.transforms.sequence import SequencePredictNext
from models_tpu_torch.utils.io import load_state

TIMEOUT = 120
MESH = {"data": 2, "model": 2}
DYN_MESHES = (MESH, {"data": 4, "model": 1})
CPU = torch.device("cpu")


def key(shape) -> str:
    return f"{shape['data']}x{shape['model']}"


# ---------------------------------------------------------------------------
# data and models, the same seeded construction on every rank and in the
# parent
# ---------------------------------------------------------------------------

def dyn11_data():
    """Dry run 11's data: 24 distinct raw ids over 64 rows."""
    schema = mt.Schema([
        mt.create_categorical_column("item", 1_000_000, tags=(mt.Tags.ITEM_ID,)),
        mt.create_categorical_column("click", 1, tags=(mt.Tags.TARGET,
                                                       mt.Tags.BINARY_CLASSIFICATION))])
    raw = (np.arange(64, dtype=np.int64) % 24) * 1009 + 7
    return mt.Dataset({"item": raw, "click": (raw % 2).astype(np.float32)}, schema=schema)


def dyn_race_data():
    """60 distinct 31-bit item ids and 30 hashed user names over 96 rows:
    at capacity 40 the items overflow their windows and ranks race."""
    schema = mt.Schema([
        mt.create_categorical_column("item", 10**9, tags=(mt.Tags.ITEM_ID,)),
        mt.create_categorical_column("user", 10**9, tags=(mt.Tags.USER_ID,)),
        mt.create_categorical_column("click", 1, tags=(mt.Tags.TARGET,
                                                       mt.Tags.BINARY_CLASSIFICATION))])
    rng = np.random.default_rng(4)
    items = rng.integers(0, 60, 96).astype(np.int64) * 2654435761 % 2**31
    users = mt.string_id_hash(np.array([f"user_{u}" for u in rng.integers(0, 30, 96)]))
    return mt.Dataset({"item": items, "user": users.astype(np.int64),
                       "click": (items % 2).astype(np.float32)}, schema=schema)


def dyn_model(ds, capacity, dim, hidden):
    emb = mt.Embeddings(ds.schema.categorical.excluding_by_tag(mt.Tags.TARGET), dim=dim,
                        dynamic=True, dynamic_capacity=capacity, device="cpu")
    body = mt.SequentialBlock([mt.InputBlockV2(ds.schema, categorical=emb, device="cpu"),
                               mt.MLPBlock([hidden])])
    return mt.Model(body, mt.BinaryOutput("click"))


def session_data():
    return mt.generate_data("sequence-testing", num_rows=64, seed=7)


def session_model(ds):
    return mt.SessionBasedTransformerModel(
        ds.schema, transformer=GPT2Block(d_model=32, n_head=2, n_layer=1, dropout=0.0,
                                         device="cpu"),
        embedding_dim=16, device="cpu")


def tied_model(ds):
    """InputBlockV2 -> GPT2Block(16, 2, 1) -> projection -> the tied
    full-catalog ``NextItemPredictionTask(table=)``."""
    schema = ds.schema
    item_col = schema.select_by_tag(mt.Tags.ITEM_ID).first
    inputs = mt.InputBlockV2(schema.excluding_by_tag(mt.Tags.TARGET), dim=16, aggregation=None,
                             device="cpu")
    table = _find_item_table(inputs, item_col.domain_name)
    tr = GPT2Block(d_model=16, n_head=2, n_layer=1, dropout=0.0, device="cpu")
    tr.set_in_features(inputs.out_features, CPU)
    body = mt.SequentialBlock([inputs, _SequenceConcat(), tr,
                               _ProjectToTableDim(tr.d_model, table.dim, device="cpu")])
    return mt.Model(body, mt.NextItemPredictionTask(schema, table=table, device="cpu"))


def music_data():
    return mt.generate_data("music-streaming", num_rows=64, seed=7)


def music_model(ds):
    return mt.DLRMModel(ds.schema, embedding_dim=16, top_block=(16,), device="cpu")


def two_tower_06_data():
    return mt.data.datasets.get_movielens(variant="ml-25m", num_rows=320)


def two_tower_06(ds):
    return mt.TwoTowerModel(ds.schema, query_tower=(64, 32), embedding_dim=32, device="cpu")


# case -> (data, model, batch, epochs, compile keywords, fit keywords)
def case(name):
    if name == "dyn11":
        ds = dyn11_data()
        return (ds, lambda: dyn_model(ds, {"item": 64}, 8, 16), 16, 2,
                dict(optimizer="adam", learning_rate=0.05, metrics=[]), {})
    if name == "dyn_sparse":
        ds = dyn_race_data()
        return (ds, lambda: dyn_model(ds, {"item": 40, "user": 32}, 4, 8), 32, 2,
                dict(optimizer="adam", learning_rate=0.05, embedding_optimizer="adagrad",
                     metrics=[]), {})
    if name == "session":
        ds = session_data()
        return (ds, lambda: session_model(ds), 16, 2,
                dict(optimizer="adagrad", learning_rate=0.05, metrics=[]),
                dict(pre=SequencePredictNext(ds.schema, target="item_id_seq")))
    if name == "tied":
        ds = session_data()
        return (ds, lambda: tied_model(ds), 16, 2,
                dict(optimizer="adagrad", learning_rate=0.05, metrics=[]),
                dict(pre=SequencePredictNext(ds.schema, target="item_id_seq")))
    if name == "music":
        ds = music_data()
        return (ds, lambda: music_model(ds), 16, 2,
                dict(optimizer="adagrad", learning_rate=0.05, metrics=[]), {})
    if name == "ex06":
        ds = two_tower_06_data()[0]
        return (ds, lambda: two_tower_06(ds), 32, 1,
                dict(optimizer="adagrad", learning_rate=0.05, metrics=[]), {})
    raise KeyError(name)


CASES = ("dyn11", "dyn_sparse", "session", "tied", "music", "ex06")


def built(name, state=None):
    """The case's model, its lazy layers built on the CPU, carrying
    ``state`` where given."""
    ds, make, batch, _, _, _ = case(name)
    model = make().build(mt.Loader(ds, batch), device="cpu")
    if state is not None:
        load_state(model, state, CPU)
    return model


def dynamic_keys(model) -> dict:
    return {m.block_name: m.hash_keys.clone() for m in model.modules()
            if isinstance(m, DynamicEmbeddingTable)}


def fit_case(name, state, mesh=None, epochs=None, bucket=False, mixed=False) -> dict:
    """The case's fit from ``state`` (on ``mesh`` where given; with
    ``bucket`` from a ``pad="bucket"`` loader; with ``mixed`` under the
    ``mixed_bfloat16`` policy): each epoch's logs, the dynamic tables' keys
    and allocations after it, ``evaluate``."""
    ds, _, batch, n_epochs, compile_kw, fit_kw = case(name)
    model = built(name, state)
    model.compile(**compile_kw)
    data = mt.Loader(ds, batch, pad="bucket", drop_last=True) if bucket else ds
    if mixed:
        mt.set_dtype_policy("mixed_bfloat16")
    try:
        hist = model.fit(data, epochs=epochs or n_epochs, batch_size=batch, shuffle=False,
                         device="cpu", mesh=mesh, **fit_kw)
    finally:
        mt.set_dtype_policy("float32")
    keys = dynamic_keys(model)
    out = {"history": hist.history, "keys": {k: v.numpy() for k, v in keys.items()},
           "allocated": {k: int((v != -1).sum()) for k, v in keys.items()}}
    if name not in ("tied", "session"):
        out["evaluate"] = model.evaluate(ds, batch_size=batch, device="cpu")
    return out


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def tied_head_case(mesh, arrays) -> dict:
    """The tied head alone on a table split over the model axis, inside a
    mesh step: this rank's queries (its data slice), its logits, and the
    gradients of ``sum(logits * w)`` (the shard's the data line's mean, the
    queries' this rank's own)."""
    rows, x, w = (torch.from_numpy(arrays[k]) for k in ("table", "x", "w"))
    table = mt.EmbeddingTable(rows.shape[1], mt.create_categorical_column(
        "item", int(arrays["catalog"]) - 1), device="cpu")
    with torch.no_grad():
        table.table.copy_(rows)
    head = EmbeddingTablePrediction(table)
    shard_state(head, mesh)
    dp, d = mesh.size("data"), mesh.index("data")
    b = x.shape[0] // dp
    xs = x[d * b:(d + 1) * b].clone().requires_grad_()
    ctx = ModelContext(features={})
    ctx["mesh"] = mesh
    logits = head(xs, training=True, context=ctx)
    (logits * w[d * b:(d + 1) * b]).sum().backward()
    return {"logits": logits.detach().numpy(), "x_grad": xs.grad.numpy(),
            "shard_grad": table.table.grad.numpy(), "lo": table.shard.lo, "dp": dp,
            "rows": (d * b, (d + 1) * b)}


def resume_case(state, tmp, mesh) -> dict:
    """A dynamic, row-sparse fit checkpointed after epoch 1 on the mesh,
    restored into a fresh model on the mesh and continued: the losses and
    keys of the uninterrupted fit."""
    ds, _, batch, _, compile_kw, _ = case("dyn_sparse")

    def fresh():
        m = built("dyn_sparse", state)
        m.compile(**compile_kw)
        return m

    kw = dict(batch_size=batch, shuffle=False, device="cpu", mesh=mesh)
    whole = fresh()
    full = whole.fit(ds, epochs=3, **kw).history["loss"]
    m1 = fresh()
    part1 = m1.fit(ds, epochs=2, callbacks=[mt.ModelCheckpoint(tmp, every_n_epochs=1)],
                   **kw).history["loss"]
    m2 = fresh()
    step = mt.CheckpointManager(tmp).restore_training(m2, data=ds, device="cpu", mesh=mesh)
    keys_restored = dynamic_keys(m2)
    part2 = m2.fit(ds, epochs=3, initial_epoch=step + 1, **kw).history["loss"]
    same = all(torch.equal(a, b) for a, b in zip(dynamic_keys(m2).values(),
                                                 dynamic_keys(whole).values()))
    restored = all(torch.equal(a, b) for a, b in zip(keys_restored.values(),
                                                     dynamic_keys(m1).values()))
    return {"full": full, "stitched": part1 + part2, "step": step, "keys_equal": same,
            "restored_keys_equal": restored}


def export_case(state, tmp, mesh) -> dict:
    """A dynamic model trained on the mesh, saved and exported from mesh
    state (every rank calls; the chief writes): the loaded model's keys
    and predictions, and the served program's outputs, against
    ``predict``."""
    ds, _, batch, _, compile_kw, _ = case("dyn_sparse")
    m = built("dyn_sparse", state)
    m.compile(**compile_kw)
    m.fit(ds, epochs=1, batch_size=batch, shuffle=False, device="cpu", mesh=mesh)
    saved = os.path.join(tmp, "saved")
    m.save(saved)
    srv = m.export_serving(os.path.join(tmp, "srv"), data=ds, batch_size=batch, device="cpu")
    barrier()
    loaded = mt.load_model(saved, device="cpu")
    x, _ = next(iter(mt.Loader(ds, batch)))
    served = mt.load_serving(srv, device="cpu")({k: v for k, v in x.items()
                                                 if k != "__row_valid__"})
    return {"predict": m.predict(ds, batch_size=batch, device="cpu"),
            "loaded": loaded.predict(ds, batch_size=batch, device="cpu"),
            "served": np.asarray(served),
            "keys_equal": all(torch.equal(a, b) for a, b in zip(dynamic_keys(loaded).values(),
                                                                dynamic_keys(m).values()))}


def mesh_suite(rank, world, init, states, head_arrays, tmp):
    # four ranks on the host's cores: one thread each, else the ranks'
    # thread pools contend for the cores tenfold
    torch.set_num_threads(1)
    initialize(init, world, rank, backend="gloo", device="cpu", timeout=TIMEOUT)
    try:
        out = {}
        for shape in DYN_MESHES:
            mesh = make_mesh(shape, device="cpu")
            out[f"dyn11/{key(shape)}"] = fit_case("dyn11", states["dyn11"], mesh)
        mesh = make_mesh(MESH, device="cpu")
        for name in ("dyn_sparse", "session", "tied", "music", "ex06"):
            out[f"{name}/{key(MESH)}"] = fit_case(name, states[name], mesh)
        out["session_bucket"] = fit_case("session", states["session"], mesh, bucket=True)
        out["tied_mixed"] = fit_case("tied", states["tied"], mesh, mixed=True)
        out["tied_head"] = tied_head_case(mesh, head_arrays)
        out["resume"] = resume_case(states["dyn_sparse"], os.path.join(tmp, "ckpt"), mesh)
        out["export"] = export_case(states["dyn_sparse"], tmp, mesh)
        return out
    finally:
        shutdown()
