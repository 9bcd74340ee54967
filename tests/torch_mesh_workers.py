"""Rank workers of the port's mesh tests (``test_torch_parallel.py``,
``test_torch_sharded_ops.py``): each runs in a process of its own, started
by ``models_tpu_torch.parallel.launch.spawn``, joins four gloo ranks on the
CPU and runs a suite of cases, returning host values. This module imports
the port and nothing of JAX: the tests compute the JAX references in the
parent process and hand the ranks what they need (the JAX model's
parameters carried into a port state, the stochastic-rounding bits JAX
draws)."""

from __future__ import annotations

import os
import time

import numpy as np
import torch

import models_tpu_torch as mt
from models_tpu_torch.ops.embedding_lookup import (sharded_lookup, sharded_row_scatter_add,
                                                   sharded_update_rows)
from models_tpu_torch.ops.topk import sharded_topk
from models_tpu_torch.outputs.topk import BruteForce
from models_tpu_torch.parallel import (initialize, make_mesh, shard_batch, sharding_for_tree,
                                       shutdown)
from models_tpu_torch.parallel.collectives import TRAFFIC
from models_tpu_torch.utils.io import load_state

MESHES = ({"data": 4, "model": 1}, {"data": 2, "model": 2}, {"data": 1, "model": 4})
TIMEOUT = 120


def key(shape) -> str:
    return f"{shape['data']}x{shape['model']}"


class NoiseTable:
    """Stochastic-rounding bits by (shape, salt, step), drawn by the parent
    (the JAX package's); a draw it does not hold raises."""

    def __init__(self, bits):
        self.bits = bits

    def __call__(self, shape, salt, step, device):
        return torch.from_numpy(self.bits[(tuple(shape), int(salt), int(step))].copy()).to(device)


def join(rank, world, init):
    initialize(init, world, rank, backend="gloo", device="cpu", timeout=TIMEOUT)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def two_tower_data():
    return mt.generate_data("movielens-100k", num_rows=128, seed=0)


def dlrm_data():
    return mt.generate_data("e-commerce", num_rows=128, seed=0)


def make_model(kind: str, ds):
    """The port's model of a fit case (its weights come from the parent)."""
    if kind == "dlrm":
        return mt.DLRMModel(ds.schema, embedding_dim=8, bottom_block=(8,), top_block=(8,),
                            device="cpu")
    dt = torch.bfloat16 if kind == "bf16" else None
    return mt.TwoTowerModel(ds.schema, query_tower=(16, 8), embedding_dim=8, table_dtype=dt,
                            device="cpu")


def compile_case(model, kind: str, metrics):
    kw = {} if kind in ("dense", "dlrm") else {"embedding_optimizer": "adagrad"}
    model.compile(optimizer="adam", learning_rate=0.05, metrics=metrics, **kw)


def mf_schema():
    return mt.Schema([
        mt.create_categorical_column("user_id", 23, tags=(mt.Tags.USER, mt.Tags.USER_ID)),
        mt.create_categorical_column("item_id", 23, tags=(mt.Tags.ITEM, mt.Tags.ITEM_ID)),
    ])


def mf_data():
    rows = np.arange(64, dtype=np.int32) % 23
    return mt.Dataset({"user_id": rows, "item_id": rows.copy()}, schema=mf_schema())


def mf_model(state):
    m = mt.MatrixFactorizationModel(mf_schema(), dim=8, device="cpu")
    load_state(m, state, torch.device("cpu"))
    m.compile(optimizer="adam", learning_rate=0.05, metrics=[])
    return m


# ---------------------------------------------------------------------------
# the suite of test_torch_parallel.py
# ---------------------------------------------------------------------------

def fit_case(kind, shape, states, noise, metrics):
    ds = dlrm_data() if kind == "dlrm" else two_tower_data()
    mesh = make_mesh(shape, device="cpu")
    model = make_model(kind, ds)
    load_state(model, states[kind], torch.device("cpu"))
    compile_case(model, kind, metrics)
    if noise is not None:
        model._emb_opt.noise = NoiseTable(noise)
    TRAFFIC.reset()
    hist = model.fit(ds, epochs=2, batch_size=16, shuffle=False, device="cpu", mesh=mesh)
    traffic = TRAFFIC.snapshot()
    # the smallest table this rank holds of the model's real ones (512 rows
    # or more: the demographic tables are the size of a batch's rows)
    held = [t.table.numel() * t.table.element_size() for t in model._embedding_tables()
            if t.padded_rows >= 512]
    # the dense parameters, whose gradients the step all-reduces
    sharded = model._sharded_ids()
    dense = sum(p.numel() * p.element_size() for g in model._optimizer.param_groups
                for p in g["params"] if id(p) not in sharded)
    ev = model.evaluate(ds, batch_size=24, device="cpu")
    return {"history": hist.history, "evaluate": ev, "traffic": traffic,
            "min_table_bytes": min(held) if held else None, "dense_bytes": dense}


def topk_case(state, shape):
    ds = mt.generate_data("e-commerce", num_rows=64, seed=0)
    m = mt.TwoTowerModel(ds.schema, query_tower=(16, 8), device="cpu")
    load_state(m, state, torch.device("cpu"))
    mesh = make_mesh(shape, device="cpu")
    out = {}
    for tag, dtype in (("fp32", None), ("int8", torch.int8)):
        enc = m.to_top_k_encoder(ds, k=5, device="cpu", mesh=mesh, candidate_dtype=dtype)
        out[tag] = enc.evaluate(ds, batch_size=16, device="cpu")
        out[tag + "_predict"] = enc.predict(ds.take(16), batch_size=16, device="cpu")
    return out


def resume_case(states, tmp):
    mesh = make_mesh({"data": 2, "model": 2}, device="cpu")
    ds = mf_data()
    full = mf_model(states["mf"]).fit(ds, epochs=4, batch_size=16, shuffle=False,
                                      device="cpu", mesh=mesh).history["loss"]
    m1 = mf_model(states["mf"])
    cb = mt.ModelCheckpoint(tmp, every_n_epochs=1)
    part1 = m1.fit(ds, epochs=2, batch_size=16, shuffle=False, device="cpu", mesh=mesh,
                   callbacks=[cb]).history["loss"]
    m2 = mf_model(states["mf"])
    step = mt.CheckpointManager(tmp).restore_training(m2, data=ds, device="cpu", mesh=mesh)
    part2 = m2.fit(ds, epochs=4, batch_size=16, shuffle=False, device="cpu", mesh=mesh,
                   initial_epoch=step + 1).history["loss"]
    return {"full": full, "stitched": part1 + part2, "step": step}


def export_case(states, tmp):
    mesh = make_mesh({"data": 2, "model": 2}, device="cpu")
    ds = mf_data()
    m = mf_model(states["mf"])
    m.fit(ds, epochs=1, batch_size=16, shuffle=False, device="cpu", mesh=mesh)
    path = m.export_serving(os.path.join(tmp, "srv"), data=ds, batch_size=16, device="cpu")
    served = mt.load_serving(path, device="cpu")
    x, _ = next(iter(mt.Loader(ds, 16)))
    out = served({k: v for k, v in x.items() if k != "__row_valid__"})
    saved = os.path.join(tmp, "saved")
    m.save(saved)
    loaded = mt.load_model(saved, device="cpu")
    return {"served": np.asarray(out), "predict": m.predict(ds, batch_size=16, device="cpu"),
            "loaded": loaded.predict(ds, batch_size=16, device="cpu")}


def layout_case(shape):
    mesh = make_mesh(shape, device="cpu")
    schema = mt.Schema([mt.create_categorical_column("item", 99),
                        mt.create_categorical_column("tiny", 6)])
    tables = mt.Embeddings(schema, dim=8, device="cpu")
    specs = sharding_for_tree(tables, mesh)
    batch = {"a": np.arange(16 * 3).reshape(16, 3), "b": np.arange(7),
             "s": mt.SequenceFeature(np.arange(32).reshape(16, 2), np.ones((16, 2), bool))}
    part = shard_batch(batch, mesh)
    return {"coords": mesh.coords, "data_ranks": mesh.group("data").ranks,
            "model_ranks": mesh.group("model").ranks, "specs": specs,
            "a": part["a"], "b": part["b"], "s": (part["s"].values, part["s"].mask)}


def parallel_suite(rank, world, init, states, noise, tmp):
    join(rank, world, init)
    try:
        out = {"layout": {key(s): layout_case(s) for s in MESHES}}
        try:
            make_mesh({"data": 3, "model": 1}, device="cpu")
            out["bad_shape"] = None
        except ValueError as err:
            out["bad_shape"] = str(err)
        for kind in ("dense", "sparse", "bf16", "dlrm"):
            for shape in MESHES:
                metrics = None if (kind == "dense" and shape["model"] == 2) else []
                out[f"fit/{kind}/{key(shape)}"] = fit_case(
                    kind, shape, states, noise.get(kind), metrics)
        out["topk"] = {key(s): topk_case(states["topk"], s)
                       for s in ({"data": 1, "model": 4}, {"data": 2, "model": 2})}
        out["resume"] = resume_case(states, os.path.join(tmp, "ckpt"))
        out["export"] = export_case(states, tmp)
        return out
    finally:
        shutdown()


def failing_rank(rank, world, init, mode):
    """Rank 1 raises (``mode="raise"``) or outlives any deadline
    (``"hang"``); the others return at once."""
    if rank == 1:
        if mode == "raise":
            raise ValueError("rank 1 refuses")
        time.sleep(600)
    return rank


# ---------------------------------------------------------------------------
# the suite of test_torch_sharded_ops.py
# ---------------------------------------------------------------------------

def lookup_cases(shape, case):
    mesh = make_mesh(shape, device="cpu")
    table, ids, w = (torch.from_numpy(case[k]) for k in ("table", "ids", "w"))
    n, m = mesh.size("model"), mesh.index("model")
    dp, d = mesh.size("data"), mesh.index("data")
    rows = table.shape[0] // n
    shard = table[m * rows:(m + 1) * rows].clone().requires_grad_()
    b = ids.shape[0] // dp
    mine, w_mine = ids[d * b:(d + 1) * b], w[d * b:(d + 1) * b]
    out = {}
    for strategy in ("a2a", "psum"):
        shard.grad = None
        got = sharded_lookup(shard, mine, mesh, data_axis="data", strategy=strategy)
        (got * w_mine).sum().backward()
        out[strategy] = (got.detach().numpy(), shard.grad.numpy().copy())
    upd, uids, valid = (torch.from_numpy(case[k]) for k in ("updates", "uids", "valid"))
    t = table[m * rows:(m + 1) * rows].clone()
    out["scatter_add"] = sharded_row_scatter_add(t, uids, upd, valid, mesh).numpy()
    t = table[m * rows:(m + 1) * rows].clone()
    out["update_rows"] = sharded_update_rows(t, torch.from_numpy(case["dup_ids"]), upd,
                                             mesh).numpy()
    return out


def topk_cases(shape, case):
    mesh = make_mesh(shape, device="cpu")
    out = {}
    q = torch.from_numpy(case["queries"])
    for name, cand in case["catalogs"].items():
        c = torch.from_numpy(cand)
        n, m = mesh.size("model"), mesh.index("model")
        rows = c.shape[0] // n
        s, i = sharded_topk(q, c[m * rows:(m + 1) * rows], case["k"], mesh)
        out[name] = (s.numpy(), i.numpy())
        for dtype in (torch.bfloat16, torch.int8):
            layer = BruteForce(k=case["k"]).index(c, dtype=dtype, device="cpu", mesh=mesh)
            pred = layer(q)
            tag = f"{name}/{str(dtype).split('.')[-1]}"
            out[tag] = (pred.scores.numpy(), pred.identifiers.numpy())
    return out


def sharded_ops_suite(rank, world, init, lookup, topk):
    join(rank, world, init)
    try:
        return {"lookup": {key(s): lookup_cases(s, lookup) for s in MESHES},
                "topk": {key(s): topk_cases(s, topk) for s in
                         ({"data": 1, "model": 4}, {"data": 2, "model": 2})}}
    finally:
        shutdown()
