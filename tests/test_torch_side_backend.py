"""The port's torch side-backend (``models_tpu_torch/torch_backend/``)
against the JAX package's (``models_tpu/torch_backend/``), on the CPU.

``tests/unit/test_backends.py``'s ``test_torch_*`` cases (``:10-66``,
``:134-192``, ``:341-478``, ``:505-1150``) as parity cases: each case body
runs once on the JAX package's names and once on the port's, on the same
seeded data; every model the JAX side builds hands its ``state_dict`` to the
port's copy (``load_torch_backend_params``), and where the JAX copy draws
from torch's global generator, the port draws from a ``torch.Generator``
seeded alike (the same stream on the CPU). Outputs, losses and metrics
agree within rtol 1e-6 (both are the same torch ops on the CPU: bit-equal
in practice).

Also: the index through ``ops/topk.py::topk_scores`` on the direct route
(C <= 4096) and the binned route (C > 4096), against the JAX copy's
``torch.topk`` on tie-free scores; and the entry points refusing to run
without a card unless given ``device="cpu"``.
"""

import os

import numpy as np
import pyarrow as pa
import pytest
import torch
from torch import nn

import models_tpu as mm
import models_tpu.torch_backend as jtb
import models_tpu_torch as mt
import models_tpu_torch.torch_backend as ptb
from models_tpu_torch.convert import load_torch_backend_params
from models_tpu_torch.ops import topk as ttopk

RTOL = 1e-6


class Side:
    """One package's names for a case body: ``tb`` the side-backend, ``pkg``
    the package root, ``dev`` the device keywords, ``sync`` to carry a
    model's weights from the JAX run to the port's, ``gen`` / ``reseed`` for
    the draws."""

    def __init__(self, port: bool, store: dict):
        self.port = port
        self.store = store
        self.count = 0
        self.tb = ptb if port else jtb
        self.pkg = mt if port else mm
        self.dev = {"device": "cpu"} if port else {}

    def sync(self, model):
        key = self.count
        self.count += 1
        if self.port:
            return load_torch_backend_params(model, self.store[key])
        sd = model.state_dict() if isinstance(model, nn.Module) else model._modules.state_dict()
        self.store[key] = {k: v.detach().numpy().copy() for k, v in sd.items()}
        return model

    def gen(self, seed: int) -> dict:
        """The port's draws from a generator seeded ``seed``."""
        return {"generator": torch.Generator().manual_seed(seed)} if self.port else {}

    def reseed(self, seed: int) -> None:
        """The JAX copy's draws from the global generator, seeded ``seed``."""
        if not self.port:
            torch.manual_seed(seed)

    def data(self, name: str, rows: int):
        return self.pkg.generate_data(name, num_rows=rows)

    def dataset(self, cols: dict, schema):
        """Columns of numpy arrays, a list column as a list of per-row arrays."""
        if self.port:
            return mt.Dataset(cols, schema=schema)
        table = {k: (pa.array([list(r) for r in v], pa.list_(pa.int32()))
                     if isinstance(v, list) else pa.array(v)) for k, v in cols.items()}
        return mm.Dataset(pa.table(table), schema=schema)

    def batch(self, data, rows: int, targets: bool = True):
        x, y = self.pkg.Loader(data, rows).peek()
        return self.tb.dsl.Batch.from_loader_batch(x, y if targets else None, **self.dev)


def arr(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def compare(got, want, path="out"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
        for k in want:
            compare(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)) and want and not np.isscalar(want[0]):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            compare(g, w, f"{path}/{i}")
    elif isinstance(want, (list, tuple)) and all(isinstance(w, str) for w in want):
        assert list(got) == list(want), (path, got, want)
    elif isinstance(want, (bool, str, type(None))):
        assert got == want, (path, got, want)
    else:
        np.testing.assert_allclose(arr(got), arr(want), rtol=RTOL, atol=0, err_msg=path)


def dataset_cols(ds):
    return {k: np.asarray(v) for k, v in ds.to_numpy_dict().items()}


# ---------------------------------------------------------------------------
# the cases: test_backends.py's bodies, returning what they computed
# ---------------------------------------------------------------------------

def case_mlp_model(s):  # :10
    data = s.data("music-streaming", 128)
    schema = data.schema.excluding_by_name(["play_percentage"])
    model = s.sync(s.tb.TorchMLPModel(schema, dims=(32, 16), **s.dev))
    hist = model.fit(data, epochs=1, batch_size=32, **s.dev)
    res = model.evaluate(data, batch_size=32, **s.dev)
    preds = model.predict(data, batch_size=32, **s.dev)
    assert preds["click"].shape == (128,)
    return {"loss": hist["loss"], "eval": res, "preds": preds}


def case_dlrm_planted(s):  # :25
    ds = s.data("e-commerce", 256)
    cols = dataset_cols(ds)
    click = (cols["user_gender"] >= 2).astype(np.int32)
    schema = ds.schema.excluding_by_name("conversion")
    cols = {k: v for k, v in cols.items() if k in schema.column_names}
    cols["click"] = click
    ds2 = s.pkg.Dataset(cols, schema=schema)
    model = s.sync(s.tb.TorchDLRMModel(ds2.schema, embedding_dim=8, top=(32, 16), **s.dev))
    hist = model.fit(ds2, epochs=2, batch_size=64, learning_rate=0.01, **s.dev)
    return {"loss": hist["loss"], "eval": model.evaluate(ds2, batch_size=64, **s.dev)}


def case_dcn_runs(s):  # :43
    data = s.data("e-commerce", 128)
    model = s.sync(s.tb.TorchDCNModel(data.schema, depth=1, deep=(16,), **s.dev))
    return {"loss": model.fit(data, epochs=1, batch_size=32, **s.dev)["loss"]}


def case_save_load(s, tmp):  # :52
    data = s.data("e-commerce", 128)
    model = s.sync(s.tb.TorchMLPModel(data.schema, dims=(16,), **s.dev))
    model.fit(data, epochs=1, batch_size=32, **s.dev)
    path = os.path.join(tmp, "port" if s.port else "jax")
    model.save(path)
    model2 = s.tb.TorchMLPModel(data.schema, dims=(16,), **s.dev).load_weights(path)
    p1 = model.predict(data, batch_size=64, **s.dev)
    p2 = model2.predict(data, batch_size=64, **s.dev)
    np.testing.assert_array_equal(p1["click"], p2["click"])
    return {"preds": p2}


def case_dlrm_per_feature_tables_and_auc(s):  # :134
    data = s.data("e-commerce", 128)
    model = s.sync(s.tb.TorchDLRMModel(data.schema, embedding_dim=8, top=(16, 8), **s.dev))
    cats = list(data.schema.categorical)
    assert len(model.embedding.tables) == len(cats)
    model.fit(data, epochs=1, batch_size=32, **s.dev)
    return {"eval": model.evaluate(data, batch_size=32, **s.dev)}


def case_dsl_block_composition(s):  # :341
    dsl = s.tb.dsl
    blk = s.sync(dsl.Block(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 4)))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32))
    rep = s.sync(blk.repeat(2))
    res = s.sync(dsl.ResidualBlock(nn.Linear(4, 4)))
    sc = s.sync(dsl.ShortcutBlock(nn.Linear(4, 6)))
    out = sc(x)
    assert out["shortcut"] is x
    return {"blk": blk(x), "rep": rep(x), "res": res(x), "sc": out["output"]}


def case_dsl_parallel_block_agg(s):  # :361
    dsl = s.tb.dsl
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((5, 4)).astype(np.float32))
    pb = s.sync(dsl.ParallelBlock({"a": nn.Linear(4, 2), "b": nn.Linear(4, 3)}))
    agg = s.sync(dsl.ParallelBlock({"a": nn.Linear(4, 2), "b": nn.Linear(4, 3)},
                                   agg=dsl.Concat()))
    return {"pb": pb(x), "agg": agg(x)}


def case_dsl_tabular_input_block(s):  # :374
    data = s.data("e-commerce", 64)
    batch = s.batch(data, 16)
    inputs = s.sync(s.tb.dsl.TabularInputBlock(data.schema, dim=8))
    out = inputs(batch.features, batch=batch)
    assert out.shape[1] == inputs.out_dim
    return {"out": out}


def _planted_click(s, n=600):
    rng = np.random.default_rng(0)
    a = rng.integers(0, 30, n)
    price = rng.standard_normal(n).astype(np.float32)
    w = rng.standard_normal(30) * 2
    click = (rng.uniform(size=n) < 1 / (1 + np.exp(-(w[a] + price)))).astype(np.int32)
    p = s.pkg
    schema = p.Schema([
        p.create_categorical_column("user_id", 29, tags=(p.Tags.USER, p.Tags.USER_ID)),
        p.create_continuous_column("price"),
        p.ColumnSchema("click", tags=(p.Tags.BINARY_CLASSIFICATION, p.Tags.TARGET),
                       dtype="int32"),
    ])
    ds = p.Dataset({"user_id": a.astype(np.int32), "price": price, "click": click},
                   schema=schema)
    return ds, schema


def case_dsl_dlrm_model(s):  # :387
    ds, schema = _planted_click(s)
    train, valid = ds.split([0.8, 0.2], seed=1)
    model = s.sync(s.tb.dsl.DLRMModel(schema, dim=8, bottom_block=(8,), top_block=(16,),
                                      **s.dev))
    hist = model.fit(train, epochs=2, batch_size=128, learning_rate=0.01, **s.dev)
    return {"loss": hist["loss"], "eval": model.evaluate(valid, **s.dev),
            "preds": model.predict(valid, **s.dev)}


def case_dsl_dcn_multitask_and_save_load(s, tmp):  # :418
    data = s.data("music-streaming", 128)
    schema = data.schema
    model = s.sync(s.tb.dsl.DCNModel(schema, depth=2, deep_block=(16, 8), dim=8, low_rank=4,
                                     **s.dev))
    model.fit(data, epochs=1, batch_size=32, **s.dev)
    res = model.evaluate(data, batch_size=32, **s.dev)
    assert "play_percentage/rmse" in res
    path = os.path.join(tmp, "port" if s.port else "jax")
    model.save(path)
    model2 = s.tb.dsl.DCNModel(schema, depth=2, deep_block=(16, 8), dim=8, low_rank=4,
                               **s.dev).load_weights(path)
    return {"eval": res, "preds": model2.predict(data, batch_size=32, **s.dev)}


def case_dsl_encoder_block_refuses_fit(s):  # :437
    data = s.data("e-commerce", 32)
    enc = s.tb.dsl.EncoderBlock(s.tb.dsl.TabularInputBlock(data.schema, dim=8), **s.dev)
    with pytest.raises(RuntimeError):
        enc.fit(data)
    return {}


def case_dsl_mmoe_cgc_attention(s):  # :447
    dsl = s.tb.dsl
    D, E = 16, 3
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((4, D)).astype(np.float32))
    mmoe = s.sync(dsl.MMOEBlock(dsl.MLPBlock((16,), D), num_experts=E, in_dim=D, out_dim=16,
                                outputs=["click", "like"]))
    cgc = s.sync(dsl.CGCBlock(dsl.MLPBlock((16,), D), num_shared=2, num_task=1, in_dim=D,
                              out_dim=16, outputs=["click", "like"]))
    att = s.sync(dsl.CrossAttentionBlock(d_model=16, n_heads=2))
    q = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 5, 16)).astype(np.float32))
    ctx = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 7, 16)).astype(np.float32))
    return {"mmoe": mmoe(x), "cgc": cgc(x), "att": att({"query": q, "context": ctx})}


def case_compat_constructs(s):  # :505
    dsl, compat, p = s.tb.dsl, s.tb.compat, s.pkg
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 4)).astype(np.float32))
    pb = s.sync(compat.repeat_parallel(nn.Linear(4, 4), n=3))
    bb = compat.BatchBlock()
    b = bb({"a": torch.ones(2, 3)}, targets={"t": torch.zeros(2)})
    assert isinstance(b, dsl.Batch) and "a" in b.features and "t" in b.targets
    schema = p.Schema([p.create_categorical_column("u", 10, tags=p.Tags.USER),
                       p.create_continuous_column("p")])
    router = compat.RouterBlock(schema)
    router.add_route(p.Tags.USER, name="user")
    routed = router({"u": torch.ones(2, dtype=torch.long), "p": torch.ones(2)})
    table = s.sync(dsl.EmbeddingTable(8, p.create_categorical_column("item", 49)))
    tying = compat.EmbeddingTablePrediction(table)
    b2s = compat.BroadcastToSequence(
        p.Schema([p.create_continuous_column("ctx")]),
        p.Schema([p.create_categorical_column("seq", 5, is_list=True, max_seq_length=4)]))
    out = b2s({"ctx": torch.ones(2, 3), "seq": torch.ones(2, 4, dtype=torch.long)})
    return {"pb": pb(x), "routed": sorted(routed) == ["u"],
            "tying": tying(torch.ones(3, 8)), "b2s": out["ctx"]}


def case_tabular_output_block_routes_multiclass(s):  # :562
    p, dsl = s.pkg, s.tb.dsl
    schema = p.Schema([
        p.create_categorical_column("cls", 7, tags=(p.Tags.TARGET,)),
        p.ColumnSchema("clicked", tags=(p.Tags.TARGET, p.Tags.BINARY_CLASSIFICATION),
                       dtype="int32"),
        p.create_continuous_column("score", tags=(p.Tags.TARGET, p.Tags.REGRESSION)),
    ])
    blk = s.sync(dsl.TabularOutputBlock(schema, in_dim=12))
    heads = blk.branches
    assert isinstance(heads["cls"], dsl.CategoricalOutput)
    assert isinstance(heads["clicked"], dsl.BinaryOutput)
    assert isinstance(heads["score"], dsl.RegressionOutput)
    return {"cls": heads["cls"](torch.ones(4, 12))}


def case_dlrm_out_dim_with_shared_domain(s):  # :589
    p = s.pkg
    schema = p.Schema([
        p.create_categorical_column("item_id", 50, tags=p.Tags.ITEM, domain_name="item"),
        p.create_categorical_column("viewed_item", 50, tags=p.Tags.ITEM, domain_name="item"),
        p.create_categorical_column("user_id", 30, tags=p.Tags.USER),
        p.create_continuous_column("age"),
        p.ColumnSchema("click", tags=(p.Tags.TARGET, p.Tags.BINARY_CLASSIFICATION),
                       dtype="int32"),
    ])
    blk = s.sync(s.tb.dsl.DLRMBlock(schema, dim=8, bottom_block=(16,)))
    assert len(blk.embeddings.branches) == 2
    rng = np.random.default_rng(6)
    x = {"item_id": torch.from_numpy(rng.integers(0, 50, 5)),
         "viewed_item": torch.from_numpy(rng.integers(0, 50, 5)),
         "user_id": torch.from_numpy(rng.integers(0, 30, 5)),
         "age": torch.from_numpy(rng.random(5).astype(np.float32))}
    return {"out": blk(x), "out_dim": blk.out_dim}


def case_ple_block_depth(s):  # :624
    dsl = s.tb.dsl
    ple = s.sync(dsl.PLEBlock(lambda d: dsl.MLPBlock((16,), d), num_shared=2, num_task=1,
                              depth=3, in_dim=12, out_dim=16, outputs=["click", "like"]))
    assert len(list(ple.values)) == 3
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((4, 12)).astype(np.float32))
    return {"out": ple(x)}


def _planted_retrieval(s, n_users=50, rows=400, seed=0):  # :652
    p = s.pkg
    rng = np.random.default_rng(seed)
    users = rng.integers(0, n_users, size=rows).astype(np.int32)
    schema = p.Schema([
        p.create_categorical_column("user_id", n_users - 1, tags=(p.Tags.USER, p.Tags.USER_ID)),
        p.create_categorical_column("item_id", n_users - 1, tags=(p.Tags.ITEM, p.Tags.ITEM_ID)),
    ])
    return p.Dataset({"user_id": users, "item_id": users.copy()}, schema=schema), schema


def case_two_tower_learns_and_serves_topk(s):  # :672
    ds, schema = _planted_retrieval(s)
    model = s.sync(s.tb.TwoTowerModel(schema, dim=16, query_block=(32,), **s.dev))
    hist = model.fit(ds, epochs=3, batch_size=32, learning_rate=0.02, **s.dev)
    res = model.evaluate_retrieval(ds, k=10, **s.dev)
    rec = model.to_top_k_recommender(ds, k=5, **s.dev)
    scores, ids = rec({"user_id": np.asarray([3, 7], np.int32)})
    q = model.query_embeddings(ds, **s.dev)
    c = model.candidate_embeddings(ds.unique_by("item_id"), **s.dev)
    return {"loss": hist["loss"], "eval": res, "scores": scores, "ids": ids, "q": q, "c": c}


def case_two_tower_save_load(s, tmp):  # :700
    ds, schema = _planted_retrieval(s, rows=256)
    model = s.sync(s.tb.TwoTowerModel(schema, dim=8, **s.dev))
    model.fit(ds, epochs=1, batch_size=64, **s.dev)
    path = os.path.join(tmp, "port" if s.port else "jax")
    model.save(path)
    model2 = s.tb.TwoTowerModel(schema, dim=8, **s.dev).load_weights(path)
    b = s.tb.dsl.Batch.from_loader_batch({"user_id": np.asarray([1, 2, 3], np.int32)},
                                         **s.dev)
    with torch.no_grad():
        q2 = model2.blocks[0].branches["query"](b.features, batch=b)
    return {"q": q2}


def case_contrastive_false_negatives_and_logq(s):  # :722
    p = s.pkg
    col = p.create_categorical_column("item_id", 99, tags=(p.Tags.ITEM, p.Tags.ITEM_ID))
    head = s.tb.retrieval.ContrastiveOutput(col, negative_sampling="in-batch")
    head.train()
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    batch = s.tb.dsl.Batch(features={"item_id": torch.tensor([5, 5, 7, 9])})
    logits = head({"query": q, "candidate": c}, batch=batch)
    assert logits[0, 2].item() == pytest.approx(mt.core.constants.MIN_FLOAT)
    loss = head.compute_loss(logits, batch)
    head.eval()
    return {"logits": logits, "loss": loss, "eval": head({"query": q, "candidate": c})}


def case_log_uniform_sampler(s):  # :758
    sampler = s.tb.retrieval.LogUniformSampler(max_id=1000, n_sample=64, **s.gen(0))
    s.reseed(0)
    ids, expected = sampler.sample()
    return {"probs": sampler.probs, "ids": ids, "expected": expected}


def case_two_tower_popularity_sampling(s):  # :776
    ds, schema = _planted_retrieval(s, rows=256, seed=1)
    model = s.sync(s.tb.TwoTowerModel(schema, dim=8, negative_sampling=["in-batch", "popularity"],
                                      n_samples=16, **s.dev, **s.gen(3)))
    s.reseed(3)
    hist = model.fit(ds, epochs=2, batch_size=64, learning_rate=0.02, **s.dev)
    return {"loss": hist["loss"]}


def case_brute_force_index_rejects_duplicate_ids(s):  # :792
    idx = s.tb.retrieval.BruteForceIndex(k=2, **s.dev)
    with pytest.raises(ValueError, match="unique"):
        idx.index(np.asarray([1, 1, 2]), np.zeros((3, 4), np.float32))
    return {}


def _session_data(s, C=30, n=128, L=8, seed=0):  # :805
    p = s.pkg
    rng = np.random.default_rng(seed)
    starts = rng.integers(1, C, n)
    seqs = [((st + np.arange(rng.integers(4, L + 1))) % (C - 1) + 1).astype(np.int32)
            for st in starts]
    schema = p.Schema([p.create_categorical_column(
        "item_id_seq", C, tags=(p.Tags.ITEM, p.Tags.ITEM_ID, p.Tags.SEQUENCE),
        is_list=True, max_seq_length=L)])
    return s.dataset({"item_id_seq": seqs}, schema), schema


def case_session_transformer_predict_next(s):  # :826
    ds, schema = _session_data(s)
    m = s.sync(s.tb.SessionTransformerModel(schema, d_model=16, n_head=2, n_layer=1, **s.dev))
    pre = s.tb.TabularPredictNext(schema, "item_id_seq")
    h = m.fit(ds, epochs=2, batch_size=32, learning_rate=0.02, pre=pre, **s.dev)
    scores, ids = m.predict_next(ds, k=5, **s.dev)
    return {"loss": h["loss"], "emb": m.encode(ds, **s.dev), "scores": scores, "ids": ids}


def case_mlm_mask_embedding_receives_gradient(s):  # :846
    ds, schema = _session_data(s)
    m = s.sync(s.tb.SessionTransformerModel(schema, d_model=16, n_head=2, n_layer=1,
                                            causal=False, **s.dev))
    pre = s.tb.TabularMaskRandom(schema, "item_id_seq", 0.3, **s.gen(4))
    x, y = s.pkg.Loader(ds, batch_size=32, drop_last=True).peek()
    s.reseed(4)
    b = pre(s.tb.dsl.Batch.from_loader_batch(x, y, **s.dev))
    hidden = m.blocks[0](b.features, batch=b)
    loss = m.blocks[1].compute_loss(m.blocks[1](hidden, batch=b), b)
    loss.backward()
    g = m.blocks[0].mask_emb.grad
    assert float(g.abs().max()) > 0
    return {"mlm": b.sequences.masks["__mlm__item_id_seq"], "loss": loss, "grad": g}


def case_sequence_transform_shapes(s):  # :870
    ds, schema = _session_data(s, n=32)
    b = s.batch(ds, 16, targets=False)
    pn = s.tb.TabularPredictNext(schema, "item_id_seq")(b)
    pl = s.tb.TabularPredictLast(schema, "item_id_seq")(b)
    ml = s.tb.TabularMaskLast(schema, "item_id_seq")(b)
    return {"pn_mask": pn.sequences.masks["item_id_seq"], "pn_tgt": pn.targets["item_id_seq"],
            "pl_mask": pl.sequences.masks["item_id_seq"], "pl_tgt": pl.targets["item_id_seq"],
            "ml": ml.sequences.masks["__mlm__item_id_seq"]}


def case_encoder_encode_dataset(s):  # :978
    data = s.data("e-commerce", 128)
    item_schema = data.schema.select_by_tag(s.pkg.Tags.ITEM_ID)
    enc = s.sync(s.tb.dsl.EncoderBlock(s.tb.dsl.TabularInputBlock(item_schema, dim=8),
                                       schema=data.schema, **s.dev))
    out = enc.encode(data, selection=s.pkg.Tags.ITEM_ID, index=s.pkg.Tags.ITEM_ID,
                     unique=True, batch_size=32, **s.dev)
    out2 = enc.encode(data, selection=s.pkg.Tags.ITEM_ID, index=s.pkg.Tags.ITEM_ID,
                      unique=False, batch_size=32, **s.dev)
    return {"unique": dataset_cols(out), "all": dataset_cols(out2),
            "schema": out.schema.column_names}


def case_tracing_trace_and_schemas(s):  # :1018
    data = s.data("e-commerce", 32)
    dsl, tracing = s.tb.dsl, s.tb.tracing
    inputs = dsl.TabularInputBlock(data.schema, dim=8)
    model = s.sync(dsl.Block(inputs, dsl.MLPBlock((16,), inputs.out_dim)))
    batch = s.batch(data, 16, targets=False)
    out = tracing.trace(model, batch.features, batch=batch)
    return {"out": out, "in": tracing.input_schema(model).column_names,
            "mlp_out": tracing.output_schema(model.values[1]).column_names}


def _router(s, data):
    schema = data.schema.excluding_by_tag(s.pkg.Tags.TARGET)
    router = s.tb.compat.RouterBlock(schema)
    user_sel = schema.select_by_tag(s.pkg.Tags.USER)
    item_sel = schema.select_by_tag(s.pkg.Tags.ITEM)
    router.add_route(user_sel, s.tb.dsl.TabularInputBlock(user_sel, dim=8), name="user")
    router.add_route(item_sel, s.tb.dsl.TabularInputBlock(item_sel, dim=8), name="item")
    return s.sync(router), user_sel


def case_tracing_select_shares_weights(s):  # :1045
    data = s.data("e-commerce", 32)
    router, user_sel = _router(s, data)
    user_route = s.tb.tracing.select(router, s.pkg.Tags.USER)
    orig = {id(p) for p in router.parameters()}
    assert all(id(p) in orig for p in user_route.parameters())
    batch = s.batch(data, 8, targets=False)
    feats = {k: v for k, v in batch.features.items() if k in user_sel.column_names}
    with pytest.raises(ValueError):
        s.tb.tracing.select(router, "definitely_not_a_column")
    return {"out": user_route(feats, batch=batch)}


def case_tracing_extract_splits_route(s):  # :1084
    data = s.data("e-commerce", 16)
    router, _ = _router(s, data)
    remainder, route = s.tb.tracing.extract(router, s.pkg.Tags.USER)
    return {"route": sorted(route.branches) == ["user"],
            "remainder": sorted(remainder.branches) == ["item"]}


def case_tracing_select_schema_forms(s):  # :1103
    p, tracing = s.pkg, s.tb.tracing
    schema = p.Schema([
        p.ColumnSchema("user_id", tags=(p.Tags.USER_ID.value, p.Tags.CATEGORICAL.value)),
        p.ColumnSchema("item_id", tags=(p.Tags.ITEM_ID.value, p.Tags.CATEGORICAL.value)),
        p.ColumnSchema("price", tags=(p.Tags.CONTINUOUS.value,)),
    ])
    union = tracing.select_union(p.Tags.USER_ID, p.Tags.ITEM_ID)
    return {"tag": "/".join(tracing.select_schema(schema, p.Tags.USER_ID).column_names),
            "list": "/".join(tracing.select_schema(schema, [p.Tags.USER_ID, "price"]).column_names),
            "union": "/".join(tracing.select_schema(schema, union).column_names),
            "name": tracing.selection_name(schema["price"])}


def case_encoder_predict_dataset(s):  # :1125
    data = s.data("music-streaming", 64)
    schema = data.schema
    model = s.sync(s.tb.dsl.MLPModel(schema, units=(16, 8), **s.dev))
    enc = s.tb.dsl.EncoderBlock(*list(model.blocks), schema=schema, **s.dev)
    out = enc.predict(data, batch_size=32, **s.dev)
    pred = s.tb.compat.DaskPredictor(model, selection=None)
    ds2 = pred(data, batch_size=32, index=schema.select_by_tag(s.pkg.Tags.ITEM_ID))
    return {"out": dataset_cols(out), "ds2": dataset_cols(ds2)}


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}
NEEDS_TMP = {"save_load", "dsl_dcn_multitask_and_save_load", "two_tower_save_load"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_side_backend_matches_jax(case, tmp_path):
    store = {}
    args = (str(tmp_path),) if case in NEEDS_TMP else ()
    want = CASES[case](Side(False, store), *args)
    got = CASES[case](Side(True, store), *args)
    compare(got, want)


def test_the_model_protocol_and_the_state_loader():
    data = mt.generate_data("e-commerce", num_rows=32)
    model = ptb.TorchMLPModel(data.schema, dims=(8,), device="cpu")
    assert isinstance(model, mt.MerlinModel)
    with pytest.raises(KeyError, match="state names differ"):
        load_torch_backend_params(model, {"nope": np.zeros(1)})


# ---------------------------------------------------------------------------
# the index through ops/topk.py::topk_scores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C", [1000, 9000])
def test_index_routes_equal_torch_topk(C):
    """The port's index takes ``topk_scores``: direct for C <= 4096, binned
    (phase B in K5's plain version here) above; the JAX copy takes
    ``torch.topk`` of the full product. Scores are tie-free: distinct random
    rows."""
    rng = np.random.default_rng(C)
    D, B, k = 16, 32, 10
    cand = rng.standard_normal((C, D)).astype(np.float32)
    ids = rng.permutation(C * 3)[:C].astype(np.int64)
    q = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
    route = ttopk.topk_route(B, C, D, k)
    assert route == ("direct" if C <= 4096 else "binned")
    jidx = jtb.retrieval.BruteForceIndex(k).index(ids, cand)
    tidx = ptb.retrieval.BruteForceIndex(k, device="cpu").index(ids, cand)
    js, ji = jidx(q)
    ts, ti = tidx(q)
    full = (q @ torch.from_numpy(cand).T).numpy()
    top = -np.sort(-full, axis=1)[:, : k + 1]
    assert (np.diff(top, axis=1) < 0).all()  # tie-free through the k-th place
    np.testing.assert_array_equal(ti.numpy(), ji.numpy())
    assert ti.dtype == torch.int64
    np.testing.assert_allclose(ts.numpy(), js.numpy(), rtol=RTOL, atol=1e-6)


# ---------------------------------------------------------------------------
# no card: the entry points refuse unless asked for the CPU
# ---------------------------------------------------------------------------

@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_entry_points_refuse_without_a_card():
    data = mt.generate_data("e-commerce", num_rows=32)
    ds, schema = _planted_retrieval(Side(True, {}), rows=64)
    built = ptb.TwoTowerModel(schema, dim=4, device="cpu")
    sess = mt.generate_data("sequence-testing", num_rows=8).schema
    calls = {
        "TwoTowerModel": lambda: ptb.TwoTowerModel(schema, dim=4),
        "DLRMModel": lambda: ptb.DLRMModel(data.schema),
        "TorchMLPModel": lambda: ptb.TorchMLPModel(data.schema),
        "SessionTransformerModel": lambda: ptb.SessionTransformerModel(sess),
        "BruteForceIndex": lambda: ptb.retrieval.BruteForceIndex(2),
        "fit": lambda: built.fit(ds, batch_size=32),
        "evaluate_retrieval": lambda: built.evaluate_retrieval(ds),
        "to_top_k_recommender": lambda: built.to_top_k_recommender(ds),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
