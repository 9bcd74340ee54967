"""The rest of the engine's persistence surface on the CPU, and the bodies of
``examples/08_serving_export.py`` and ``13_training_continuation.py`` on
both packages at a small size.

- ``batch_predict``: the dataset with prediction columns, equal to the JAX
  package's (the DLRM's two heads, parameters carried over) within rtol
  1e-5, atol 1e-6.
- ``Encoder(*blocks, schema=)`` encodes and refuses ``fit``;
  ``TopKEncoder(topk_layer=)`` takes ``"brute-force-topk"`` or a
  ``BruteForce`` and refuses anything else; ``Timing``; ``WandbLogger``
  does nothing without ``wandb``; ``ProfilerCallback`` writes a trace.
- examples/08: the DLRM and the matrix factorization trained by both
  packages from the same parameters (losses within rtol 1e-4, the
  tolerance of ``tests/test_torch_examples_dsl.py``: fp32 sums in another
  order over the steps), exported and served: probabilities within rtol
  1e-4 of JAX's served ones and bit-equal to the port's ``predict``; the
  bf16 index's top 10 overlapping JAX's in at least 90% of the ids; the
  int8 index's overlapping the bf16 one's in at least 80% (the example's
  own check).
- examples/13 (``get_movielens`` is not ported: both packages synthesize
  ``movielens-100k``): adam under a warmup-cosine schedule with bf16 slots,
  ``ModelCheckpoint``, a warm continuation with ``initial_epoch``,
  ``validation_freq`` and ``validation_steps``, and the preemption drill
  through ``restore_training``: every phase's losses within rtol 1e-4 of
  JAX's, the same history keys, and the resumed steps' count.
"""

import json
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

import models_tpu as mm
import models_tpu.losses as jlosses
from models_tpu.core.types import to_device_batch as jax_batch
from models_tpu.utils.checkpoint import CheckpointManager as JManager
from models_tpu.utils.checkpoint import ModelCheckpoint as JCheckpoint

import models_tpu_torch as mt
from models_tpu_torch.utils.checkpoint import CheckpointManager, ModelCheckpoint

CPU = dict(device="cpu")


def jax_params(model):
    return {"/".join(str(p) for p in path): np.asarray(v[...])
            for path, v in nnx.state(model, nnx.Variable).flat_state()
            if "sparse_slots" not in path}


def _bce_softplus(labels, logits, sample_weight=None):
    labels = labels.reshape(logits.shape).astype(logits.dtype)
    return jlosses._weighted_mean(jax.nn.softplus(logits) - logits * labels, sample_weight)


@pytest.fixture
def jax_bce(monkeypatch):
    """The JAX binary heads trained with ``softplus(x) - x y`` (the gradient
    at a zero logit: ``tests/test_torch_ranking_models.py``)."""
    monkeypatch.setitem(jlosses.loss_registry._store, "binary_crossentropy", _bce_softplus)


def dlrm_pair(rows=256, seed=8):
    jds = mm.generate_data("e-commerce", num_rows=rows, seed=seed)
    tds = mt.generate_data("e-commerce", num_rows=rows, seed=seed)
    jm = mm.DLRMModel(jds.schema, embedding_dim=16, bottom_block=(32, 16), top_block=(32,))
    tm = mt.DLRMModel(tds.schema, embedding_dim=16, bottom_block=(32, 16), top_block=(32,), **CPU)
    jm.build(mm.Loader(jds, 64))
    mt.load_jax_params(tm, jax_params(jm))
    return jm, tm, jds, tds


def test_batch_predict_appends_the_jax_packages_columns():
    jm, tm, jds, tds = dlrm_pair(rows=100)
    jm.compile()
    got = tm.batch_predict(tds, batch_size=32, **CPU)
    want = jm.batch_predict(jds, batch_size=32)
    gcols, wcols = got.to_numpy_dict(), want.to_numpy_dict()
    new = sorted(c for c in gcols if c.startswith("prediction"))
    assert new == sorted(c for c in wcols if c.startswith("prediction")) and len(new) == 2
    for col in new:
        np.testing.assert_allclose(gcols[col], np.asarray(wcols[col]), rtol=1e-5, atol=1e-6,
                                   err_msg=col)
    assert got.num_rows == 100 and got.schema == tds.schema
    assert np.array_equal(gcols["item_id"], tds.to_numpy_dict()["item_id"])


def test_encoder_takes_a_schema_and_refuses_to_fit():
    ds = mt.generate_data("e-commerce", num_rows=40, seed=1)
    users = ds.schema.select_by_tag(mt.Tags.USER)
    inputs = mt.InputBlockV2(users, dim=4, **CPU)
    enc = mt.Encoder(inputs, mt.MLPBlock([4], in_features=inputs.out_features, **CPU),
                     schema=users)
    assert enc.schema == users
    out = enc.encode(ds, batch_size=16, **CPU)
    assert out.to_numpy_dict()["embedding"].shape == (40, 4)
    assert np.array_equal(enc.batch_predict(ds, batch_size=16, **CPU).to_numpy_dict()[
        "embedding"], out.to_numpy_dict()["embedding"])
    with pytest.raises(RuntimeError, match="inference-only"):
        enc.fit(ds)


def test_top_k_encoder_takes_a_named_or_given_top_k_layer():
    ds = mt.generate_data("e-commerce", num_rows=40, seed=1)
    model = mt.TwoTowerModel(ds.schema, query_tower=(8, 4), **CPU)
    cand = model.candidate_embeddings(ds, **CPU)
    a = mt.TopKEncoder(model.query_encoder, cand, k=3, topk_layer="brute-force-topk", **CPU)
    b = mt.TopKEncoder(model.query_encoder, cand, k=3, topk_layer=mt.BruteForce(3), **CPU)
    pa, pb = a.predict(ds, batch_size=16, **CPU), b.predict(ds, batch_size=16, **CPU)
    assert np.array_equal(pa["ids"], pb["ids"]) and np.array_equal(pa["scores"], pb["scores"])
    with pytest.raises(KeyError):
        mt.TopKEncoder(model.query_encoder, cand, k=3, topk_layer="approximate-topk", **CPU)
    with pytest.raises(ValueError, match="BruteForce"):
        mt.TopKEncoder(model.query_encoder, cand, k=3, topk_layer=mt.NoOp(), **CPU)


def test_timing_wandb_and_the_profiler_callback(tmp_path, monkeypatch):
    lines = []
    with mt.Timing("block", log_fn=lines.append) as t:
        sum(range(1000))
    assert t["seconds"] > 0 and lines[0].startswith("block: ")
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises
    logger = mt.WandbLogger(project="p")
    prof = mt.ProfilerCallback(str(tmp_path / "trace"), start_step=2, num_steps=2)
    ds = mt.generate_data("e-commerce", num_rows=256, seed=1)
    model = mt.DLRMModel(ds.schema, embedding_dim=8, top_block=(8,), **CPU)
    model.compile(optimizer="adagrad", learning_rate=0.05, metrics=[])
    model.fit(ds, batch_size=32, callbacks=[logger, prof], **CPU)
    assert logger._wandb is None and logger._run is None
    logger.finish()
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


# ---------------------------------------------------------------------------
# examples/08 and examples/13 on both packages
# ---------------------------------------------------------------------------


def first_batch(pkg, ds, batch):
    loader = (mm.Loader(ds, batch, shuffle=False, drop_last=True) if pkg is mm
              else mt.Loader(ds, batch))
    x, _ = loader.peek() if pkg is mm else next(iter(loader))
    return {k: v for k, v in x.items() if k != "__row_valid__"}


def test_example_08_serving_export(tmp_path, jax_bce):
    # the ranking model
    jm, tm, jds, tds = dlrm_pair()
    for m in (jm, tm):
        m.compile(optimizer="adagrad", learning_rate=0.05)
    jh = jm.fit(jds, epochs=1, batch_size=64, shuffle=False, verbose=0).history
    th = tm.fit(tds, epochs=1, batch_size=64, shuffle=False, **CPU).history
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)
    jm.export_serving(str(tmp_path / "jax"), data=jds, batch_size=64)
    tm.export_serving(str(tmp_path / "port"), data=tds, batch_size=64, **CPU)
    jout = mm.load_serving(str(tmp_path / "jax"))(jax_batch(first_batch(mm, jds, 64)))
    tout = mt.load_serving(str(tmp_path / "port"), **CPU)(first_batch(mt, tds, 64))
    want = tm.predict(tds.take(64), batch_size=64, **CPU)
    for head in want:
        assert np.array_equal(tout[head].numpy(), want[head]), head
        np.testing.assert_allclose(tout[head].numpy(), np.asarray(jout[head]), rtol=1e-4,
                                   atol=1e-6, err_msg=head)

    # retrieval: the full top-k index and the query tower, bf16 and int8
    jr = mm.generate_data("movielens-100k", num_rows=512, seed=2)
    tr = mt.generate_data("movielens-100k", num_rows=512, seed=2)
    jmf = mm.MatrixFactorizationModel(jr.schema, dim=16)
    tmf = mt.MatrixFactorizationModel(tr.schema, dim=16, **CPU)
    jmf.build(mm.Loader(jr, 64))
    mt.load_jax_params(tmf, jax_params(jmf))
    jmf.compile(learning_rate=0.05)
    tmf.compile(learning_rate=0.05)
    jh = jmf.fit(jr, epochs=1, batch_size=64, shuffle=False, verbose=0).history
    th = tmf.fit(tr, epochs=1, batch_size=64, shuffle=False, **CPU).history
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)
    jtop = jmf.to_top_k_encoder(k=10, candidate_dtype=jnp.bfloat16)
    jtop.compile()
    jtop.export_serving(str(tmp_path / "jax_topk"), data=jr, batch_size=64)
    ttop = tmf.to_top_k_encoder(k=10, candidate_dtype=torch.bfloat16, **CPU)
    ttop.export_serving(str(tmp_path / "port_topk"), data=tr, batch_size=64, **CPU)
    jrec = mm.load_serving(str(tmp_path / "jax_topk"))(jax_batch(first_batch(mm, jr, 64)))
    qx = first_batch(mt, tr, 64)
    rec = mt.load_serving(str(tmp_path / "port_topk"), **CPU)(qx)
    overlap = np.mean([len(set(a) & set(b)) / 10 for a, b in
                       zip(rec["ids"].numpy(), np.asarray(jrec["ids"]))])
    assert overlap >= 0.9, overlap
    top8 = tmf.to_top_k_encoder(k=10, candidate_dtype=torch.int8, **CPU)
    rec8 = top8.predict(tr.take(64), batch_size=64, **CPU)
    overlap8 = np.mean([len(set(a) & set(b)) / 10 for a, b in
                        zip(rec["ids"].numpy(), rec8["ids"])])
    assert overlap8 >= 0.8, overlap8


def torch_warmup_cosine(init, peak, warmup, decay):
    def schedule(step):
        s = step.to(torch.float32)
        warm = (init - peak) * (1 - torch.clamp(s, 0, warmup) / warmup) + peak
        c = torch.clamp(s - warmup, 0, decay - warmup)
        return torch.where(s < warmup, warm,
                           peak * 0.5 * (1 + torch.cos(math.pi * c / (decay - warmup))))

    return schedule


def test_example_13_training_continuation(tmp_path):
    jtrain, jvalid = mm.generate_data("movielens-100k", num_rows=1536, seed=5,
                                      set_sizes=(0.75, 0.25))
    ttrain, tvalid = mt.generate_data("movielens-100k", num_rows=1536, seed=5).split(
        [0.75, 0.25], seed=5)

    # both packages start from the same parameters
    jm0 = mm.TwoTowerModel(jtrain.schema, query_tower=(16, 8), embedding_dim=8)
    jm0.build(mm.Loader(jtrain, 64))
    init = jax_params(jm0)

    jsched = optax.warmup_cosine_decay_schedule(0.0, 1e-3, warmup_steps=2, decay_steps=40)
    tsched = torch_warmup_cosine(0.0, 1e-3, 2, 40)

    def jmake():
        m = mm.TwoTowerModel(jtrain.schema, query_tower=(16, 8), embedding_dim=8)
        m.compile(optimizer="adam", learning_rate=jsched, optimizer_state_dtype="bfloat16",
                  metrics=[])
        m.build(mm.Loader(jtrain, 64))
        nnx.update(m, nnx.state(jm0, nnx.Param))
        return m

    def tmake():
        m = mt.TwoTowerModel(ttrain.schema, query_tower=(16, 8), embedding_dim=8, **CPU)
        m.compile(optimizer="adam", learning_rate=tsched, optimizer_state_dtype="bfloat16",
                  metrics=[])
        mt.load_jax_params(m, init)
        return m

    hist = {}
    for tag, make, train, valid, ckpt, manager, kw in (
            ("jax", jmake, jtrain, jvalid, JCheckpoint, JManager, {"verbose": 0}),
            ("port", tmake, ttrain, tvalid, ModelCheckpoint, CheckpointManager, CPU)):
        cdir = str(tmp_path / tag)
        model = make()
        cb = ckpt(cdir, every_n_epochs=1)
        h1 = model.fit(train, epochs=2, batch_size=256, shuffle=False, callbacks=[cb], **kw)
        h2 = model.fit(train, epochs=4, initial_epoch=2, batch_size=256, shuffle=False,
                       validation_data=valid, validation_freq=2, validation_steps=1,
                       callbacks=[cb], **kw)
        resumed = make()
        last = (manager(cdir).restore_training(resumed, data=train) if tag == "jax" else
                manager(cdir).restore_training(resumed, data=train, **CPU))
        h3 = resumed.fit(train, epochs=last + 3, initial_epoch=last + 1, batch_size=256,
                         shuffle=False, **kw)
        hist[tag] = (last, h1.history, h2.history, h3.history)
    jl, jh1, jh2, jh3 = hist["jax"]
    tl, th1, th2, th3 = hist["port"]
    assert tl == jl == 3
    for want, got in ((jh1, th1), (jh2, th2), (jh3, th3)):
        assert sorted(got) == sorted(want)
        assert {k: len(v) for k, v in got.items()} == {k: len(v) for k, v in want.items()}
        for key in ("loss", "val_loss"):
            if key in want:
                np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
