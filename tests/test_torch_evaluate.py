"""The port's evaluation (Model.evaluate, fit with metrics and validation,
RetrievalModelV2.evaluate(item_corpus=...)) against the JAX package's, on
the CPU.

Both packages draw the same rows from one seed; the JAX model's parameters
are carried over with ``load_jax_params``. Losses and the five top-k metrics
agree within rtol 1e-5 (fp32 sums in another order). The metrics sort the
scores with ties shuffled, in another random order in each package; the
scores here have no ties among a row's top 10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from models_tpu.data import Loader as JLoader
from models_tpu.data import generate_data as jax_generate
from models_tpu.models import TwoTowerModel as JTwoTowerModel

import models_tpu_torch as mt
from models_tpu_torch.metrics.topk import RecallAt, TopKMetricsAggregator

RTOL = 1e-5
METRICS = ["map_at_10", "mrr_at_10", "ndcg_at_10", "precision_at_10", "recall_at_10"]
KW = dict(query_tower=(16, 8), embedding_dim=8)


def jax_flat_params(model):
    return {
        "/".join(str(p) for p in path): np.asarray(var[...])
        for path, var in nnx.state(model, nnx.Param).flat_state()
    }


def build_pair(seed=21, num_rows=300):
    jds = jax_generate("movielens-25m", num_rows=num_rows, seed=seed)
    tds = mt.generate_data("movielens-25m", num_rows=num_rows, seed=seed)
    jm = JTwoTowerModel(jds.schema, **KW)
    jm.compile()
    jm.build(JLoader(jds, 64))
    tm = mt.TwoTowerModel(tds.schema, device="cpu", **KW)
    mt.load_jax_params(tm, jax_flat_params(jm))
    return jds, tds, jm, tm


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def assert_logs_close(got, want, keys=None):
    keys = sorted(want) if keys is None else keys
    for key in keys:
        if key.endswith("examples_per_sec"):
            continue
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=1e-7, err_msg=key)


def test_in_batch_evaluate_matches_jax(pair):
    jds, tds, jm, tm = pair
    jres = jm.evaluate(jds, batch_size=64)
    tres = tm.evaluate(tds, batch_size=64, device="cpu")
    assert list(tres) == list(jres) == ["loss"] + METRICS
    assert_logs_close(tres, jres)
    assert 0.0 < tres["recall_at_10"] < 1.0


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_corpus_evaluate_matches_jax(pair, dtype):
    """fp32: ``evaluate(item_corpus=...)``; bf16 and int8: the top-k encoder
    it builds, with that index dtype, evaluated (the JAX method takes no
    dtype)."""
    jds, tds, jm, tm = pair
    if dtype == "fp32":
        jres = jm.evaluate(jds, batch_size=64, item_corpus=jds, k=10)
        tres = tm.evaluate(tds, batch_size=64, item_corpus=tds, k=10, device="cpu")
    else:
        jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16), "int8": (jnp.int8, torch.int8)}[dtype]
        jres = jm.to_top_k_encoder(jds, k=10, candidate_dtype=jdt).evaluate(jds, batch_size=64)
        tenc = tm.to_top_k_encoder(tds, k=10, candidate_dtype=tdt, device="cpu")
        assert tenc.blocks[-1].topk_layer.candidates.dtype == tdt
        tres = tenc.evaluate(tds, batch_size=64, device="cpu")
    assert list(tres) == list(jres) == ["loss"] + METRICS
    assert tres["loss"] == jres["loss"] == 0.0
    assert_logs_close(tres, jres)


def test_fit_with_default_metrics_matches_jax(monkeypatch):
    """compile() with metrics=None takes the head's top-k metrics; with
    train_metrics_steps=2 every other step feeds them (its forward returns
    the logits), and the others take the fused loss."""
    from models_tpu_torch.outputs import contrastive

    fused = []
    orig = contrastive.sampled_softmax_loss
    monkeypatch.setattr(contrastive, "sampled_softmax_loss",
                        lambda *a, **kw: fused.append(1) or orig(*a, **kw))
    jds, tds, jm, tm = build_pair(seed=22)
    jm.compile(optimizer="adagrad", learning_rate=0.05, train_metrics_steps=2)
    tm.compile(optimizer="adagrad", learning_rate=0.05, train_metrics_steps=2)
    jh = jm.fit(jds, epochs=2, batch_size=64, shuffle=False, verbose=0)
    th = tm.fit(tds, epochs=2, batch_size=64, shuffle=False, device="cpu")
    assert len(fused) == 4  # of 8 steps
    assert sorted(th.history) == sorted(jh.history)
    assert set(METRICS) <= set(th.history)
    assert_logs_close(th.history, jh.history)


def test_fit_validation_data_adds_val_keys_as_jax():
    jds, tds, jm, tm = build_pair(seed=23)
    jm.compile(optimizer="adagrad", learning_rate=0.05)
    tm.compile(optimizer="adagrad", learning_rate=0.05)
    jh = jm.fit(jds, epochs=2, batch_size=64, shuffle=False, validation_data=jds,
                validation_freq=2, verbose=0)
    th = tm.fit(tds, epochs=2, batch_size=64, shuffle=False, validation_data=tds,
                validation_freq=2, device="cpu")
    val = sorted(k for k in th.history if k.startswith("val_"))
    assert val == sorted(k for k in jh.history if k.startswith("val_")) == sorted(
        ["val_loss"] + [f"val_{m}" for m in METRICS])
    assert len(th.history["val_loss"]) == 1 and len(th.history["loss"]) == 2
    assert_logs_close(th.history, jh.history)


def test_compile_resolves_metric_specs():
    ds = mt.generate_data("e-commerce", num_rows=64, seed=1)
    model = mt.TwoTowerModel(ds.schema, query_tower=(8, 4), device="cpu")
    head = model.contrastive_output.block_name
    model.compile(metrics=["recall_at", TopKMetricsAggregator.default(5)])
    ms = model._resolve_task_metrics()[head]
    assert isinstance(ms[0], RecallAt) and ms[0].k == 10 and ms[1].max_k == 5
    model.compile(metrics={head: "ndcg_at"})
    assert [m.name for m in model._resolve_task_metrics()[head]] == ["ndcg_at_10"]
    model.compile(metrics=[])
    assert model._resolve_task_metrics() == {head: []}
