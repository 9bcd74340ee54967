"""The port's spans and counters (``models_tpu_torch/utils/trace.py``): off
unless a profiler records or ``enable()`` was called; under either, ``fit``
and ``evaluate`` record their tree (root, prepare, chunks, finish, fetch)
with parent and root ids and self times; under a profiler the spans are its
events, named under the package's prefix. The ``card`` test holds the graph
route's spans to its chunks."""

import json

import pytest
import torch

import models_tpu_torch as mt
from models_tpu_torch.models import base as B
from models_tpu_torch.utils import trace

P = trace.PREFIX
BATCH = 32
KW = dict(query_tower=(16, 8), embedding_dim=8)


@pytest.fixture(autouse=True)
def fresh_recorder():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def chunked(n_batches: int, spe: int = 2, device: str = "cpu", seed: int = 4):
    ds = mt.generate_data("movielens-25m", num_rows=n_batches * BATCH, seed=seed)
    model = mt.TwoTowerModel(ds.schema, device=device, seed=3, **KW)
    model.compile(optimizer="adagrad", learning_rate=0.05, steps_per_execution=spe, metrics=[])
    return ds, model


def fit(model, ds, epochs: int = 1, **kw):
    return model.fit(ds, epochs=epochs, batch_size=BATCH, shuffle=True, verbose=0,
                     device=model_device(model), **kw)


def model_device(model) -> str:
    return next(model.parameters()).device.type


def by_name(spans, name):
    return [s for s in spans if s["name"] == P + name]


def test_off_by_default_records_nothing():
    assert trace.span("fit.chunk") is trace.span("anything") is trace._NO_SPAN
    ds, model = chunked(4)
    fit(model, ds)
    got = trace.snapshot()
    assert got["spans"] == []
    assert got["counters"]["fetches"] == 1  # counters are always on


def test_fit_and_evaluate_record_the_tree(monkeypatch):
    monkeypatch.setattr(B, "EVAL_CHUNK_BATCHES", 2)
    ds, model = chunked(6)
    trace.enable()
    fit(model, ds)
    model.evaluate(ds, batch_size=BATCH, device="cpu")
    spans = trace.snapshot()["spans"]
    assert all(s["name"].startswith(P) for s in spans)
    ids = {s["id"]: s for s in spans}

    (root,) = by_name(spans, "fit")
    assert root["parent"] is None and root["root"] == root["id"]
    under_fit = [s for s in spans if s["root"] == root["id"]]
    assert {s["name"] for s in under_fit} == {
        P + n for n in ("fit", "fit.prepare", "pack.upload", "fit.chunk", "fit.finish", "fetch")}
    for name in ("fit.prepare", "fit.chunk", "fit.finish"):
        assert all(s["parent"] == root["id"] for s in by_name(under_fit, name)), name
    assert len(by_name(under_fit, "fit.chunk")) == 3  # 6 batches, 2 a chunk
    (upload,) = by_name(under_fit, "pack.upload")
    assert ids[upload["parent"]]["name"] == P + "fit.prepare"
    (fetch,) = by_name(under_fit, "fetch")
    assert ids[fetch["parent"]]["name"] == P + "fit.finish"
    assert root["counters"]["fetches"] == 1 and root["counters"]["h2d.bytes"] > 0

    (ev,) = by_name(spans, "evaluate")
    assert ev["parent"] is None and ev["root"] == ev["id"] != root["id"]
    under_ev = [s for s in spans if s["root"] == ev["id"]]
    assert len(by_name(under_ev, "evaluate.chunk")) == 3  # 6 batches, 2 a chunk
    for name in ("evaluate.prepare", "evaluate.chunk", "evaluate.finish"):
        assert all(s["parent"] == ev["id"] for s in by_name(under_ev, name)), name
    (upload,) = by_name(under_ev, "pack.upload")
    assert ids[upload["parent"]]["name"] == P + "evaluate.prepare"
    (fetch,) = by_name(under_ev, "fetch")
    assert ids[fetch["parent"]]["name"] == P + "evaluate.finish"

    for s in spans:
        children = [c for c in spans if c["parent"] == s["id"]]
        duration = s["end_ns"] - s["start_ns"]
        assert s["self_ns"] == duration - sum(c["end_ns"] - c["start_ns"] for c in children)
        assert 0 <= s["self_ns"] <= duration
        for c in children:
            assert s["start_ns"] <= c["start_ns"] <= c["end_ns"] <= s["end_ns"]


def test_spans_are_profiler_events_under_the_prefix():
    ds, model = chunked(4)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fit(model, ds)
        model.evaluate(ds, batch_size=BATCH, device="cpu")
    assert not trace.RECORDER.enabled
    names = {e.name for e in prof.events()}
    ours = {n for n in names if n.startswith(P)}
    assert {P + "fit", P + "fit.chunk", P + "fit.finish", P + "fetch", P + "evaluate",
            P + "evaluate.chunk"} <= ours
    assert not {"fit", "evaluate"} & names
    recorded = {s["name"] for s in trace.snapshot()["spans"]}
    assert recorded == ours


def test_h2d_bytes_count_the_permutation():
    ds, model = chunked(4)
    fit(model, ds)  # packs the rows once
    before = trace.snapshot()["counters"]["h2d.bytes"]
    fit(model, ds, epochs=3)
    rows = 4 * BATCH
    assert trace.snapshot()["counters"]["h2d.bytes"] - before == rows * 4 * 3


def test_profiler_callback_trace_holds_chunk_spans(tmp_path):
    ds, model = chunked(8)
    cb = mt.ProfilerCallback(log_dir=str(tmp_path), start_step=2, num_steps=2)
    fit(model, ds, callbacks=[cb])
    with open(cb.trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert P + "fit.chunk" in names


@pytest.mark.card
def test_graph_replays_follow_the_chunks():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ds, model = chunked(8, spe=2, device="cuda")
    trace.enable()
    for _ in range(2):
        fit(model, ds)
    snap = trace.snapshot()
    spans = snap["spans"]
    first, second = sorted(by_name(spans, "fit"), key=lambda s: s["start_ns"])
    for root, eager, captures, replays in ((first, 1, 1, 3), (second, 0, 0, 4)):
        mine = [s for s in spans if s["root"] == root["id"]]
        assert len(by_name(mine, "fit.chunk")) == 4
        assert len(by_name(mine, "graph.eager")) == eager
        assert len(by_name(mine, "graph.capture")) == captures
        assert len(by_name(mine, "graph.replay")) == replays
        assert root["counters"].get("graph.replays", 0) == replays
        assert "graph.drops" not in root["counters"]
    chunks = {s["id"] for s in by_name(spans, "fit.chunk")}
    assert all(s["parent"] in chunks for s in by_name(spans, "graph.replay"))
