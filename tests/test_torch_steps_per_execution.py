"""The port's k steps a chunk (``compile(steps_per_execution=, jit=)``, the
device-resident route of ``Model.fit``) against the JAX package's, on the CPU.

Both packages draw the same rows from one seed; the JAX model's parameters
are carried over with ``load_jax_params``. On the CPU a chunk runs eagerly
(no CUDA graph) and its gather is K9's plain version. Losses agree within
rtol 1e-5 (fp32 sums in another order; the packed batches carry no
``__row_valid__``, so the loss is a plain mean where the streaming route
takes a weighted one), the top-k metrics within rtol 1e-5, atol 1e-7
(tests/test_torch_evaluate.py's tolerance; the scores have no ties among a
row's top 10). The port's routes against each other: equal bit for bit where
they run the same arithmetic.
"""

import numpy as np
import pytest
import torch
from flax import nnx

from models_tpu.data import Loader as JLoader
from models_tpu.data import generate_data as jax_generate
from models_tpu.models import TwoTowerModel as JTwoTowerModel

import models_tpu_torch as mt
from models_tpu_torch.core.types import SequenceFeature
from models_tpu_torch.data import Loader
from models_tpu_torch.models import base as B
from models_tpu_torch.models.base import Model

RTOL = 1e-5
KW = dict(query_tower=(16, 8), embedding_dim=8)
METRICS = ["map_at_10", "mrr_at_10", "ndcg_at_10", "precision_at_10", "recall_at_10"]


def jax_flat_params(model):
    return {
        "/".join(str(p) for p in path): np.asarray(var[...])
        for path, var in nnx.state(model, nnx.Param).flat_state()
    }


def build_pair(seed, num_rows):
    jds = jax_generate("movielens-25m", num_rows=num_rows, seed=seed)
    tds = mt.generate_data("movielens-25m", num_rows=num_rows, seed=seed)
    jm = JTwoTowerModel(jds.schema, **KW)
    jm.compile()
    jm.build(JLoader(jds, 32))
    tm = mt.TwoTowerModel(tds.schema, device="cpu", **KW)
    mt.load_jax_params(tm, jax_flat_params(jm))
    return jds, tds, jm, tm


def port_model(ds, seed=3):
    return mt.TwoTowerModel(ds.schema, device="cpu", seed=seed, **KW)


def params(model):
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def test_device_route_matches_jax_shuffled():
    """spe = 3, shuffled, 2 epochs: the JAX package runs its fused epochs,
    the port its chunks (3 + 2 of 5 batches an epoch) on the same
    permutations; the losses agree, as tests/unit/test_parallel.py holds
    JAX's device route to its streaming one."""
    jds, tds, jm, tm = build_pair(seed=5, num_rows=160)
    jm.compile(optimizer="adam", learning_rate=0.05, steps_per_execution=3, metrics=[])
    tm.compile(optimizer="adam", learning_rate=0.05, steps_per_execution=3, metrics=[])
    jh = jm.fit(jds, epochs=2, batch_size=32, shuffle=True, verbose=0)
    th = tm.fit(tds, epochs=2, batch_size=32, shuffle=True, device="cpu")
    assert tm._step == 10 and getattr(tds, "_device_train_pack", None) is not None
    for key in ("loss", f"loss/{tm.item_id_name}/ContrastiveOutput"):
        np.testing.assert_allclose(th.history[key], jh.history[key], rtol=RTOL, err_msg=key)
    assert th.history["loss"][1] < th.history["loss"][0]


def test_leftover_chunk_matches_single_steps():
    """7 batches at spe = 4: a chunk of 4, then one of 3, against one step at a
    time (the streaming route) and against the JAX package at spe = 4."""
    jds, tds, jm, _ = build_pair(seed=6, num_rows=7 * 32)
    runs = {}
    for spe in (1, 4):
        tm = port_model(tds)
        mt.load_jax_params(tm, jax_flat_params(jm))
        tm.compile(optimizer="adagrad", learning_rate=0.05, steps_per_execution=spe, metrics=[])
        runs[spe] = (tm.fit(tds, epochs=2, batch_size=32, shuffle=False, device="cpu"), tm)
    jm.compile(optimizer="adagrad", learning_rate=0.05, steps_per_execution=4, metrics=[])
    jh = jm.fit(jds, epochs=2, batch_size=32, shuffle=False, verbose=0)
    (h1, m1), (h4, m4) = runs[1], runs[4]
    assert m1._step == m4._step == 14
    np.testing.assert_allclose(h4.history["loss"], h1.history["loss"], rtol=RTOL)
    np.testing.assert_allclose(h4.history["loss"], jh.history["loss"], rtol=RTOL)
    p1, p4 = params(m1), params(m4)
    for name in p1:
        torch.testing.assert_close(p4[name], p1[name], rtol=1e-4, atol=1e-6, msg=name)


def test_metric_chunks_feed_every_step_as_jax():
    """train_metrics_steps = 2 at spe = 3: a chunk that holds a metric step
    feeds the metrics at each of its steps (JAX's ``hits_metrics``), so the
    epoch metrics are the JAX package's and not the streaming route's."""
    jds, tds, jm, tm = build_pair(seed=22, num_rows=300)
    jm.compile(optimizer="adagrad", learning_rate=0.05, train_metrics_steps=2,
               steps_per_execution=3)
    tm.compile(optimizer="adagrad", learning_rate=0.05, train_metrics_steps=2,
               steps_per_execution=3)
    jh = jm.fit(jds, epochs=2, batch_size=32, shuffle=False, verbose=0)
    th = tm.fit(tds, epochs=2, batch_size=32, shuffle=False, device="cpu")
    assert sorted(th.history) == sorted(jh.history)
    assert set(METRICS) <= set(th.history)
    for key in sorted(jh.history):
        if key != "examples_per_sec":
            np.testing.assert_allclose(th.history[key], jh.history[key], rtol=RTOL, atol=1e-7,
                                       err_msg=key)
    streaming = port_model(tds)
    mt.load_jax_params(streaming, jax_flat_params(jm))
    streaming.compile(optimizer="adagrad", learning_rate=0.05, train_metrics_steps=2)
    sh = streaming.fit(tds, epochs=2, batch_size=32, shuffle=False, device="cpu")
    assert sh.history["recall_at_10"] != th.history["recall_at_10"]


def test_sparse_embedding_optimizer_steps_one_at_a_time(monkeypatch):
    """With an embedding optimizer k > 1 changes nothing: the row-sparse step
    runs one step at a time, as the JAX package sets spe = 1."""
    ds = mt.generate_data("movielens-25m", num_rows=5 * 32, seed=2)
    monkeypatch.setattr(Model, "_run_chunk", lambda *a, **kw: pytest.fail("chunked"))
    runs = {}
    for spe in (1, 3):
        m = port_model(ds)
        m.compile(optimizer="adagrad", learning_rate=0.05, metrics=[],
                  embedding_optimizer="adagrad", steps_per_execution=spe)
        runs[spe] = (m.fit(ds, epochs=2, batch_size=32, shuffle=True, device="cpu"), m)
    (h1, m1), (h3, m3) = runs[1], runs[3]
    assert h3.history["loss"] == h1.history["loss"]
    p1, p3 = params(m1), params(m3)
    assert all(torch.equal(p3[n], p1[n]) for n in p1)


def test_pack_round_trip():
    """Float columns come back bit for bit (-0.0, a NaN payload, denormals),
    bools as bools, sequence features as values and mask, every column a
    view of the slice but the bools."""
    rng = np.random.default_rng(0)
    n = 9
    f = rng.standard_normal(n).astype(np.float32)
    f[2:5] = [-0.0, np.float32(1e-40), np.frombuffer(np.uint32(0x7FC01234).tobytes(),
                                                     np.float32)[0]]
    feats = {"f": f, "i": rng.integers(-5, 5, n).astype(np.int32),
             "b": rng.random(n) < 0.5, "v": rng.standard_normal((n, 3)).astype(np.float32),
             "s": SequenceFeature(rng.integers(0, 9, (n, 4)).astype(np.int32),
                                  rng.random((n, 4)) < 0.5)}
    for targets in (None, rng.integers(0, 3, n).astype(np.int32),
                    {"t": rng.random(n).astype(np.float32), "u": rng.random(n) < 0.3}):
        packed, spec = Model._pack_device_columns(feats, targets, n)
        assert packed.dtype == np.int32 and packed.shape[0] == n
        assert packed.shape[1] == 1 + 1 + 1 + 3 + 8 + (0 if targets is None else
                                                       1 if not isinstance(targets, dict) else 2)
        sl = torch.from_numpy(packed)[2:7]
        x, y = Model._make_unpack(spec)(sl)
        assert sorted(x) == sorted(feats)
        for name in ("f", "i", "v"):
            want = torch.from_numpy(np.ascontiguousarray(feats[name][2:7]))
            assert x[name].dtype == want.dtype and x[name].shape == want.shape
            assert torch.equal(x[name].view(torch.int32), want.view(torch.int32)), name
            assert x[name].untyped_storage().data_ptr() == sl.untyped_storage().data_ptr()
        assert torch.equal(x["b"], torch.from_numpy(feats["b"][2:7]))
        assert isinstance(x["s"], SequenceFeature)
        assert torch.equal(x["s"].values, torch.from_numpy(feats["s"].values[2:7]))
        assert torch.equal(x["s"].mask, torch.from_numpy(feats["s"].mask[2:7]))
        if targets is None:
            assert y is None
        elif isinstance(targets, dict):
            assert torch.equal(y["t"], torch.from_numpy(targets["t"][2:7]))
            assert torch.equal(y["u"], torch.from_numpy(targets["u"][2:7]))
        else:
            assert torch.equal(y, torch.from_numpy(targets[2:7]))


def test_dense_columns_are_the_loader_batches_unshuffled():
    ds = mt.generate_data("movielens-25m", num_rows=64, seed=4)
    loader = Loader(ds, 32, drop_last=True)
    feats, targets, n = loader.dense_columns()
    assert n == 64 and "__row_valid__" not in feats
    for step, (x, y) in enumerate(loader):
        rows = slice(step * 32, (step + 1) * 32)
        for name, v in x.items():
            if name == "__row_valid__":
                continue
            if isinstance(v, SequenceFeature):
                np.testing.assert_array_equal(feats[name].values[rows], v.values)
                np.testing.assert_array_equal(feats[name].mask[rows], v.mask)
            else:
                np.testing.assert_array_equal(feats[name][rows], v)
        ys = y if isinstance(y, dict) else {None: y}
        ts = targets if isinstance(targets, dict) else {None: targets}
        for name in ys:
            np.testing.assert_array_equal(ts[name][rows], ys[name])
    with pytest.raises(ValueError):
        Loader(ds.take(0), 32).dense_columns()


def test_pack_cache_is_reused_and_kept_for_two_datasets(monkeypatch):
    monkeypatch.setattr(B, "_TRAIN_PACK_LRU", B.deque())
    sets = [mt.generate_data("movielens-25m", num_rows=64, seed=s) for s in range(3)]
    model = port_model(sets[0])
    model.compile(optimizer="adagrad", learning_rate=0.05, metrics=[], steps_per_execution=2)
    model.fit(sets[0], epochs=1, batch_size=32, device="cpu")
    pack = sets[0]._device_train_pack
    model.fit(sets[0], epochs=1, batch_size=16, device="cpu")  # another batch size
    assert sets[0]._device_train_pack is pack
    model.fit(sets[1], epochs=1, batch_size=32, device="cpu")
    assert sets[0]._device_train_pack is pack and sets[1]._device_train_pack is not None
    model.fit(sets[2], epochs=1, batch_size=32, device="cpu")
    assert sets[0]._device_train_pack is None
    assert sets[1]._device_train_pack is not None and sets[2]._device_train_pack is not None
    # a loader that keeps its partial last batch streams: host chunks, the
    # rows' validity packed with them
    big = mt.generate_data("movielens-25m", num_rows=72, seed=9)
    model.fit(Loader(big, 32, drop_last=False), epochs=1, device="cpu")
    assert getattr(big, "_device_train_pack", None) is None


def test_host_chunks_match_single_steps():
    """A loader that keeps its last partial batch takes the host route: k
    batches packed at a time (their __row_valid__ with them), the leftover
    one a step of its own; the trajectory is the streaming route's."""
    ds = mt.generate_data("movielens-25m", num_rows=100, seed=8)
    runs = {}
    for spe in (1, 3):
        m = port_model(ds)
        m.compile(optimizer="adagrad", learning_rate=0.05, metrics=[], steps_per_execution=spe)
        runs[spe] = (m.fit(Loader(ds, 32, drop_last=False), epochs=2, device="cpu"), m)
    (h1, m1), (h3, m3) = runs[1], runs[3]
    assert m1._step == m3._step == 8
    np.testing.assert_allclose(h3.history["loss"], h1.history["loss"], rtol=RTOL)


def test_jit_false_is_the_same_chunk():
    ds = mt.generate_data("movielens-25m", num_rows=6 * 32, seed=10)
    hists = []
    for jit in (True, False):
        m = port_model(ds)
        m.compile(optimizer="adagrad", learning_rate=0.05, steps_per_execution=4, jit=jit,
                  train_metrics_steps=3)
        hists.append(m.fit(ds, epochs=2, batch_size=32, device="cpu").history)
        assert m._jit is jit and len(m._chunk_graphs) == 0
    for key in hists[0]:
        if key != "examples_per_sec":
            assert hists[0][key] == hists[1][key], key


def test_compile_clamps_steps_and_drops_graphs():
    ds = mt.generate_data("movielens-25m", num_rows=32, seed=1)
    model = port_model(ds)
    model.compile(steps_per_execution=0)
    graphs = model._chunk_graphs
    assert model._steps_per_execution == 1 and model._jit is True
    model.compile(steps_per_execution=-3, jit=False)
    assert model._steps_per_execution == 1 and model._chunk_graphs is not graphs


@pytest.mark.parametrize("asked,want", [(None, ("cuda", 0)), ("cuda", ("cuda", 0)),
                                        (torch.device("cuda"), ("cuda", 0)),
                                        ("cuda:1", ("cuda", 1)), ("cpu", ("cpu", None))])
def test_default_card_resolves_to_its_index(monkeypatch, asked, want):
    # fit(device=None) compares its device with the cached pack's (cuda:0):
    # an unindexed "cuda" would never match it, and every fit would pack,
    # upload and capture anew
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    dev = mt.resolve_device(asked)
    assert (dev.type, dev.index) == want
    assert dev == (torch.device(*want) if want[1] is not None else torch.device(want[0]))


def test_dense_route_reads_no_step_and_draws_no_random_numbers():
    """A chunk's graph freezes ``ModelContext(step=...)`` at its capture: no
    block of the dense route may depend on it. Two models, one 1000 steps
    ahead, train bit for bit alike; and the route leaves torch's global
    generator as it found it (no dropout to register with a graph)."""
    ds = mt.generate_data("movielens-25m", num_rows=4 * 32, seed=11)
    results = []
    for offset in (0, 1000):
        m = port_model(ds)
        m.compile(optimizer="adagrad", learning_rate=0.05, metrics=[], steps_per_execution=2)
        m._build_optimizer()
        m._step = offset
        state = torch.get_rng_state()
        h = m.fit(ds, epochs=1, batch_size=32, shuffle=True, device="cpu")
        assert torch.equal(torch.get_rng_state(), state)
        assert m._step == offset + 4
        results.append((h.history["loss"], params(m)))
    assert results[0][0] == results[1][0]
    assert all(torch.equal(results[0][1][n], results[1][1][n]) for n in results[0][1])
