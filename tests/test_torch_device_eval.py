"""The device-resident ``evaluate`` and in-fit validation
(``Model._pack_for_eval``, ``_eval_chunk_fn``, ``_try_device_eval``) and the
streaming routes' device prefetch (``models/base.py::_device_prefetch``), on
the CPU, where the device route's chunks run eagerly over the eval pack.

Both packages draw the same rows from one seed; the JAX model's parameters
are carried over with ``load_jax_params``. 150 rows at batch 32 (4 x 32 +
22: the last batch padded and masked), towers (16, 8). The port's device
route is held to the JAX package's ``evaluate``, which takes its fused
route here, within ``tests/test_torch_evaluate.py``'s tolerance (rtol 1e-5,
atol 1e-7: fp32 sums in another order), and to the port's own streaming
route bit for bit (``_try_device_eval`` patched to None, as
``tests/unit/test_parallel.py::test_fused_evaluate_matches_streaming``
does). Which route each package takes is read from a spy on its
``_try_device_eval``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import models_tpu.losses as jlosses
import models_tpu.models.base as jbase
from models_tpu.data import Loader as JLoader
from models_tpu.data import generate_data as jax_generate
from models_tpu.models import DLRMModel as JDLRM
from models_tpu.models import TwoTowerModel as JTwoTowerModel

import models_tpu_torch as mt
from models_tpu_torch.core.types import to_device_batch, to_device_targets
from models_tpu_torch.data import Loader
from models_tpu_torch.models import base
from models_tpu_torch.schema import ColumnSchema, Schema, Tags, create_categorical_column

ROWS, BATCH = 150, 32
RTOL = 1e-5
CPU = torch.device("cpu")
KW = dict(query_tower=(16, 8), embedding_dim=8)
DLRM_KW = dict(embedding_dim=8, bottom_block=(16,), top_block=(16, 8))
CASES = ["in_batch", "corpus_fp32", "corpus_bf16", "corpus_int8", "dlrm_auc"]
DTYPES = {"corpus_bf16": (jnp.bfloat16, torch.bfloat16), "corpus_int8": (jnp.int8, torch.int8)}


def jax_state(model, kind=nnx.Param):
    return {"/".join(str(p) for p in path): np.asarray(var[...])
            for path, var in nnx.state(model, kind).flat_state()
            if "sparse_slots" not in path}


def assert_logs_close(got, want):
    """``tests/test_torch_evaluate.py::assert_logs_close``."""
    assert sorted(got) == sorted(want)
    for key in want:
        if key.endswith("examples_per_sec"):
            continue
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=1e-7, err_msg=key)


def two_tower_pair(seed=31):
    jds = jax_generate("movielens-25m", num_rows=ROWS, seed=seed)
    tds = mt.generate_data("movielens-25m", num_rows=ROWS, seed=seed)
    jm = JTwoTowerModel(jds.schema, **KW)
    jm.compile()
    jm.build(JLoader(jds, BATCH))
    tm = mt.TwoTowerModel(tds.schema, device="cpu", **KW)
    mt.load_jax_params(tm, jax_state(jm))
    return jds, tds, jm, tm


def dlrm_pair(seed=32):
    jds = jax_generate("criteo-small", num_rows=ROWS, seed=seed)
    tds = mt.generate_data("criteo-small", num_rows=ROWS, seed=seed)
    jm = JDLRM(jds.schema, **DLRM_KW)
    jm.compile(optimizer="adagrad", learning_rate=0.05)
    jm.build(JLoader(jds, BATCH))
    tm = mt.DLRMModel(tds.schema, device="cpu", **DLRM_KW)
    mt.load_jax_params(tm, jax_state(jm, nnx.Variable))
    return jds, tds, jm, tm


def _bce_softplus(labels, logits, sample_weight=None):
    labels = labels.reshape(logits.shape).astype(logits.dtype)
    return jlosses._weighted_mean(jax.nn.softplus(logits) - logits * labels, sample_weight)


@pytest.fixture
def jax_bce(monkeypatch):
    """The JAX package's binary heads with ``softplus(x) - x y``, as
    ``tests/test_torch_ranking_models.py`` patches them."""
    monkeypatch.setitem(jlosses.loss_registry._store, "binary_crossentropy", _bce_softplus)


@pytest.fixture
def routes(monkeypatch):
    """How many evaluations took the device route, by package."""
    taken = {"jax": 0, "port": 0}

    def spy(cls, key):
        orig = cls._try_device_eval

        def wrapped(self, *args, **kwargs):
            run = orig(self, *args, **kwargs)
            taken[key] += run is not None
            return run

        monkeypatch.setattr(cls, "_try_device_eval", wrapped)

    spy(jbase.BaseModel, "jax")
    spy(base.BaseModel, "port")
    return taken


def port_case(case, tds, tm):
    if case in ("in_batch", "dlrm_auc"):
        return tm.evaluate(tds, batch_size=BATCH, device="cpu")
    if case == "corpus_fp32":
        return tm.evaluate(tds, batch_size=BATCH, item_corpus=tds, k=10, device="cpu")
    enc = tm.to_top_k_encoder(tds, k=10, candidate_dtype=DTYPES[case][1], device="cpu")
    return enc.evaluate(tds, batch_size=BATCH, device="cpu")


def jax_case(case, jds, jm):
    if case in ("in_batch", "dlrm_auc"):
        return jm.evaluate(jds, batch_size=BATCH)
    if case == "corpus_fp32":
        return jm.evaluate(jds, batch_size=BATCH, item_corpus=jds, k=10)
    enc = jm.to_top_k_encoder(jds, k=10, candidate_dtype=DTYPES[case][0])
    return enc.evaluate(jds, batch_size=BATCH)


def pair_for(case):
    return dlrm_pair() if case == "dlrm_auc" else two_tower_pair()


@pytest.mark.parametrize("case", CASES)
def test_device_route_matches_jax(case, routes, jax_bce):
    jds, tds, jm, tm = pair_for(case)
    got = port_case(case, tds, tm)
    want = jax_case(case, jds, jm)
    assert routes == {"jax": 1, "port": 1}
    assert list(got) == list(want)
    assert_logs_close(got, want)
    if case == "dlrm_auc":
        assert 0.0 < got["label/auc"] < 1.0


@pytest.mark.parametrize("case", CASES)
def test_device_route_bit_equal_to_streaming(case, routes, monkeypatch):
    _, tds, _, tm = pair_for(case)
    device = port_case(case, tds, tm)
    monkeypatch.setattr(base.BaseModel, "_try_device_eval", lambda *a, **k: None)
    streaming = port_case(case, tds, tm)
    assert routes["port"] == 1
    assert device == streaming


def test_chunks_of_a_few_batches_bit_equal_to_streaming(monkeypatch):
    """Five batches in chunks of two (two, two and one: two chunk shapes)
    give the one-chunk route's results."""
    _, tds, _, tm = two_tower_pair()
    whole = tm.evaluate(tds, batch_size=BATCH, device="cpu")
    ks = []
    orig = base.BaseModel._eval_chunk_fn
    monkeypatch.setattr(base, "EVAL_CHUNK_BATCHES", 2)
    monkeypatch.setattr(base.BaseModel, "_eval_chunk_fn",
                        lambda self, k, *a: ks.append(k) or orig(self, k, *a))
    assert tm.evaluate(tds, batch_size=BATCH, device="cpu") == whole
    assert ks == [2, 2, 1]


CONDITIONS = {
    "every_row": ({}, {}, True),
    "drop_last": ({"drop_last": True}, {}, False),
    "steps": ({}, {"steps": 3}, False),
    "jit_off": ({}, {"jit": False}, False),
    "bucket": ({"pad": "bucket"}, {}, False),
    "transform": ({"transform": lambda f, t: (f, t)}, {}, False),
    "global_size": ({"global_size": 2, "global_rank": 1}, {}, False),
}


@pytest.mark.parametrize("cond", sorted(CONDITIONS))
def test_route_follows_jax_conditions(cond, routes):
    """The device route where the JAX package's ``evaluate`` takes its
    fused route, streaming elsewhere, and the same results either way."""
    loader_kw, call_kw, device = CONDITIONS[cond]
    jds, tds, jm, tm = two_tower_pair()
    call_kw = dict(call_kw)
    jit = call_kw.pop("jit", True)
    jm.compile(jit=jit)
    tm.compile(jit=jit)
    got = tm.evaluate(Loader(tds, BATCH, **loader_kw), device="cpu", **call_kw)
    want = jm.evaluate(JLoader(jds, BATCH, **loader_kw), **call_kw)
    assert routes == {"jax": int(device), "port": int(device)}
    assert_logs_close(got, want)


class Identity(torch.nn.Module):
    def forward(self, x, targets=None, training=False, context=None):
        return x, targets


def test_pre_streams_with_the_same_steps(routes):
    _, tds, _, tm = two_tower_pair()
    device = tm.evaluate(tds, batch_size=BATCH, device="cpu")
    streamed = tm.evaluate(tds, batch_size=BATCH, pre=Identity(), device="cpu")
    assert routes["port"] == 1
    assert streamed == device


def test_mesh_streams(tmp_path, routes):
    """After ``fit(mesh=)`` (one gloo rank here) ``evaluate`` runs on the
    mesh and streams, as the JAX package's does; its results are those of
    the device route off the mesh."""
    from models_tpu_torch.parallel.distributed import initialize, shutdown

    _, tds, _, tm = two_tower_pair()
    initialize(f"file://{tmp_path}/store", 1, 0, backend="gloo", device="cpu")
    try:
        mesh = mt.make_mesh({"data": 1, "model": 1}, device="cpu")
        tm.compile(optimizer="adagrad", learning_rate=0.05)
        tm.fit(tds, epochs=1, batch_size=BATCH, shuffle=False, mesh=mesh, device="cpu")
        on_mesh = tm.evaluate(tds, batch_size=BATCH, device="cpu")
        assert routes["port"] == 0
    finally:
        shutdown()
    tm._mesh = None
    off_mesh = tm.evaluate(tds, batch_size=BATCH, device="cpu")
    assert routes["port"] == 1
    assert_logs_close(on_mesh, off_mesh)


def test_eval_pack_is_the_loaders_batches_padded_with_zero_rows():
    _, tds, _, tm = two_tower_pair()
    loader = Loader(tds, BATCH)
    pack = base.Model._pack_for_eval(loader, CPU)
    assert pack.n_rows == ROWS and pack.packed.shape[0] == 5 * BATCH
    assert pack.packed.dtype == torch.int32 and not pack.packed[ROWS:].any()
    unpack = base.Model._make_unpack(pack.spec)
    for i, (x, y) in enumerate(loader):
        px, py = unpack(pack.packed[i * BATCH:(i + 1) * BATCH])
        assert sorted(px) == sorted(k for k in x if k != base.ROW_VALID_KEY)
        for name, v in px.items():
            want = x[name]
            if isinstance(v, mt.SequenceFeature):
                assert np.array_equal(v.values.numpy(), want.values)
                assert np.array_equal(v.mask.numpy(), want.mask)
            else:
                assert np.array_equal(v.numpy(), want.astype(v.numpy().dtype)), name
    assert base.Model._pack_for_eval(Loader(tds, BATCH), CPU) is pack  # cached
    wider = base.Model._pack_for_eval(Loader(tds, 64), CPU)
    assert wider is not pack and wider.packed.shape[0] == 3 * 64
    assert tds._device_eval_pack[1] is wider  # one pack a dataset: the last batch size's


def test_at_most_two_datasets_keep_an_eval_pack():
    sets = [mt.generate_data("movielens-25m", num_rows=40, seed=s) for s in (1, 2, 3)]
    for ds in sets:
        assert base.Model._pack_for_eval(Loader(ds, 16), CPU) is not None
    assert sets[0]._device_eval_pack is None
    assert sets[1]._device_eval_pack is not None and sets[2]._device_eval_pack is not None
    # packed again at another batch size, a dataset still counts once
    base.Model._pack_for_eval(Loader(sets[2], 8), CPU)
    assert sets[1]._device_eval_pack is not None and sets[2]._device_eval_pack[0] == 8


def test_an_eval_set_without_rows_gets_no_pack():
    """No pack for no rows, as the JAX package's ``_pack_for_eval``."""
    empty = mt.generate_data("movielens-25m", num_rows=40, seed=1).take(0)
    assert empty.num_rows == 0
    assert base.Model._pack_for_eval(Loader(empty, 16), CPU) is None
    assert getattr(empty, "_device_eval_pack", None) is None


def test_pack_over_the_byte_limit_streams(monkeypatch, routes):
    _, tds, _, tm = two_tower_pair()
    device = tm.evaluate(tds, batch_size=BATCH, device="cpu")
    tds._device_eval_pack = None
    monkeypatch.setattr(base, "MAX_EVAL_PACK_BYTES", 1000)
    assert base.Model._pack_for_eval(Loader(tds, BATCH), CPU) is None
    assert tm.evaluate(tds, batch_size=BATCH, device="cpu") == device
    assert routes["port"] == 1


def test_eval_pack_respects_drop_last_and_compile_resets_caches():
    """``tests/unit/test_parallel.py::test_eval_pack_respects_drop_last_and_
    compile_resets_caches`` on the port: no pack for a ``drop_last`` loader;
    ``compile()`` drops every graph cache, the evaluation's among them."""
    _, tds, _, tm = two_tower_pair()
    assert base.Model._pack_for_eval(Loader(tds, BATCH, drop_last=True), CPU) is None
    assert base.Model._pack_for_eval(Loader(tds, BATCH), CPU) is not None
    tm.compile(optimizer="adam", learning_rate=0.05)
    old = tm._eval_graphs
    tm._eval_graphs._entries["sentinel"] = object()
    tm._chunk_graphs._entries["sentinel"] = object()
    tm.compile(optimizer="adam", learning_rate=0.01)
    assert tm._eval_graphs is not old and not tm._eval_graphs._entries
    assert not tm._chunk_graphs._entries
    assert copy.deepcopy(tm)._eval_graphs._tensors is base.eval_tensors


def test_device_eval_keys_on_column_names():
    """``tests/unit/test_engine.py::test_device_eval_cache_keys_on_column_names``
    on the port: two eval sets of the same widths whose extra column sorts
    first (``aa_x``) or last (``zz_x``) have other pack layouts, which key
    their chunks apart, and evaluate alike (the model reads neither)."""
    rng = np.random.default_rng(5)
    n = 96
    user = rng.integers(0, 20, n).astype(np.int64)
    item = rng.integers(0, 30, n).astype(np.int64)
    extra = rng.integers(0, 10, n).astype(np.int64)
    click = (rng.random(n) < 0.5).astype(np.float32)
    base_cols = [
        create_categorical_column("user_id", 20, tags=Tags.USER_ID),
        create_categorical_column("item_id", 30, tags=Tags.ITEM_ID),
        ColumnSchema("click", tags=(Tags.BINARY_CLASSIFICATION, Tags.TARGET), dtype="float32"),
    ]

    def make(extra_name):
        cols = base_cols + [create_categorical_column(extra_name, 10)]
        return mt.Dataset({"user_id": user, "item_id": item, extra_name: extra, "click": click},
                          Schema(cols))

    ds_a, ds_b = make("aa_x"), make("zz_x")
    schema = Schema(base_cols)
    torch.manual_seed(2)
    model = mt.Model(mt.InputBlockV2(schema, dim=8, device="cpu") >> mt.MLPBlock([16]),
                     mt.BinaryOutput("click", device="cpu"), schema=schema)
    model.build(mt.Dataset({"user_id": user, "item_id": item, "click": click}, schema),
                device="cpu")
    model.compile()
    pa = base.Model._pack_for_eval(Loader(ds_a, 32), CPU)
    pb = base.Model._pack_for_eval(Loader(ds_b, 32), CPU)
    assert pa.spec != pb.spec and pa.packed.shape == pb.packed.shape
    ra = model.evaluate(ds_a, batch_size=32, device="cpu")
    rb = model.evaluate(ds_b, batch_size=32, device="cpu")
    assert ra == rb


@pytest.mark.parametrize("spe", [1, 4])
def test_fit_validation_takes_the_device_route(spe, routes, monkeypatch):
    """``fit(validation_data=)`` validates on the device route. One step a
    chunk: ``evaluate`` each epoch (two copies to the host an epoch). Four
    (the training pack's route, the JAX package's fused fit): the
    validation chunk follows the epoch's last, one copy an epoch. The
    history is the JAX package's either way."""
    fetches = []
    orig = base._fetch
    monkeypatch.setattr(base, "_fetch", lambda values: fetches.append(1) or orig(values))
    jds, tds, jm, tm = two_tower_pair(seed=33)
    jm.compile(optimizer="adagrad", learning_rate=0.05, steps_per_execution=spe)
    tm.compile(optimizer="adagrad", learning_rate=0.05, steps_per_execution=spe)
    jh = jm.fit(jds, epochs=2, batch_size=BATCH, shuffle=False, validation_data=jds, verbose=0)
    th = tm.fit(tds, epochs=2, batch_size=BATCH, shuffle=False, validation_data=tds,
                device="cpu")
    assert routes["port"] == (1 if spe > 1 else 2)
    assert len(fetches) == (2 if spe > 1 else 4)
    assert sorted(k for k in th.history if k.startswith("val_")) == sorted(
        k for k in jh.history if k.startswith("val_"))
    assert all(len(v) == 2 for v in th.history.values())
    assert_logs_close(th.history, jh.history)


def test_fused_validation_history_equals_the_epoch_by_epoch_one(monkeypatch):
    """The history of a fit whose validation rides the epoch's fetch equals,
    key for key and in order, that of the same fit validated by a separate
    ``evaluate`` each epoch (a callback keeps it out of the fused route)."""

    class Noop:
        pass

    runs = []
    for callbacks in (None, [Noop()]):
        _, tds, _, tm = two_tower_pair(seed=34)
        tm.compile(optimizer="adagrad", learning_rate=0.05, steps_per_execution=2)
        runs.append(tm.fit(tds, epochs=2, batch_size=BATCH, shuffle=False,
                           validation_data=tds, callbacks=callbacks, device="cpu").history)
    fused, separate = runs
    assert list(fused) == list(separate)
    for key in fused:
        if key != "examples_per_sec":
            assert fused[key] == separate[key], key


def in_line(batches, dev):
    for x, y in batches:
        yield to_device_batch(x, dev), to_device_targets(y, dev)


def test_prefetched_fit_and_evaluate_bit_equal_to_in_line(monkeypatch):
    """The streaming fit (one step at a time, shuffled) and the streaming
    evaluate (``steps`` given) through ``_device_prefetch`` equal the same
    runs with each batch copied in line, bit for bit."""
    used = []
    prefetch = base._device_prefetch
    runs = []
    for route in ("prefetched", "in_line"):
        fn = prefetch if route == "prefetched" else in_line
        monkeypatch.setattr(base, "_device_prefetch",
                            lambda batches, dev, fn=fn: used.append(route) or fn(batches, dev))
        _, tds, _, tm = two_tower_pair(seed=35)
        tm.compile(optimizer="adagrad", learning_rate=0.05)
        hist = tm.fit(tds, epochs=2, batch_size=BATCH, device="cpu").history
        ev = tm.evaluate(tds, batch_size=BATCH, steps=5, device="cpu")
        runs.append((hist, ev, {n: p.detach().clone() for n, p in tm.named_parameters()}))
    assert used == ["prefetched"] * 3 + ["in_line"] * 3
    (h1, e1, p1), (h2, e2, p2) = runs
    assert {k: v for k, v in h1.items() if k != "examples_per_sec"} == {
        k: v for k, v in h2.items() if k != "examples_per_sec"}
    assert e1 == e2
    assert all(torch.equal(p1[n], p2[n]) for n in p1)


def test_device_prefetch_keeps_one_batch_ahead():
    pulled = []

    def batches():
        for i in range(3):
            pulled.append(i)
            yield {"a": np.full(2, i, np.int32)}, np.full(2, -i, np.float32)

    it = base._device_prefetch(batches(), CPU)
    seen = []
    for x, y in it:
        seen.append((int(x["a"][0]), float(y[0]), len(pulled)))
    assert seen == [(0, 0.0, 2), (1, -1.0, 3), (2, -2.0, 3)]


def test_auc_thresholds_outlive_their_metric():
    """A captured graph reads the AUC's thresholds by address, and each
    ``evaluate`` resolves its metrics anew: every AUC of a count shares one
    thresholds tensor a device, which outlives the metric objects."""
    from models_tpu_torch.metrics.base import AUC, auc_thresholds

    first = AUC().thresholds("cpu")
    address = first.data_ptr()
    del first
    again = AUC().thresholds(CPU)
    assert again.data_ptr() == address
    assert np.array_equal(again.numpy(), auc_thresholds(200))
    assert AUC(num_thresholds=50).thresholds(CPU).shape == (50,)


def assert_batch_rebuilt(x, y, rebuilt):
    rx, ry = rebuilt
    want = {**to_device_batch(x, CPU), **({} if y is None else to_device_batch(
        y if isinstance(y, dict) else {"": y}, CPU))}
    got = {**rx, **({} if ry is None else ry if isinstance(ry, dict) else {"": ry})}
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        pairs = ([(g.values, w.values), (g.mask, w.mask)]
                 if isinstance(w, mt.SequenceFeature) else [(g, w)])
        for a, b in pairs:
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), k


@pytest.mark.parametrize("name", ["movielens-25m", "e-commerce", "sequence-testing"])
def test_one_buffer_rebuilds_each_batch(name):
    """The prefetch's batch in one buffer (``_BatchLayout``, unpinned
    here): every column rebuilt from the host buffer the layout wrote it
    into, and from a copy of it, with its dtype, shape and values, list
    columns and one or several targets included; the layout's two host
    buffers written in turn, a batch's intact after the next is written."""
    batches = list(Loader(mt.generate_data(name, num_rows=40, seed=3), 16))  # last one padded
    structure, arrays = base._batch_arrays(*batches[0])
    layout = base._BatchLayout(structure, arrays, pin=False)
    slots = []
    for i, (x, y) in enumerate(batches):
        same, arrays = base._batch_arrays(x, y)
        assert same == structure
        slots.append(layout.fill(arrays))
        host = layout.hosts[slots[-1]]
        assert_batch_rebuilt(x, y, layout.rebuild(host))
        assert_batch_rebuilt(x, y, layout.rebuild(host.clone()))
        if i:
            assert_batch_rebuilt(*batches[i - 1], layout.rebuild(layout.hosts[slots[-2]]))
    assert slots == [0, 1, 0]
