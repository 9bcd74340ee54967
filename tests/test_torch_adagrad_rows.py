"""The dense Adagrad and SGD's row route (``blocks/optimizer.py``, chosen by
``models/base.py::Model.train_step``): a table whose gradient only its
lookups give is stepped at the rows each step looked up. Its parameters and
slots must come out bit-equal to the dense step's, which a test takes by
routing no table (``_choose_row_tables`` patched to choose none: the same
optimizer, stepped with no lookups handed to it). The route is left off
where the gradient holds other rows (a tied head, an ``l2_reg`` term, the
all-reduced gradient of a mesh), where it does not pay (N > R / 2, or a
table of fewer than ``ROW_ROUTE_MIN_ELEMENTS`` elements) and under
``LowPrecisionState``; the counters say which. The tests' tables are small,
so every test but the cutoff's own routes tables of any size. The card test
runs the chunked graph route for two chunks. This file imports nothing of
JAX: the spawned mesh ranks import it."""

import copy

import pytest
import torch
import torch.nn.functional as F

import models_tpu_torch as mt
from models_tpu_torch.blocks import optimizer as O
from models_tpu_torch.data.synthetic import _criteo_layout
from models_tpu_torch.models import base
from models_tpu_torch.models.base import BaseModel
from models_tpu_torch.ops.scatter import row_scatter_write
from models_tpu_torch.parallel.launch import spawn
from models_tpu_torch.transformer import GPT2Block
from models_tpu_torch.transforms import SequencePredictNext
from models_tpu_torch.utils import trace

BATCH = 32
# C1 and C2 take tables of their own, the rest two fused groups (3024 and
# 6016 rows): every table pays at batch 32
DLRM_CARDS = [20000, 9000, 500, 300, 400, 12, 3000, 5, 7, 2000]
COUNTERS = ("optimizer.row_tables", "optimizer.dense_tables", "optimizer.row_lookups")
MIN_ELEMENTS = base.ROW_ROUTE_MIN_ELEMENTS


def schedule(step):
    return 0.05 / (1.0 + 0.1 * step.to(torch.float32))


def dlrm(device="cpu"):
    ds = mt.generate_data(_criteo_layout(DLRM_CARDS), num_rows=8 * BATCH, seed=3)
    model = mt.DLRMModel(ds.schema, embedding_dim=8, bottom_block=(16,), top_block=(16,),
                         device=device)
    return ds, model


def two_tower(device="cpu"):
    # userId (162,544 rows) and movieId (56,688) pay; genres (24) does not
    ds = mt.generate_data("movielens-25m", num_rows=8 * BATCH, seed=0)
    return ds, mt.TwoTowerModel(ds.schema, query_tower=(8, 4), embedding_dim=8, device=device)


MODELS = {"dlrm": dlrm, "two_tower": two_tower}


def routed(model) -> set:
    """The names of the tables the row route steps."""
    return {n for n, p in model.named_parameters() if p in model._row_routes}


def counters() -> dict:
    got = trace.snapshot()["counters"]
    return {k: got.get(k, 0) for k in COUNTERS}


def fit(model, ds, epochs=2, batch_size=BATCH, route=True, **kw):
    """``model.fit``; ``route=False`` routes no table (the dense step)."""
    with pytest.MonkeyPatch.context() as m:
        if not route:
            m.setattr(BaseModel, "_choose_row_tables", lambda self, loss, recorded: frozenset())
        return model.fit(ds, epochs=epochs, batch_size=batch_size, verbose=0,
                         device=model_device(model), **kw)


def model_device(model):
    return next(model.parameters()).device


def assert_bit_equal(a, b):
    """Parameters and every optimizer slot of two models, bit for bit."""
    for (name, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), name
    sa, sb = a._optimizer.state, b._optimizer.state
    assert len(sa) == len(sb)
    for (p, st), (_, st2) in zip(sa.items(), sb.items()):
        for key in st:
            assert torch.equal(st[key], st2[key]), (key, tuple(p.shape))


@pytest.fixture(autouse=True)
def fresh_counters():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture(autouse=True)
def any_size(monkeypatch):
    """The row route for tables of any size (the cutoff's own test sets it
    back)."""
    monkeypatch.setattr(base, "ROW_ROUTE_MIN_ELEMENTS", 0)


@pytest.mark.parametrize("lr", ["number", "schedule"])
@pytest.mark.parametrize("optimizer", ["adagrad", "sgd"])
@pytest.mark.parametrize("kind", sorted(MODELS))
def test_chunked_fit_is_the_dense_step_bit_for_bit(kind, optimizer, lr):
    """Two epochs of the chunked fit, 4 steps a chunk: the routed tables'
    rows and slots, and every other parameter, as the dense step leaves
    them."""
    rate = 0.05 if lr == "number" else schedule
    out = []
    for route in (True, False):
        ds, model = MODELS[kind]()
        model.compile(optimizer=optimizer, learning_rate=rate, metrics=[],
                      steps_per_execution=4)
        history = fit(model, ds, route=route)
        out.append((model, history.history["loss"]))
    (a, loss_a), (b, loss_b) = out
    assert loss_a == loss_b
    assert_bit_equal(a, b)
    want = {"dlrm": {"C1", "C2", "fused_0", "fused_1"}, "two_tower": {"userId", "movieId"}}[kind]
    assert {n.split(".")[-2] for n in routed(a)} == want
    assert not b._row_routes


@pytest.mark.parametrize("opt", [O.Adagrad, O.SGD])
def test_repeated_and_padding_ids(opt):
    """A (B, L) lookup whose rows repeat and whose padding id 0 recurs, and
    a second site of the same table: the row route's step against the dense
    step from the same gradient; the rows no lookup took stay bit for bit,
    the looked-up ones move."""
    gen = torch.Generator().manual_seed(5)
    start = torch.randn(64, 4, generator=gen)
    ids = torch.tensor([[3, 3, 7, 0, 0], [7, 9, 3, 0, 0], [11, 3, 3, 3, 0]])
    more = torch.tensor([9, 40, 40])
    weight = torch.randn(3, 5, 4, generator=gen)
    got = []
    for lookups in (True, False):
        table = torch.nn.Parameter(start.clone())
        o = opt([table], 0.05)
        for _ in range(3):
            loss = (F.embedding(ids, table) * weight).sum() + F.embedding(more, table).sum()
            table.grad = None
            loss.backward()
            o.step(lookups={table: [ids, more]} if lookups else None)
        got.append((table.detach(), o.state[table].get("sum")))
    (t_rows, s_rows), (t_dense, s_dense) = got
    assert torch.equal(t_rows, t_dense)
    if opt is O.Adagrad:
        assert torch.equal(s_rows, s_dense)
    taken = torch.zeros(64, dtype=torch.bool)
    taken[torch.cat([ids.reshape(-1), more])] = True
    assert torch.equal(t_rows[~taken], start[~taken])
    assert (t_rows[taken] != start[taken]).any(dim=1).all()


def test_sorted_runs():
    """The route's ids: sorted int32, the first of each run marked."""
    sids, first = O.looked_up_rows([torch.tensor([[5, 2], [5, 0]]), torch.tensor([2, 9])])
    assert sids.dtype == torch.int32
    assert sids.tolist() == [0, 2, 2, 5, 5, 9]
    assert first.tolist() == [True, True, False, True, False, True]


def tied_session():
    ds = mt.generate_data("sequence-testing", num_rows=8 * 8, seed=1)
    model = mt.SessionBasedTransformerModel(
        ds.schema, transformer=GPT2Block(d_model=16, n_head=2, n_layer=1, dropout=0.0,
                                         device="cpu"),
        embedding_dim=16, device="cpu")
    model.compile(optimizer="adagrad", learning_rate=0.05, metrics=[])
    return ds, model, dict(batch_size=8, pre=SequencePredictNext(ds.schema,
                                                                 target="item_id_seq"))


def l2_reg_mf():
    ds = mt.generate_data("movielens-25m", num_rows=4 * BATCH, seed=0)
    model = mt.MatrixFactorizationModel(ds.schema, dim=8, seed=3, l2_reg=1e-4, device="cpu")
    model.compile(optimizer="adagrad", learning_rate=0.05, metrics=[])
    return ds, model, {}


def large_batch_dlrm():
    # at batch 1024 fused_0 (3024 rows) takes 6 x 1024 ids a step
    ds = mt.generate_data(_criteo_layout(DLRM_CARDS), num_rows=2048, seed=3)
    model = mt.DLRMModel(ds.schema, embedding_dim=8, bottom_block=(16,), top_block=(16,),
                         device="cpu")
    model.compile(optimizer="adagrad", learning_rate=0.05, metrics=[])
    return ds, model, dict(batch_size=1024)


def low_precision_two_tower():
    ds, model = two_tower()
    model.compile(optimizer="adagrad", learning_rate=0.05, metrics=[],
                  optimizer_state_dtype="bfloat16")
    return ds, model, {}


def mf_in_batch():
    # the tied item table looked up for the positives alone (in-batch
    # negatives): lookup-only, so routed, against the session's full catalog
    ds = mt.generate_data("movielens-25m", num_rows=4 * BATCH, seed=0)
    model = mt.MatrixFactorizationModel(ds.schema, dim=8, seed=3, device="cpu")
    model.compile(optimizer="adagrad", learning_rate=0.05, metrics=[])
    return ds, model, {}


# case -> (maker, tables left dense, tables routed)
CASES = {
    "tied_head": (tied_session, {"item_id_seq"}, {"test_user_id", "categories",
                                                  "user_country"}),
    "l2_reg": (l2_reg_mf, {"block", "table"}, set()),
    "n_over_half": (large_batch_dlrm, {"fused_0"}, {"C1", "C2", "fused_1"}),
    "low_precision": (low_precision_two_tower, {"userId", "movieId", "genres"}, set()),
    "tied_lookups_only": (mf_in_batch, set(), {"block", "table"}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tables_left_dense(case):
    """Which tables the route leaves dense, the counters saying so (the MF's
    tied table, looked up alone, as the control that routes); the fit
    bit-equal to the dense step all the same."""
    maker, dense, rows = CASES[case]
    ds, model, kw = maker()
    fit(model, ds, epochs=1, **kw)
    got = counters()
    assert got["optimizer.row_tables"] == len(rows)
    assert got["optimizer.dense_tables"] == len(dense)
    assert {n.split(".")[-2] for n in routed(model)} == rows
    assert (got["optimizer.row_lookups"] > 0) == bool(rows)
    ds, other, kw = maker()
    fit(other, ds, epochs=1, route=False, **kw)
    assert_bit_equal(model, other)


def test_counters_on_the_small_dlrm():
    """Four tables routed, none dense, at one choice; N = 32 ids of each of
    the 10 columns at each of the 16 steps (on the CPU the host runs every
    step: no graph)."""
    ds, model = dlrm()
    model.compile(optimizer="adagrad", learning_rate=0.05, metrics=[], steps_per_execution=4)
    fit(model, ds)
    assert counters() == {"optimizer.row_tables": 4, "optimizer.dense_tables": 0,
                          "optimizer.row_lookups": 16 * BATCH * len(DLRM_CARDS)}
    fit(model, ds)  # the choice holds while the optimizer lives
    assert counters()["optimizer.row_tables"] == 4
    model.compile(optimizer="adam", learning_rate=1e-3, metrics=[], steps_per_execution=4)
    fit(model, ds, epochs=1)
    assert counters()["optimizer.dense_tables"] == 4  # adam: nothing routed


@pytest.mark.parametrize("c1_rows", [20000, 600_000])
def test_tables_below_the_cutoff_stay_dense(c1_rows, monkeypatch):
    """At the measured cutoff a table of fewer than ROW_ROUTE_MIN_ELEMENTS
    elements stays dense: the small DLRM routes nothing, and C1 routes at
    600,000 x 8 (4.8M elements)."""
    monkeypatch.setattr(base, "ROW_ROUTE_MIN_ELEMENTS", MIN_ELEMENTS)
    ds = mt.generate_data(_criteo_layout([c1_rows] + DLRM_CARDS[1:]), num_rows=4 * BATCH,
                          seed=3)
    model = mt.DLRMModel(ds.schema, embedding_dim=8, bottom_block=(16,), top_block=(16,),
                         device="cpu")
    model.compile(optimizer="adagrad", learning_rate=0.05, metrics=[])
    fit(model, ds, epochs=1)
    rows = {"C1"} if c1_rows * 8 >= MIN_ELEMENTS else set()
    assert {n.split(".")[-2] for n in routed(model)} == rows
    assert counters()["optimizer.row_tables"] == len(rows)
    assert counters()["optimizer.dense_tables"] == 4 - len(rows)


def test_the_choice_follows_a_copy():
    """A deep copy of a trained model routes its own tables, the ones the
    original routes, and steps them as the original does."""
    ds, model = two_tower()
    model.compile(optimizer="adagrad", learning_rate=0.05, metrics=[])
    fit(model, ds, epochs=1)
    clone = copy.deepcopy(model)
    own = set(clone.parameters())
    assert clone._row_routes and all(t in own for t in clone._row_routes)
    assert routed(clone) == routed(model)
    for m in (model, clone):
        fit(m, ds, epochs=1)
    assert_bit_equal(model, clone)


def test_multi_optimizer_routes_its_adagrad():
    """Tables under a MultiOptimizer's adagrad rule take the route, the MLPs
    stay with adam; bit-equal to the dense step."""
    out = []
    for route in (True, False):
        ds, model = dlrm()
        model.compile(optimizer=mt.MultiOptimizer(default="adam",
                                                  rules=[("table", ("adagrad", 0.05))]),
                      learning_rate=1e-3, metrics=[], steps_per_execution=4)
        fit(model, ds, route=route)
        out.append(model)
    assert {n.split(".")[-2] for n in routed(out[0])} == {"C1", "C2", "fused_0", "fused_1"}
    assert_bit_equal(*out)


def mesh_rank(rank, world, init_method):
    """One of two gloo ranks: the small DLRM fit on a {2, 1} mesh with its
    tables whole on every rank; returns the counters."""
    torch.set_num_threads(1)
    base.ROW_ROUTE_MIN_ELEMENTS = 0
    mt.parallel.initialize(init_method, world, rank, backend="gloo", device="cpu")
    try:
        trace.reset()
        ds, model = dlrm()
        model.compile(optimizer="adagrad", learning_rate=0.05, metrics=[])
        mesh = mt.make_mesh({"data": 2, "model": 1}, device="cpu")
        model.fit(ds, epochs=1, batch_size=BATCH, mesh=mesh, shard_rules=[], verbose=0,
                  device="cpu")
        return counters()
    finally:
        mt.parallel.shutdown()


def test_route_left_off_on_a_mesh():
    """On a mesh the all-reduced gradient holds rows other ranks looked up:
    every table, whole on each rank and looked up plainly, stays dense."""
    for got in spawn(mesh_rank, 2, timeout=240):
        assert got == {"optimizer.row_tables": 0, "optimizer.dense_tables": 4,
                       "optimizer.row_lookups": 0}


@pytest.mark.card
def test_graph_route_on_the_card_is_the_dense_step():
    """The chunked fit on the card, 4 steps a chunk over 8 batches: the first
    chunk eager, the second captured and replayed, and a second fit of two
    replays. The route's tables and slots bit-equal to the dense step's from
    the same state; K8a launched; replays, no drops."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = []
    for route in (True, False):
        trace.reset()
        ds, model = dlrm("cuda")
        model.compile(optimizer="adagrad", learning_rate=0.05, metrics=[],
                      steps_per_execution=4)
        launches = row_scatter_write.launches
        for _ in range(2):
            fit(model, ds, epochs=1, route=route)
        torch.cuda.synchronize()
        got = trace.snapshot()["counters"]
        assert got.get("graph.replays", 0) == 3 and "graph.drops" not in got
        if route:
            assert row_scatter_write.launches > launches
            assert got["optimizer.row_tables"] == 4
            # the host runs the eager chunk's 4 steps and the capture's 4; a
            # replay runs none
            assert got["optimizer.row_lookups"] == 8 * BATCH * len(DLRM_CARDS)
        out.append(model)
    assert_bit_equal(*out)
