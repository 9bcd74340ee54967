"""The port's multi-task blocks and models (MMOE, CGC, PLE, the V1
prediction tasks, the next-item task) against the JAX package's, on the
CPU.

Both packages draw the same rows from one seed (``e-commerce``, two binary
targets, batches of 64) and the JAX parameters are carried over with
``load_jax_params``. Tolerances, each with its reason:

- a block's forward within 1e-6 of its largest output (float32 sums of a
  few dozen products, in another order);
- three Adam steps (lr 1e-3) with loss and class weights: every logged
  loss rtol 1e-5, every parameter within 1e-5 (Adam moves an element by
  about lr a step wherever |g| >> eps; no gradient here is rounding noise
  of a zero: a row no batch looked up has a gradient of exactly 0 in both);
  the metrics (AUC, precision, recall, accuracy) within METRIC_ATOL (the
  same counts);
- the next-item heads, three adagrad steps: losses rtol 1e-5, parameters
  rtol 1e-4 / atol 1e-6, as the session models' tests.

The binary heads' loss: the JAX package's form has the gradient ``-y`` at
a logit of exactly 0, which a row of dead experts gives (the heads' bias
starts at 0); the JAX reference trains with ``softplus(x) - x y``
(``jax_bce``), as in ``tests/test_torch_ranking_models.py``.

``PredictionTasks(task_pre_dict=)``: the JAX package builds a tower with a
pre block as ``SequentialBlock(tower, pre)``, which makes the pre block the
sequential's own ``pre`` and runs it BEFORE the tower, where its docstring
(and the reference) applies it after; the JAX side here builds
``SequentialBlock([tower, pre])``, the order meant (ROADMAP.md queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import models_tpu as mm
import models_tpu.losses as jlosses
import models_tpu.outputs.tasks as jtasks
from models_tpu.blocks import experts as jexperts
from models_tpu.core.block import Lambda as JLambda
from models_tpu.core.combinators import SequentialBlock as JSequential
from models_tpu.data import Loader as JLoader
from models_tpu.data import generate_data as jax_generate
from models_tpu.models.session import _ProjectToTableDim as JProject
from models_tpu.models.session import _SequenceConcat as JConcat
from models_tpu.models.session import _find_item_table as jfind_table
from models_tpu.transformer import block as jtb
from models_tpu.transforms import sequence as jseq

import models_tpu_torch as mt
from models_tpu_torch.blocks import experts as texperts
from models_tpu_torch.blocks.mlp import MLPBlock
from models_tpu_torch.core.combinators import SequentialBlock
from models_tpu_torch.models.session import _ProjectToTableDim as TProject
from models_tpu_torch.models.session import _SequenceConcat as TConcat
from models_tpu_torch.models.session import _find_item_table as tfind_table
from models_tpu_torch.outputs.contrastive import ContrastiveOutput
from models_tpu_torch.outputs.sampling import PopularityBasedSampler
from models_tpu_torch.transformer import block as ttb
from models_tpu_torch.transforms import sequence as tseq

BATCH, STEPS = 64, 3
METRIC_ATOL = 1e-6
LOSS_WEIGHTS = {"click/BinaryOutput": 1.0, "conversion": 0.5}


def jax_params(module):
    return {"/".join(str(p) for p in path): np.asarray(v[...])
            for path, v in nnx.state(module, nnx.Param).flat_state()}


def port_params(module):
    out = {}
    for name, p in module.named_parameters():
        parts, value = name.split("."), p.detach().float().numpy()
        if parts[-1] == "weight":
            parts, value = parts[:-1] + ["kernel"], value.T
        out["/".join(parts)] = value
    return out


def assert_params_close(tm, jm, rtol=0.0, atol=1e-5):
    want, got = jax_params(jm), port_params(tm)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=rtol, atol=atol, err_msg=key)


def assert_logs_close(got, want):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if key == "examples_per_sec":
            continue
        if key.startswith("loss") or key == "regularization_loss":
            np.testing.assert_allclose(got[key], value, rtol=1e-5, atol=1e-7, err_msg=key)
        else:
            np.testing.assert_allclose(got[key], value, atol=METRIC_ATOL, err_msg=key)


def _bce_softplus(labels, logits, sample_weight=None):
    labels = labels.reshape(logits.shape).astype(logits.dtype)
    return jlosses._weighted_mean(jax.nn.softplus(logits) - logits * labels, sample_weight)


@pytest.fixture
def jax_bce(monkeypatch):
    monkeypatch.setitem(jlosses.loss_registry._store, "binary_crossentropy", _bce_softplus)


@pytest.fixture
def jax_task_pre_after_tower(monkeypatch):
    """The JAX ``PredictionTasks`` with its pre blocks after the towers."""
    monkeypatch.setattr(jtasks, "SequentialBlock", lambda *blocks: JSequential(list(blocks)))


def data(rows=STEPS * BATCH, seed=4, name="e-commerce"):
    return (jax_generate(name, num_rows=rows, seed=seed),
            mt.generate_data(name, num_rows=rows, seed=seed))


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

F_IN = 12
BLOCKS = {
    "gate": (lambda: jexperts.ExpertsGate(3, seed=2),
             lambda: texperts.ExpertsGate(3, seed=2, in_features=F_IN, device="cpu")),
    "mmoe": (lambda: jexperts.MMOEBlock(["a", "b"], (8, 6), num_experts=3),
             lambda: texperts.MMOEBlock(["a", "b"], (8, 6), in_features=F_IN, num_experts=3, device="cpu")),
    "cgc-final": (lambda: jexperts.CGCBlock(["a", "b"], (8,), num_task_experts=2,
                                            num_shared_experts=1, final_layer=True),
                  lambda: texperts.CGCBlock(["a", "b"], (8,), in_features=F_IN, num_task_experts=2,
                                            num_shared_experts=1, final_layer=True,
                                            device="cpu")),
    "cgc-shared": (lambda: jexperts.CGCBlock(["a", "b", "c"], (8,), num_shared_experts=2),
                   lambda: texperts.CGCBlock(["a", "b", "c"], (8,), in_features=F_IN,
                                             num_shared_experts=2, device="cpu")),
    "ple": (lambda: jexperts.PLEBlock(["a", "b"], (8, 6), num_layers=3, num_shared_experts=2),
            lambda: texperts.PLEBlock(["a", "b"], (8, 6), in_features=F_IN, num_layers=3,
                                      num_shared_experts=2, device="cpu")),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_forward_matches_jax(name):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((16, F_IN)).astype(np.float32)
    jmake, tmake = BLOCKS[name]
    jb, tb = jmake(), tmake()
    if name == "gate":
        experts = rng.standard_normal((16, 3, 5)).astype(np.float32)
        want = jb((jnp.asarray(x), jnp.asarray(experts)))
        mt.load_jax_params(tb, jax_params(jb))
        got = tb((torch.from_numpy(x), torch.from_numpy(experts)))
        want, got = {"out": want}, {"out": got}
    else:
        want = jb(jnp.asarray(x))
        mt.load_jax_params(tb, jax_params(jb))
        got = tb(torch.from_numpy(x))
    assert sorted(got) == sorted(want)
    if name == "cgc-shared":
        assert sorted(got) == ["a", "b", "c", "shared"]
    for key in want:
        w = np.asarray(want[key])
        np.testing.assert_allclose(got[key].detach().numpy(), w, rtol=0,
                                   atol=1e-6 * np.abs(w).max(), err_msg=key)


def _expert_weights(block):
    return [p.detach().clone() for n, p in block.named_parameters() if n.endswith("weight")
            and "gate" not in n]


@pytest.mark.parametrize("name", ["mmoe", "cgc-shared", "ple"])
def test_fresh_copies_give_experts_different_weights(name):
    """Every expert of a block, across groups and layers, starts with its
    own weights: a plain deep copy would give equal experts, which the gates
    could not tell apart."""
    block = BLOCKS[name][1]()
    by_shape = {}
    for w in _expert_weights(block):
        by_shape.setdefault(tuple(w.shape), []).append(w)
    n = 0
    for ws in by_shape.values():
        for i in range(len(ws)):
            for j in range(i):
                assert not torch.equal(ws[i], ws[j])
                n += 1
    assert n >= 3


def test_shared_output_is_read_by_no_head():
    """A CGC layer that is not final adds ``"shared"`` to its dict; a head
    picks its own target's entry, and no head is named ``shared``."""
    _, tds = data(rows=BATCH)
    tm = mt.PLEModel(tds.schema, expert_block=(8,), num_layers=1, embedding_dim=4,
                     device="cpu")
    body_out = tm.blocks[0](mt.core.types.to_device_batch(next(iter(mt.Loader(tds, 8)))[0],
                                                           "cpu"))
    assert sorted(body_out) == ["click", "conversion"]  # one layer: final
    cgc = texperts.CGCBlock(["click", "conversion"], (8,), in_features=tm.blocks[0][0].out_features,
                            device="cpu")
    out = cgc(tm.blocks[0][0](mt.core.types.to_device_batch(
        next(iter(mt.Loader(tds, 8)))[0], "cpu")))
    assert sorted(out) == ["click", "conversion", "shared"]
    preds = tm.blocks[1](out, targets=None)
    assert sorted(preds) == ["click/BinaryOutput", "conversion/BinaryOutput"]
    head = tm.blocks[1].branches["click/BinaryOutput"]
    torch.testing.assert_close(preds["click/BinaryOutput"].outputs,
                               head.to_call(out["click"]), rtol=0, atol=0)


def test_models_need_two_targets():
    _, tds = data(rows=8)
    schema = tds.schema.excluding_by_name(["conversion"])
    for make in (mt.MMOEModel, mt.PLEModel):
        with pytest.raises(ValueError, match=">= 2 TARGET"):
            make(schema, device="cpu")


# ---------------------------------------------------------------------------
# the models, trained
# ---------------------------------------------------------------------------

MODELS = {
    "mmoe": (lambda s: mm.MMOEModel(s, expert_block=(16, 8), num_experts=3, embedding_dim=8),
             lambda s: mt.MMOEModel(s, expert_block=(16, 8), num_experts=3, embedding_dim=8,
                                    device="cpu")),
    "ple": (lambda s: mm.PLEModel(s, expert_block=(16,), num_layers=2, embedding_dim=8),
            lambda s: mt.PLEModel(s, expert_block=(16,), num_layers=2, embedding_dim=8,
                                  device="cpu")),
}
CLASS_WEIGHTS = {"flat": {0: 1.0, 1: 4.0},
                 "nested": {"click": {0: 0.5, 1: 2.0}, "conversion/BinaryOutput": {1: 3.0}}}


def build_pair(kind, jds, tds, **compile_kw):
    jm, tm = MODELS[kind][0](jds.schema), MODELS[kind][1](tds.schema)
    jm.compile(**compile_kw)
    jm.build(JLoader(jds, BATCH))
    mt.load_jax_params(tm, jax_params(jm))
    tm.compile(**compile_kw)
    return jm, tm


@pytest.mark.parametrize("kind", sorted(MODELS))
@pytest.mark.parametrize("weights", sorted(CLASS_WEIGHTS))
def test_model_trains_as_jax_with_loss_and_class_weights(kind, weights, jax_bce):
    jds, tds = data()
    kw = dict(optimizer="adam", learning_rate=1e-3, loss_weights=LOSS_WEIGHTS,
              class_weight=CLASS_WEIGHTS[weights])
    jm, tm = build_pair(kind, jds, tds, **kw)
    assert tm.block_name == kind
    jh = jm.fit(jds, epochs=1, batch_size=BATCH, shuffle=False, verbose=0).history
    th = tm.fit(tds, epochs=1, batch_size=BATCH, shuffle=False, device="cpu").history
    assert tm._step == STEPS
    assert_logs_close(th, jh)
    # the weighted sum: click at 1.0, conversion at 0.5
    assert th["loss"][0] > th["loss/click/BinaryOutput"][0]
    assert_params_close(tm, jm)
    got = tm.evaluate(tds, batch_size=BATCH, device="cpu")
    want = jm.evaluate(jds, batch_size=BATCH)
    assert {"click/auc", "conversion/auc", "click/precision", "conversion/recall"} <= set(got)
    assert_logs_close(got, want)


def test_row_sparse_route_takes_loss_and_class_weights_as_jax(jax_bce):
    """Row-sparse adagrad on the tables (K7's plain version here), dense
    adagrad on the rest, with loss and class weights: three steps."""
    jds, tds = data()
    kw = dict(optimizer="adagrad", learning_rate=0.05, embedding_optimizer="adagrad",
              loss_weights=LOSS_WEIGHTS, class_weight=CLASS_WEIGHTS["nested"], metrics=[])
    jm, tm = build_pair("mmoe", jds, tds, **kw)
    jh = jm.fit(jds, epochs=1, batch_size=BATCH, shuffle=False, verbose=0).history
    th = tm.fit(tds, epochs=1, batch_size=BATCH, shuffle=False, device="cpu").history
    assert len(tm._sparse_tables) == len(tm._embedding_tables())
    assert_logs_close(th, jh)
    assert_params_close(tm, jm)


def test_a_fused_heads_loss_takes_its_weight():
    """The contrastive head's fused loss (its sample weights folded in)
    is multiplied by its loss weight in the total."""
    ds = mt.generate_data("movielens-25m", num_rows=64, seed=3)
    tm = mt.TwoTowerModel(ds.schema, query_tower=(8,), embedding_dim=8, device="cpu")
    (head,) = tm.heads()
    tm.compile(optimizer="adagrad", metrics=[], loss_weights={head.block_name: 2.5})
    h = tm.fit(ds, batch_size=32, shuffle=False, device="cpu").history
    np.testing.assert_allclose(h["loss"], 2.5 * np.asarray(h[f"loss/{head.block_name}"]),
                               rtol=1e-6)


def test_loss_weights_scale_the_total_as_jax(jax_bce):
    """evaluate's loss with one head's weight raised, in both packages."""
    jds, tds = data(rows=BATCH)
    for weights in ({"click/BinaryOutput": 1.0}, {"click/BinaryOutput": 3.0}):
        jm, tm = build_pair("mmoe", jds, tds, loss_weights=weights)
        got = tm.evaluate(tds, batch_size=BATCH, device="cpu")["loss"]
        np.testing.assert_allclose(got, jm.evaluate(jds, batch_size=BATCH)["loss"], rtol=1e-6)
    assert tm._loss_weight_for("click/BinaryOutput") == 3.0
    assert tm._loss_weight_for("conversion/BinaryOutput") == 1.0


def test_class_weight_reaches_binary_heads_only():
    from test_torch_ranking_models import ncf_schemas

    tm = mt.NCFModel(ncf_schemas()[1], embedding_dim=4, device="cpu")
    tm.compile(class_weight={0: 1.0, 1: 2.0})
    assert tm._class_weight_for("click/BinaryOutput") == (1.0, 2.0)
    assert tm._class_weight_for("rating/RegressionOutput") is None
    tm.compile(class_weight={"click": {1: 5.0}})
    tm._head_weights.clear()
    assert tm._class_weight_for("click/BinaryOutput") == (1.0, 5.0)
    assert tm._class_weight_for("rating/RegressionOutput") is None


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_graph_route_code_equals_one_step_at_a_time(kind):
    """k = 4 steps a chunk on the packed columns (two int32 target columns;
    the chunk runs eagerly on the CPU) against one step at a time, with
    loss and class weights: bit for bit."""
    _, tds = data(rows=8 * 32)
    runs = []
    for spe in (1, 4):
        tm = MODELS[kind][1](tds.schema)
        tm.compile(optimizer="adam", learning_rate=1e-3, loss_weights=LOSS_WEIGHTS,
                   class_weight={0: 1.0, 1: 4.0}, steps_per_execution=spe, jit=False)
        runs.append((tm, tm.fit(tds, epochs=2, batch_size=32, device="cpu").history))
    (a, ha), (b, hb) = runs
    pack = tds._device_train_pack
    assert pack is not None and pack.packed.shape[1] == len(tds.schema)
    assert sorted(e[1] for e in pack.spec[0] if e[0] == "y") == ["click", "conversion"]
    assert a._step == b._step == 16
    for key in ha:
        if key != "examples_per_sec":
            assert ha[key] == hb[key], key
    for (name, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), name


# ---------------------------------------------------------------------------
# the V1 prediction tasks
# ---------------------------------------------------------------------------


def v1_pair(jds, tds, task_pre=False, bias=True):
    jbody = mm.InputBlockV2(jds.schema, dim=8) >> mm.MLPBlock([16, 8])
    inputs = mt.InputBlockV2(tds.schema, dim=8, device="cpu")
    tbody = SequentialBlock([inputs, MLPBlock([16, 8], in_features=inputs.out_features, device="cpu")])
    jkw = dict(task_blocks=mm.MLPBlock([6]), task_weight_dict={"click": 1.0, "conversion": 0.5})
    tkw = dict(task_blocks=MLPBlock([6], in_features=8, device="cpu"),
               task_weight_dict={"click": 1.0, "conversion": 0.5})
    if bias:
        jkw["bias_block"] = mm.MLPBlock([4])
        tkw["bias_block"] = MLPBlock([4], in_features=8, device="cpu")
    if task_pre:
        jkw["task_pre_dict"] = {"click": mm.MLPBlock([3])}
        tkw["task_pre_dict"] = {"click": MLPBlock([3], in_features=6, device="cpu")}
    jm = mm.Model(jbody, mm.PredictionTasks(jds.schema, **jkw), schema=jds.schema)
    tm = mt.Model(tbody, mt.PredictionTasks(tds.schema, in_features=8, device="cpu", **tkw),
                  schema=tds.schema)
    return jm, tm


@pytest.mark.parametrize("case", ["bias-and-weights", "task-pre", "loss-weights-override"])
def test_prediction_tasks_train_as_jax(case, jax_bce, jax_task_pre_after_tower):
    jds, tds = data()
    jm, tm = v1_pair(jds, tds, task_pre=case == "task-pre")
    kw = dict(optimizer="adam", learning_rate=1e-3)
    if case == "loss-weights-override":
        kw["loss_weights"] = {"conversion/BinaryOutput": 2.0}
    jm.compile(**kw)
    jm.build(JLoader(jds, BATCH))
    mt.load_jax_params(tm, jax_params(jm))
    tm.compile(**kw)
    block = tm.blocks[1]
    assert isinstance(block, mt.ParallelPredictionBlock)
    assert block.task_weight_dict == {"click/BinaryOutput": 1.0, "conversion/BinaryOutput": 0.5}
    want_w = 2.0 if case == "loss-weights-override" else 0.5
    assert tm._loss_weight_for("conversion/BinaryOutput") == want_w
    if case == "task-pre":  # tower 8 -> 6, then the pre block 6 -> 3
        assert block.heads["click/BinaryOutput"].pre[-1].weight.shape == (3, 6)
    jp = jm.predict(jds, batch_size=BATCH)
    tp = tm.predict(tds, batch_size=BATCH, device="cpu")
    for key in jp:
        np.testing.assert_allclose(tp[key], np.asarray(jp[key]), atol=1e-6, err_msg=key)
    jh = jm.fit(jds, epochs=1, batch_size=BATCH, shuffle=False, verbose=0).history
    th = tm.fit(tds, epochs=1, batch_size=BATCH, shuffle=False, device="cpu").history
    assert_logs_close(th, jh)
    assert_params_close(tm, jm)


def test_cloned_task_blocks_start_apart():
    """One tower block is cloned for each task with its weights drawn anew;
    a factory is called once a task."""
    _, tds = data(rows=8)
    tasks = mt.PredictionTasks(tds.schema, in_features=8, task_blocks=MLPBlock([6], in_features=8, device="cpu"),
                               device="cpu")
    a, b = (tasks.heads[n].pre[0].weight for n in sorted(tasks.heads))
    assert a.shape == b.shape == (6, 8) and not torch.equal(a, b)
    made = []
    mt.PredictionTasks(tds.schema, in_features=8, device="cpu",
                       task_blocks=lambda: made.append(1) or MLPBlock([6], in_features=8, device="cpu"))
    assert len(made) == 2


# ---------------------------------------------------------------------------
# the next-item task
# ---------------------------------------------------------------------------

TARGET = "item_id_seq"


def next_item_pair(form, jds, tds):
    """``inputs -> GPT2 -> project -> NextItemPredictionTask`` in both."""
    jin = JSequential([mm.InputBlockV2(jds.schema.excluding_by_tag(mm.Tags.TARGET), dim=8,
                                       aggregation=None), JConcat()])
    jtable = jfind_table(jin, "item_id_seq")
    jbody = JSequential([jin, jtb.GPT2Block(d_model=16, n_head=2, n_layer=1, dropout=0.0)])
    tin = mt.InputBlockV2(tds.schema, dim=8, aggregation=None, device="cpu")
    ttable = tfind_table(tin, "item_id_seq")
    tr = ttb.GPT2Block(d_model=16, n_head=2, n_layer=1, dropout=0.0, device="cpu")
    tr.set_in_features(tin.out_features, "cpu")
    tbody = SequentialBlock([tin, TConcat(), tr])
    if form == "dense":
        # the dense head takes the hidden states' values: neither package's
        # Dense takes a SequenceFeature (ROADMAP.md queue 3)
        jtask = mm.NextItemPredictionTask(jds.schema, weight_tying=False)
        ttask = mt.NextItemPredictionTask(tds.schema, weight_tying=False, in_features=16,
                                          device="cpu")
        return (mm.Model(jbody, JLambda(_values), jtask),
                mt.Model(tbody, TValues(), ttask))
    kw = dict(sampled_softmax=form == "sampled", num_sampled=12)
    jtask = mm.NextItemPredictionTask(jds.schema, table=jtable, **kw)
    ttask = mt.NextItemPredictionTask(tds.schema, table=ttable, **kw)
    return (mm.Model(jbody, JProject(jtable.dim), jtask),
            mt.Model(tbody, TProject(16, ttable.dim, device="cpu"), ttask))


def _values(x):
    return x.values


class TValues(torch.nn.Module):
    def forward(self, x, **kwargs):
        return x.values


def jax_draws(tsampler, jsampler):
    """The port's popularity sampler given the JAX sampler's ids and
    probabilities, step by step (``tests/test_torch_retrieval_zoo.py``)."""
    calls = []
    tsampler.sampling_probs = lambda ids, max_id: torch.from_numpy(np.array(
        jsampler.sampling_probs(jnp.asarray(ids.numpy()), max_id))).to(ids.device)

    def sample_ids(n, max_id, device):
        key = jax.random.fold_in(jax.random.key(jsampler.seed), len(calls))
        calls.append(None)
        return torch.from_numpy(np.array(jsampler._zipf_sample(key, n, max_id))).to(device)

    tsampler.sample_ids = sample_ids
    return calls


@pytest.mark.parametrize("form", ["tied", "dense", "sampled"])
def test_next_item_task_trains_as_jax(form):
    jds, tds = data(rows=STEPS * 16, name="sequence-testing")
    jm, tm = next_item_pair(form, jds, tds)
    head = tm.blocks[-1]
    if form == "sampled":
        assert isinstance(head, ContrastiveOutput) and head.tying.table is head.table
        (sampler,) = head.samplers
        assert isinstance(sampler, PopularityBasedSampler)
        assert (sampler.max_num_samples, sampler.max_id) == (12, 100)
    else:
        assert isinstance(head, mt.outputs.CategoricalOutput) and head.num_classes == 101
        assert (form == "tied") == (head.to_call.__class__.__name__ == "EmbeddingTablePrediction")
    kw = dict(optimizer="adagrad", learning_rate=0.05, metrics=[])
    jm.compile(**kw)
    jpre = jseq.SequencePredictNext(jds.schema, TARGET)
    jm.build(JLoader(jds, 16))
    mt.load_jax_params(tm, jax_params(jm))
    tm.compile(**kw)
    calls = []
    if form == "sampled":
        calls = jax_draws(tm.blocks[-1].samplers[0], jm.blocks[-1].samplers[0])
    jh = jm.fit(jds, batch_size=16, shuffle=False, verbose=0, pre=jpre).history
    th = tm.fit(tds, batch_size=16, shuffle=False, device="cpu",
                pre=tseq.SequencePredictNext(tds.schema, TARGET)).history
    assert len(calls) == (STEPS if form == "sampled" else 0)
    assert_logs_close(th, jh)
    assert_params_close(tm, jm, rtol=1e-4, atol=1e-6)
