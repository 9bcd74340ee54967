"""The port's engine breadth against the JAX package's, on the CPU: the
optimizers adamw, rmsprop, lamb and adafactor (against optax), the
``MultiOptimizer``, frozen blocks, ``fit(steps_per_epoch=, callbacks=)``,
the ``InBatchNegatives`` transform and ``ModelBlock``.

Tolerances, each with its reason:

- an optimizer against optax, three steps on the same parameters and
  gradients: each parameter within 1e-6 of its largest magnitude (float32
  updates a few ulps apart, rounded into the parameter), each slot within
  rtol 1e-5 (a moment's bias correction and EMA in another order);
- models trained by both packages (MMOE on ``e-commerce``, three steps of
  64): losses rtol 1e-5, parameters atol 1e-5, as
  ``tests/test_torch_multi_task.py`` (whose ``jax_bce`` reasoning holds
  here too).
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

import models_tpu as mm
import models_tpu.losses as jlosses
from models_tpu.blocks.optimizer import MultiOptimizer as JMultiOptimizer
from models_tpu.data import Loader as JLoader
from models_tpu.data import generate_data as jax_generate
from models_tpu.transforms.negative_sampling import InBatchNegatives as JInBatchNegatives

import models_tpu_torch as mt
from models_tpu_torch.blocks.optimizer import (SGD, Adafactor, Adagrad, Adam, LowPrecisionState,
                                               MultiStep, factored_dims,
                                               low_precision_optimizer_state,
                                               make_optimizer, param_path)
from models_tpu_torch.core.types import to_device_batch, to_device_targets
from models_tpu_torch.utils import callbacks as cbs

BATCH, STEPS = 64, 3
OPTIMIZERS = ["adafactor", "adamw", "lamb", "rmsprop"]
SHAPES = [(256, 128), (130, 3), (8, 4), (5,)]


def _bce_softplus(labels, logits, sample_weight=None):
    labels = labels.reshape(logits.shape).astype(logits.dtype)
    return jlosses._weighted_mean(jax.nn.softplus(logits) - logits * labels, sample_weight)


@pytest.fixture
def jax_bce(monkeypatch):
    monkeypatch.setitem(jlosses.loss_registry._store, "binary_crossentropy", _bce_softplus)


# ---------------------------------------------------------------------------
# the optimizers against optax
# ---------------------------------------------------------------------------


def _schedule(count):
    return 1e-2 * 0.5 ** count


def _three_steps_against_optax(name, rate):
    """Three steps of ``make_optimizer(name)`` and of ``optax.<name>`` on
    parameters of 2-D (one of them (256, 128): adafactor factors it), 1-D
    and a zero row, with the same gradients (one parameter's gradient
    missing on the port's side at the second step: optax sees zeros); the
    parameters within 1e-6 of their scale after each. Returns (the port's
    optimizer, its parameters, optax's state)."""
    rng = np.random.default_rng(3)
    ws = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    ws[2][0] = 0.0
    tx = getattr(optax, name)(rate)
    jp = [jnp.asarray(w) for w in ws]
    state = tx.init(jp)
    ps = [torch.from_numpy(w.copy()).requires_grad_() for w in ws]
    opt = make_optimizer(name, ps, rate)
    for step in range(3):
        gs = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
        if step == 1:
            gs[3][:] = 0.0
        updates, state = tx.update([jnp.asarray(g) for g in gs], state, jp)
        jp = optax.apply_updates(jp, updates)
        for i, (p, g) in enumerate(zip(ps, gs)):
            p.grad = None if (step == 1 and i == 3) else torch.from_numpy(g)
        opt.step()
        for p, want in zip(ps, jp):
            want = np.asarray(want)
            np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                       atol=1e-6 * np.abs(want).max(), err_msg=f"step {step}")
    return opt, ps, state


@pytest.mark.parametrize("name", OPTIMIZERS)
@pytest.mark.parametrize("lr", ["constant", "schedule"])
def test_optimizer_matches_optax(name, lr):
    """The chains against optax (:func:`_three_steps_against_optax`), and
    their second moments and step counts after."""
    opt, ps, state = _three_steps_against_optax(name, 1e-2 if lr == "constant" else _schedule)
    if name == "adafactor":
        big = opt.state[ps[0]]
        assert factored_dims(SHAPES[0]) == (1, 0) and factored_dims(SHAPES[1]) is None
        assert sorted(k for k in big if k != "step") == ["v_col", "v_row"]
        assert big["v_row"].shape == (128,) and big["v_col"].shape == (256,)
        inner = state[0]
        np.testing.assert_allclose(big["v_row"].numpy(), np.asarray(inner.v_row[0]), rtol=1e-5)
        np.testing.assert_allclose(big["v_col"].numpy(), np.asarray(inner.v_col[0]), rtol=1e-5)
    else:
        inner = state[0]
        jnu = np.asarray(inner.nu[0])
        np.testing.assert_allclose(opt.state[ps[0]]["nu"].numpy(), jnu, rtol=1e-5, atol=1e-12)
    assert all(int(opt.state[p]["step"]) == 3 for p in ps)


def test_lamb_trust_ratio_holds_on_a_million_elements():
    """One lamb update (the chain's, before it is added) on a (1024, 1024)
    parameter within 1e-6 of its largest magnitude of optax's Adam
    direction times the trust ratio taken in float64: the ratio's norms are
    sums of squares, where torch's float32 ``vector_norm`` on the CPU is
    9e-6 off at this size (and 1% on the Ali-CCP item table's 98.5M
    elements)."""
    rng = np.random.default_rng(8)
    w = (rng.standard_normal((1024, 1024)) * 0.05).astype(np.float32)
    g = rng.standard_normal((1024, 1024)).astype(np.float32)
    p = torch.from_numpy(w.copy())
    opt = make_optimizer("lamb", [p], 1.0)
    got = opt._update(p, torch.from_numpy(g), opt.state[p], 1.0).numpy()
    adam = optax.scale_by_adam(eps=1e-6)
    u = np.asarray(adam.update(jnp.asarray(g), adam.init(jnp.asarray(w)))[0]).astype(np.float64)
    want = -u * np.sqrt((w.astype(np.float64) ** 2).sum()) / np.sqrt((u * u).sum())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_adafactor_leaves_small_and_one_dimensional_parameters_unfactored():
    """At the MMOE's widths nothing is factored: tables 32 wide, the first
    expert kernel (672, 64)."""
    assert factored_dims((3078312, 32)) is None
    assert factored_dims((64, 672)) is None
    assert factored_dims((128, 128)) == (0, 1)
    ps = [torch.zeros(64, 672, requires_grad=True)]
    assert sorted(Adafactor(ps, 1e-3).state[ps[0]]) == ["step", "v"]


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_under_low_precision_state(name):
    """bf16 slots at rest between steps, the step count untouched; the
    update within 2e-2 of the float32 optimizer's (the JAX package's bound
    for its bf16 updates)."""
    rng = np.random.default_rng(5)
    w0 = rng.standard_normal((8, 4)).astype(np.float32)
    p = torch.from_numpy(w0.copy()).requires_grad_()
    ref = torch.from_numpy(w0.copy()).requires_grad_()
    opt = low_precision_optimizer_state(make_optimizer(name, [p], 1e-2), "bfloat16")
    plain = make_optimizer(name, [ref], 1e-2)
    assert isinstance(opt, LowPrecisionState)
    for _ in range(3):
        g = torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32))
        p.grad, ref.grad = g.clone(), g.clone()
        opt.step()
        plain.step()
    slots = {k: v for k, v in opt.state[p].items() if k != "step"}
    assert slots and all(v.dtype == torch.bfloat16 for v in slots.values())
    assert opt.state[p]["step"].dtype == torch.int32 and int(opt.state[p]["step"]) == 3
    np.testing.assert_allclose(p.detach().numpy(), ref.detach().numpy(), rtol=0, atol=2e-2 * 3e-2)


@pytest.mark.parametrize("name,lr", [("adagrad", "constant"), ("adagrad", "schedule"),
                                     ("sgd", "constant"), ("sgd", "schedule"),
                                     ("adam", "schedule")])
def test_adagrad_sgd_and_scheduled_adam_match_optax(name, lr):
    """adagrad and sgd, one class each whatever the rate, and adam with a
    schedule (its chain) against optax; a schedule's step count on the
    parameters, none for a number rate."""
    opt, ps, state = _three_steps_against_optax(name, 1e-2 if lr == "constant" else _schedule)
    assert type(opt) is {"adagrad": Adagrad, "sgd": SGD, "adam": Adam}[name]
    if name == "adagrad":
        np.testing.assert_allclose(opt.state[ps[0]]["sum"].numpy(),
                                   np.asarray(state[0].sum_of_squares[0]), rtol=1e-6)
    steps = [st.get("step") for st in opt.state.values()]
    if lr == "schedule":
        assert all(int(s) == 3 for s in steps) and len(steps) == len(ps)
    else:
        assert steps == [None] * len(steps)


def test_callable_learning_rate_is_refused_where_it_is_not_taken():
    # adam, adagrad and sgd take a schedule too; only an unknown optimizer
    # is refused
    for name, cls in (("adam", Adam), ("adagrad", Adagrad), ("sgd", SGD)):
        assert type(make_optimizer(name, [torch.zeros(2, requires_grad=True)],
                                   _schedule)) is cls
    with pytest.raises(ValueError, match="Unknown optimizer"):
        make_optimizer("adadelta", [torch.zeros(2, requires_grad=True)], 0.1)


# ---------------------------------------------------------------------------
# models: MultiOptimizer, freezing
# ---------------------------------------------------------------------------


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


def data(rows=STEPS * BATCH, seed=4):
    return (jax_generate("e-commerce", num_rows=rows, seed=seed),
            mt.generate_data("e-commerce", num_rows=rows, seed=seed))


def mmoe_pair(jds, tds):
    jm = mm.MMOEModel(jds.schema, expert_block=(16,), num_experts=2, embedding_dim=8)
    tm = mt.MMOEModel(tds.schema, expert_block=(16,), num_experts=2, embedding_dim=8,
                      device="cpu")
    jm.compile()
    jm.build(JLoader(jds, BATCH))
    mt.load_jax_params(tm, jax_params(jm))
    return jm, tm


def fit_both(jm, tm, jds, tds, epochs=1):
    jh = jm.fit(jds, epochs=epochs, batch_size=BATCH, shuffle=False, verbose=0).history
    th = tm.fit(tds, epochs=epochs, batch_size=BATCH, shuffle=False, device="cpu").history
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5)
    want, got = jax_params(jm), port_params(tm)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=0, atol=1e-5, err_msg=key)
    return jh, th


@pytest.mark.parametrize("selector", ["regex", "block"])
def test_multi_optimizer_matches_jax(selector, jax_bce):
    """The tables by regex (adagrad at 0.05), or the gates' block (sgd at
    0.1); everything else Adam at 1e-3."""
    jds, tds = data()
    jm, tm = mmoe_pair(jds, tds)
    if selector == "regex":
        jrule, trule = ("table", optax.adagrad(0.05)), ("table", ("adagrad", 0.05))
    else:
        jrule = (jm.blocks[0].layers[1].gates, optax.sgd(0.1))
        trule = (tm.blocks[0].layers[1].gates, ("sgd", 0.1))
    jm.compile(optimizer=JMultiOptimizer(default=optax.adam(1e-3), rules=[jrule]),
               metrics=[])
    tm.compile(optimizer=mt.MultiOptimizer(default=("adam", 1e-3), rules=[trule]), metrics=[])
    fit_both(jm, tm, jds, tds)
    assert isinstance(tm._optimizer, MultiStep)
    kinds = sorted(type(o).__name__ for o in tm._optimizer.optimizers.values())
    assert kinds == (["Adagrad", "Adam"] if selector == "regex" else ["Adam", "SGD"])
    with pytest.raises(ValueError, match="MultiOptimizer"):
        tm.compile(optimizer=mt.MultiOptimizer(), optimizer_state_dtype="bfloat16")


def test_regex_sees_the_jax_state_paths():
    _, tds = data(rows=8)
    tm = mt.MMOEModel(tds.schema, expert_block=(16,), num_experts=2, embedding_dim=8,
                      device="cpu")
    paths = {param_path(n) for n, _ in tm.named_parameters()}
    assert "blocks/0/layers/1/gates/click/gate/kernel" in paths
    assert "blocks/0/layers/0/branches/categorical/branches/item_id/table" in paths


def test_frozen_experts_match_jax_and_keep_no_slots(jax_bce):
    """Frozen experts: both packages' fits leave them, train the rest alike,
    and the port's optimizer holds no slot of theirs."""
    jds, tds = data()
    jm, tm = mmoe_pair(jds, tds)
    jm.freeze_blocks(jm.blocks[0].layers[1].experts)
    tm.freeze_blocks(tm.blocks[0].layers[1].experts)
    for m in (jm, tm):
        m.compile(optimizer="adam", learning_rate=1e-3, metrics=[])
    experts = tm.blocks[0].layers[1].experts
    before = {n: p.detach().clone() for n, p in experts.named_parameters()}
    gates = [p.detach().clone() for p in tm.blocks[0].layers[1].gates.parameters()]
    fit_both(jm, tm, jds, tds)
    for n, p in experts.named_parameters():
        assert torch.equal(p, before[n]), n
    assert all(not torch.equal(a, b) for a, b in
               zip(gates, tm.blocks[0].layers[1].gates.parameters()))
    frozen = {id(p) for p in experts.parameters()}
    assert not frozen & {id(p) for p in tm._optimizer.state}
    assert tm.frozen_blocks() == [experts]


def test_unfreeze_trains_again_without_recompile(jax_bce):
    """Frozen, then unfrozen: the second fit moves the block, with fresh
    slots and step 0 (the JAX package rebuilds its transform), as JAX's."""
    jds, tds = data()
    jm, tm = mmoe_pair(jds, tds)
    for m in (jm, tm):
        m.compile(optimizer="adam", learning_rate=1e-3, metrics=[])
        m.freeze_blocks("MLPBlock")
    assert len(tm.frozen_blocks()) == 2  # both experts, by name
    fit_both(jm, tm, jds, tds)
    frozen_state = tm._optimizer
    jm.unfreeze_all_frozen_blocks()
    tm.unfreeze_all_frozen_blocks()
    before = [p.detach().clone() for p in tm.blocks[0].layers[1].experts.parameters()]
    fit_both(jm, tm, jds, tds)
    assert tm._optimizer is not frozen_state and tm._step == STEPS
    assert all(not torch.equal(a, b) for a, b in
               zip(before, tm.blocks[0].layers[1].experts.parameters()))
    kept = tm._optimizer
    fit_both(jm, tm, jds, tds)  # plain after plain: the slots carry on
    assert tm._optimizer is kept and tm._step == 2 * STEPS


def test_frozen_row_sparse_table_takes_no_update():
    _, tds = data()
    tm = mt.MMOEModel(tds.schema, expert_block=(16,), num_experts=2, embedding_dim=8,
                      device="cpu")
    tm.compile(optimizer="adagrad", learning_rate=0.05, embedding_optimizer="adagrad",
               metrics=[])
    tables = {t.block_name: t for t in tm._embedding_tables()}
    tm.freeze_blocks(tables["item_id"])
    frozen = tables["item_id"].table.detach().clone()
    other = tables["user_id"].table.detach().clone()
    tm.fit(tds, batch_size=BATCH, shuffle=False, device="cpu")
    assert tables["item_id"] in tm._sparse_tables
    assert torch.equal(tables["item_id"].table, frozen)
    assert torch.equal(tables["item_id"].sparse_slots["acc"],
                       torch.full_like(frozen, 0.1))
    assert not torch.equal(tables["user_id"].table, other)


# ---------------------------------------------------------------------------
# fit(steps_per_epoch=, callbacks=)
# ---------------------------------------------------------------------------


class Recorder(cbs.Callback):
    def __init__(self):
        self.calls = []

    def on_epoch_begin(self, epoch):
        self.calls.append(("begin", epoch))

    def on_batch_end(self, step, logs):
        self.calls.append(("batch", step, sorted(logs)))

    def on_epoch_end(self, epoch, logs):
        self.calls.append(("end", epoch, "loss" in logs))

    def on_train_end(self, history):
        self.calls.append(("train_end", len(history["loss"])))


@pytest.mark.parametrize("route", ["plain", "chunked", "host-chunks", "bucket"])
def test_steps_per_epoch_bounds_every_route(route):
    """5 batches an epoch of 8 (the bucket groups' together); with k = 2
    a chunk, on_batch_end comes after each chunk and the leftover step."""
    if route == "bucket":
        ds = mt.generate_data("sequence-testing", num_rows=8 * 16, seed=2,
                              min_session_length=1, max_session_length=4)
        model = mt.SessionBasedTransformerModel(
            ds.schema, transformer=mt.transformer.GPT2Block(d_model=8, n_head=2, n_layer=1,
                                                            dropout=0.0, device="cpu"),
            embedding_dim=8, device="cpu")
        data = mt.Loader(ds, 16, pad="bucket", drop_last=True)
        pre = mt.transforms.SequencePredictNext(ds.schema, target="item_id_seq")
    else:
        ds = mt.generate_data("e-commerce", num_rows=8 * 16, seed=2)
        model = mt.MMOEModel(ds.schema, expert_block=(8,), num_experts=2, embedding_dim=4,
                             device="cpu")
        data = (mt.Loader(ds, 16, drop_last=False) if route == "host-chunks"
                else mt.Loader(ds, 16, drop_last=True))
        pre = None
    spe = 1 if route == "plain" else 2
    model.compile(optimizer="adam", metrics=[], steps_per_execution=spe, jit=False)
    rec = Recorder()
    hist = model.fit(data, epochs=2, steps_per_epoch=5, callbacks=[rec], pre=pre, device="cpu")
    assert model._step == 10 and len(hist.history["loss"]) == 2
    if route == "bucket":
        assert ds._device_bucket_groups is not None
    elif route == "chunked":
        assert ds._device_train_pack is not None
    first = rec.calls[:rec.calls.index(("end", 0, True))]
    batches = [c[1] for c in first if c[0] == "batch"]
    assert rec.calls[0] == ("begin", 0) and rec.calls[-1] == ("train_end", 2)
    assert batches == ([0, 1, 2, 3, 4] if spe == 1 else [1, 3, 4])
    assert ("end", 0, True) in rec.calls and ("begin", 1) in rec.calls
    assert all("loss" in c[2] for c in rec.calls if c[0] == "batch")


def test_callbacks_stop_training_and_log(tmp_path):
    ds = mt.generate_data("e-commerce", num_rows=64, seed=1)
    model = mt.MMOEModel(ds.schema, expert_block=(8,), num_experts=2, embedding_dim=4,
                         device="cpu")
    model.compile(optimizer="adam", metrics=[])

    class StopNow(cbs.Callback):
        def on_epoch_end(self, epoch, logs):
            self.model.stop_training = True

    assert len(model.fit(ds, epochs=3, batch_size=16, callbacks=[StopNow()],
                         device="cpu").history["loss"]) == 1
    # the flag is reset at the next fit
    assert len(model.fit(ds, epochs=2, batch_size=16, device="cpu").history["loss"]) == 2
    early = cbs.EarlyStopping(monitor="loss", patience=1, mode="max")
    log = tmp_path / "log.csv"
    rates = []
    eps = cbs.ExamplesPerSecondCallback(16, every_n_steps=2, log_fn=rates.append)
    hist = model.fit(ds, epochs=5, batch_size=16, device="cpu",
                     callbacks=[early, cbs.CSVLogger(str(log)), eps])
    assert len(hist.history["loss"]) == 2  # the loss fell: no gain in "max" for one epoch
    rows = list(csv.reader(open(log)))
    assert rows[0][0] == "epoch" and "loss" in rows[0] and len(rows) == 3
    assert len(eps.history) == len(rates) == 4

    class NaNLoss(cbs.Callback):
        def on_epoch_end(self, epoch, logs):
            logs["loss"] = float("nan")

    assert len(model.fit(ds, epochs=3, batch_size=16, device="cpu",
                         callbacks=[NaNLoss(), cbs.TerminateOnNaN()]).history["loss"]) == 1


# ---------------------------------------------------------------------------
# InBatchNegatives, ModelBlock
# ---------------------------------------------------------------------------


def test_in_batch_negatives_match_jax_with_its_draws():
    jds, tds = data(rows=32)
    jt = JInBatchNegatives(jds.schema, n_per_positive=2, seed=5)
    tt = mt.InBatchNegatives(tds.schema, n_per_positive=2, seed=5, device="cpu")
    x, y = next(iter(JLoader(jds, 32)))
    x, y = ({k: np.array(v) for k, v in x.items()}, {k: np.array(v) for k, v in y.items()})
    from models_tpu.core.types import ModelContext as JContext
    from models_tpu.core.types import to_device_batch as jdevice

    jx, jy = jt(jdevice(x), targets={k: jnp.asarray(v) for k, v in y.items()},
                context=JContext(step=3), training=True)
    key = jax.random.fold_in(jax.random.key(5), jnp.asarray(3, jnp.uint32))
    draws = np.array(jax.random.randint(key, (2, 32), 0, 32))
    tt.draw = lambda B, device: torch.from_numpy(draws).long()
    tx, ty = tt(to_device_batch(x, "cpu"), targets=to_device_targets(y, "cpu"), training=True)
    assert sorted(tx) == sorted(jx) and sorted(ty) == sorted(jy)
    for k in jx:
        assert tx[k].shape[0] == 96
        np.testing.assert_array_equal(tx[k].numpy(), np.asarray(jx[k]), err_msg=k)
    for k in jy:
        np.testing.assert_array_equal(ty[k].numpy(), np.asarray(jy[k]), err_msg=k)
        assert not ty[k][32:].any()
    item = [c.name for c in tds.schema if "item" in c.tags]
    user = tx["user_id"].numpy()
    assert item and np.array_equal(user[32:64], user[:32])
    # evaluation leaves the batch as it is
    same = tt(to_device_batch(x, "cpu"), targets=to_device_targets(y, "cpu"), training=False)
    assert same[0]["item_id"].shape[0] == 32


def test_in_batch_negatives_train_a_model():
    _, tds = data(rows=4 * 32)
    tm = mt.MMOEModel(tds.schema, expert_block=(8,), num_experts=2, embedding_dim=4,
                      device="cpu")
    tm.compile(optimizer="adam", metrics=[])
    h = tm.fit(tds, batch_size=32, pre=mt.InBatchNegatives(tds.schema, device="cpu"),
               device="cpu")
    assert np.isfinite(h.history["loss"][0]) and tm._step == 4


def test_model_block_trains_any_block():
    _, tds = data(rows=64)
    inputs = mt.InputBlockV2(tds.schema, dim=4, device="cpu")
    body = mt.core.SequentialBlock([inputs, mt.MLPBlock([8], in_features=inputs.out_features,
                                                        device="cpu")])
    model = mt.ModelBlock(body, mt.OutputBlock(tds.schema, in_features=8, device="cpu"),
                          schema=tds.schema)
    assert isinstance(model, mt.BaseModel) and isinstance(model, mt.Model)
    assert model.schema is tds.schema
    assert mt.ModelBlock(body).schema is body.schema
    model.compile(optimizer="lamb", learning_rate=1e-2, metrics=[])
    h = model.fit(tds, batch_size=16, device="cpu")
    assert np.isfinite(h.history["loss"][0]) and model._step == 4
