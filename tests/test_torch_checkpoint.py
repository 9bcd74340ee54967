"""Step checkpoints and exact training resume (``models_tpu_torch/utils/
checkpoint.py``, ``BaseModel.training_state`` / ``arm_training_state``,
``fit(initial_epoch=)``) on the CPU.

A two-tower model trains four epochs of eight steps, unshuffled, in one
``fit``; a second copy trains two of them with ``ModelCheckpoint``; a fresh
model, compiled alike, resumes from the checkpoint through
``CheckpointManager.restore_training`` and ``fit(initial_epoch=2)``. The
resumed run's losses, parameters, buffers, row-sparse slots, dense
optimizer state and step count equal the uninterrupted run's bit for bit,
for ``adam`` under a warmup-cosine schedule (optax's formula, written in
torch ops below), ``adagrad``, ``adam`` with bf16 slots, row-sparse
``adagrad`` on bf16 tables, and three steps a chunk
(``steps_per_execution``: two chunks and two single steps an epoch).

Against the JAX package: the port's ``adam`` with that schedule (a function
of the device step) and JAX's with ``optax.warmup_cosine_decay_schedule``,
the MMOE trained by both on the same rows and parameters: losses within
rtol 1e-5 and parameters within atol 1e-5, the tolerances of
``tests/test_torch_engine_breadth.py`` (fp32 sums in another order over a
few steps); and ``initial_epoch``, ``validation_freq`` and
``validation_steps`` give JAX's history keys and lengths.
"""

import math
import os

import jax
import numpy as np
import optax
import pytest
import torch
from flax import nnx

import models_tpu as mm
import models_tpu.losses as jlosses
from models_tpu.data import Loader as JLoader

import models_tpu_torch as mt
from models_tpu_torch.utils.checkpoint import CheckpointManager, ModelCheckpoint
from models_tpu_torch.utils.io import model_state

CPU = dict(device="cpu")
BATCH = 64


def warmup_cosine(init: float, peak: float, warmup: int, decay: int, end: float = 0.0):
    """optax.warmup_cosine_decay_schedule in torch ops on the step tensor."""
    def schedule(step):
        s = step.to(torch.float32)
        warm = (init - peak) * (1 - torch.clamp(s, 0, warmup) / warmup) + peak
        c = torch.clamp(s - warmup, 0, decay - warmup)
        cos = 0.5 * (1 + torch.cos(math.pi * c / (decay - warmup)))
        alpha = end / peak
        return torch.where(s < warmup, warm, peak * ((1 - alpha) * cos + alpha))

    return schedule


CASES = {
    "adam_warmup_cosine": dict(optimizer="adam", learning_rate=warmup_cosine(0.0, 0.05, 4, 24)),
    "adagrad": dict(optimizer="adagrad", learning_rate=0.05),
    "adam_bf16_slots": dict(optimizer="adam", learning_rate=1e-3,
                            optimizer_state_dtype="bfloat16"),
    "row_sparse_bf16_tables": dict(optimizer="adagrad", learning_rate=0.05,
                                   embedding_optimizer="adagrad"),
    "steps_per_execution": dict(optimizer="adagrad", learning_rate=0.05, steps_per_execution=3),
}


@pytest.fixture(scope="module")
def data():
    return mt.generate_data("movielens-25m", num_rows=512, seed=7)


def make(ds, case):
    bf16 = case == "row_sparse_bf16_tables"
    model = mt.TwoTowerModel(ds.schema, query_tower=(16, 8), embedding_dim=8,
                             table_dtype=torch.bfloat16 if bf16 else None, **CPU)
    model.compile(metrics=[], **CASES[case])
    return model


def opt_tensors(model):
    state = model.training_state()["opt_state"]
    return {(i, n): v for i, slots in state.items() for n, v in slots.items()
            if torch.is_tensor(v)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_resumed_run_is_the_uninterrupted_run_bit_for_bit(case, data, tmp_path):
    whole = make(data, case)
    hw = whole.fit(data, epochs=4, batch_size=BATCH, shuffle=False, **CPU)
    first = make(data, case)
    first.fit(data, epochs=2, batch_size=BATCH, shuffle=False,
              callbacks=[ModelCheckpoint(str(tmp_path), max_to_keep=1)], **CPU)
    manager = CheckpointManager(str(tmp_path))
    assert manager.all_steps() == [1] and manager.latest_step() == 1
    resumed = make(data, case)
    step = manager.restore_training(resumed, data=data, **CPU)
    assert step == 1 and resumed._step == 16
    hr = resumed.fit(data, epochs=4, initial_epoch=step + 1, batch_size=BATCH, shuffle=False,
                     **CPU)
    assert hr.history["loss"] == hw.history["loss"][2:]
    assert resumed._step == whole._step == 32
    want, got = model_state(whole), model_state(resumed)
    assert list(got) == list(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype and torch.equal(got[key], value), key
    if case == "row_sparse_bf16_tables":
        assert sum(".sparse_slots." in k for k in got) == len(resumed._sparse_tables) > 0
        assert {t.table.dtype for t in resumed._sparse_tables} == {torch.bfloat16}
    want, got = opt_tensors(whole), opt_tensors(resumed)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype and torch.equal(got[key], value), key
    if case == "adam_bf16_slots":
        assert {v.dtype for (_, n), v in got.items() if n != "step"} == {torch.bfloat16}


def test_the_manager_keeps_the_newest_and_restores_weights_alone(data, tmp_path):
    model = make(data, "adagrad")
    cb = ModelCheckpoint(str(tmp_path), every_n_epochs=1, max_to_keep=2)
    model.fit(data, epochs=3, batch_size=BATCH, shuffle=False, callbacks=[cb], **CPU)
    manager = CheckpointManager(str(tmp_path))
    assert manager.all_steps() == [1, 2]
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]
    fresh = make(data, "adagrad")
    step, opt_state = manager.restore(fresh, **CPU)
    assert step == 2 and opt_state is not None
    for key, value in model_state(model).items():
        assert torch.equal(model_state(fresh)[key], value), key
    assert manager.save(3, fresh) and 3 in manager.all_steps()
    with pytest.raises(ValueError, match="no optimizer state"):
        manager.restore_training(make(data, "adagrad"), step=3, **CPU)
    multi = mt.TwoTowerModel(data.schema, query_tower=(16, 8), embedding_dim=8, **CPU)
    multi.compile(optimizer=mt.MultiOptimizer(default="adam", rules=[("table", "adagrad")]),
                  metrics=[])
    # a MultiOptimizer run checkpoints (its optimizers' states by rule) ...
    multi.fit(data, batch_size=BATCH, shuffle=False, **CPU,
              callbacks=[ModelCheckpoint(str(tmp_path / "multi"))])
    step, opt_state = CheckpointManager(str(tmp_path / "multi")).restore(multi, **CPU)
    assert step == 0 and sorted(opt_state) == [-1, 0]
    # ... and does not resume: its optimizers are made anew each fit
    with pytest.raises(ValueError, match="MultiOptimizer"):
        manager.restore_training(multi, **CPU)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(fresh, **CPU)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def _bce_softplus(labels, logits, sample_weight=None):
    labels = labels.reshape(logits.shape).astype(logits.dtype)
    return jlosses._weighted_mean(jax.nn.softplus(logits) - logits * labels, sample_weight)


@pytest.fixture
def jax_bce(monkeypatch):
    """The JAX binary heads trained with ``softplus(x) - x y`` (the gradient
    at a zero logit: ``tests/test_torch_ranking_models.py``)."""
    monkeypatch.setitem(jlosses.loss_registry._store, "binary_crossentropy", _bce_softplus)


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


def mmoe_pair(rows=192, seed=4):
    jds = mm.generate_data("e-commerce", num_rows=rows, seed=seed)
    tds = mt.generate_data("e-commerce", num_rows=rows, seed=seed)
    jm = mm.MMOEModel(jds.schema, expert_block=(16,), num_experts=2, embedding_dim=8)
    tm = mt.MMOEModel(tds.schema, expert_block=(16,), num_experts=2, embedding_dim=8, **CPU)
    jm.build(JLoader(jds, BATCH))
    mt.load_jax_params(tm, jax_params(jm))
    return jm, tm, jds, tds


def test_the_schedule_trains_as_optax_warmup_cosine(jax_bce):
    jm, tm, jds, tds = mmoe_pair()
    # peak 1e-3, adam's default rate (the regime of the engine breadth test's
    # tolerance: adam scales a gradient of rounding noise up to the rate)
    jm.compile(optimizer="adam",
               learning_rate=optax.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 6))
    tm.compile(optimizer="adam", learning_rate=warmup_cosine(0.0, 1e-3, 2, 6))
    jh = jm.fit(jds, epochs=2, batch_size=BATCH, shuffle=False, verbose=0).history
    th = tm.fit(tds, epochs=2, batch_size=BATCH, shuffle=False, **CPU).history
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5)
    want, got = jax_params(jm), port_params(tm)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=0, atol=1e-5, err_msg=key)
    steps = torch.arange(32, dtype=torch.int32)
    np.testing.assert_allclose(
        warmup_cosine(0.0, 0.05, 4, 24)(steps).numpy(),
        np.asarray(optax.warmup_cosine_decay_schedule(0.0, 0.05, 4, 24)(np.arange(32))),
        rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("name", ["adagrad", "sgd"])
def test_adagrad_and_sgd_schedules_train_as_optax_warmup_cosine(name, jax_bce):
    """adagrad and sgd on a warmup-cosine rate (peak 0.05) against the JAX
    package's optax ones, at the tolerances of the adam case above; the
    step count the schedule read kept on the parameters."""
    jm, tm, jds, tds = mmoe_pair()
    jm.compile(optimizer=name,
               learning_rate=optax.warmup_cosine_decay_schedule(0.0, 0.05, 2, 6))
    tm.compile(optimizer=name, learning_rate=warmup_cosine(0.0, 0.05, 2, 6))
    jh = jm.fit(jds, epochs=2, batch_size=BATCH, shuffle=False, verbose=0).history
    th = tm.fit(tds, epochs=2, batch_size=BATCH, shuffle=False, **CPU).history
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5)
    want, got = jax_params(jm), port_params(tm)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=0, atol=1e-5, err_msg=key)
    assert {int(st["step"]) for st in tm._optimizer.state.values()} == {tm._step}


def test_initial_epoch_and_validation_give_the_jax_history(jax_bce):
    jm, tm, jds, tds = mmoe_pair()
    jm.compile(optimizer="adagrad", learning_rate=0.05)
    tm.compile(optimizer="adagrad", learning_rate=0.05)
    kw = dict(epochs=5, initial_epoch=2, batch_size=BATCH, shuffle=False, validation_freq=2,
              validation_steps=1)
    jh = jm.fit(jds, validation_data=jds, verbose=0, **kw).history
    th = tm.fit(tds, validation_data=tds, **CPU, **kw).history
    assert sorted(th) == sorted(jh)
    assert {k: len(v) for k, v in th.items()} == {k: len(v) for k, v in jh.items()}
    assert len(th["loss"]) == 3 and len(th["val_loss"]) == 1
    np.testing.assert_allclose(th["val_loss"], jh["val_loss"], rtol=1e-5)
    with pytest.raises(ValueError, match="initial_epoch"):
        tm.fit(tds, epochs=2, initial_epoch=2, batch_size=BATCH, **CPU)
