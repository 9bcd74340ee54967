"""The ranking slice's losses and metrics against the JAX package's, on the
CPU, on the same seeded logits, targets and weights.

Losses within rtol 1e-6. Metrics: the JAX update runs jitted, as its train
and eval steps run it; each state after two updates within rtol 1e-6 (the
AUC's confusion counts are float32 sums of 0/1 weights, exact below 2**24:
equal), each result within 1e-6. The AUC's thresholds equal the jitted
``jnp.linspace`` bit for bit. torch's sigmoid and XLA's differ by up to 2
ulps on about 0.4% of logits, so a probability that close to a threshold
may count on its other side: the counts' tolerance is one per such
probability.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import models_tpu.losses as jlosses
import models_tpu.metrics.base as jmetrics

import models_tpu_torch as mt
import models_tpu_torch.losses as tlosses
import models_tpu_torch.metrics.base as tmetrics

B = 512


def batch(seed=0, weighted=True, scale=2.0):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, 1)) * scale).astype(np.float32)
    labels = rng.integers(0, 2, size=B).astype(np.int32)
    weights = (rng.random(B) < 0.9).astype(np.float32) if weighted else None
    return logits, labels, weights


def regression_batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 1)).astype(np.float32),
            rng.standard_normal(B).astype(np.float32), rng.random(B).astype(np.float32))


def t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("name", ["binary_crossentropy", "bce", "mse", "mean_squared_error",
                                  "mae", "mean_absolute_error"])
@pytest.mark.parametrize("weighted", [False, True])
def test_losses_match_jax(name, weighted):
    if name in ("binary_crossentropy", "bce"):
        logits, labels, w = batch(1, weighted)
    else:
        logits, labels, w = regression_batch(1)
        w = w if weighted else None
    got = tlosses.get_loss(name)(t(labels), t(logits), t(w))
    want = jlosses.get_loss(name)(j(labels), j(logits), j(w))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_bce_gradient_at_zero_logits():
    """``sigmoid(0) - y``: the port's gradient of a zero logit. The JAX
    form's is ``-y`` there (it takes ``|x|``'s derivative at 0 as 1; see
    ``tests/test_torch_ranking_models.py``); elsewhere the two agree."""
    labels = np.array([0, 1, 0, 1], np.int32)
    logits = np.array([[0.0], [0.0], [0.3], [-1.2]], np.float32)
    x = t(logits).requires_grad_()
    tlosses.binary_crossentropy(t(labels), x).backward()
    right = (1 / (1 + np.exp(-logits[:, 0])) - labels) / 4
    np.testing.assert_allclose(x.grad[:, 0].numpy(), right, rtol=1e-6)
    jgrad = np.asarray(jax.grad(lambda v: jlosses.binary_crossentropy(j(labels), v))(j(logits)))
    np.testing.assert_allclose(jgrad[2:, 0], right[2:], rtol=1e-6)
    np.testing.assert_allclose(jgrad[:2, 0], -labels[:2] / 4, rtol=1e-6)


def test_auc_thresholds_are_jax_bit_for_bit():
    want = np.asarray(jax.jit(lambda: jnp.linspace(0.0 - 1e-7, 1.0 + 1e-7, 200))())
    got = tmetrics.auc_thresholds(200)
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    th = tmetrics.AUC().thresholds("cpu")
    assert th.dtype == torch.float32 and np.array_equal(th.numpy(), got)


METRICS = {
    "binary_accuracy": (tmetrics.BinaryAccuracy, jmetrics.BinaryAccuracy, batch),
    "precision": (tmetrics.Precision, jmetrics.Precision, batch),
    "recall": (tmetrics.Recall, jmetrics.Recall, batch),
    "auc": (tmetrics.AUC, jmetrics.AUC, batch),
    "logloss": (tmetrics.LogLoss, jmetrics.LogLoss, batch),
    "rmse": (tmetrics.RMSE, jmetrics.RMSE, regression_batch),
    "mae": (tmetrics.MAE, jmetrics.MAE, regression_batch),
}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_matches_jax(name):
    tcls, jcls, make = METRICS[name]
    tm, jm = tcls(), jcls()
    assert tm.name == jm.name == name
    tstate, jstate = tm.init_state("cpu"), jm.init_state()
    jupdate = jax.jit(jm.update)
    for seed in (2, 3):
        out, target, w = make(seed)
        tstate = tm.update(tstate, t(out), t(target), sample_weight=t(w))
        jstate = jupdate(jstate, j(out), j(target), j(w))
    assert sorted(tstate) == sorted(jstate)
    for key in jstate:
        np.testing.assert_allclose(tstate[key].numpy(), np.asarray(jstate[key]), rtol=1e-6,
                                   err_msg=key)
    np.testing.assert_allclose(tm.result(tstate).item(), float(jm.result(jstate)), rtol=1e-6,
                               atol=1e-7)


def test_auc_counts_on_probabilities_at_thresholds():
    """Logits whose sigmoid lands on or next to each threshold: the counts
    differ only by the probabilities that the two sigmoids round apart, each
    at most one count (the thresholds are far apart against an ulp)."""
    th = tmetrics.auc_thresholds(200)[1:-1].astype(np.float64)
    logits = np.log(th / (1 - th)).astype(np.float32)[:, None]
    labels = (np.arange(len(logits)) % 2).astype(np.int32)
    tstate = tmetrics.AUC().update(tmetrics.AUC().init_state("cpu"), t(logits), t(labels))
    jstate = jax.jit(jmetrics.AUC().update)(jmetrics.AUC().init_state(), j(logits), j(labels))
    apart = int((torch.sigmoid(t(logits)).numpy()
                 != np.asarray(jax.jit(jax.nn.sigmoid)(j(logits)))).sum())
    flips = sum(int(np.abs(tstate[k].numpy() - np.asarray(jstate[k])).sum()) for k in ("tp", "fp"))
    assert flips <= apart < len(logits) // 20


def test_metric_names_resolve_and_heads_take_their_defaults():
    for name in ("auc", "precision", "recall", "binary_accuracy", "logloss", "rmse", "mae"):
        assert mt.Metric.parse(name).name == name
    head = mt.BinaryOutput("label", in_features=4, device="cpu")
    assert [m.name for m in head.default_metrics()] == [
        "label/binary_accuracy", "label/precision", "label/recall", "label/auc"]
    assert head.default_loss == "binary_crossentropy"
    reg = mt.RegressionOutput("rating", in_features=4, device="cpu")
    assert [m.name for m in reg.default_metrics()] == ["rating/rmse"]
    logits = torch.tensor([[0.0], [2.0]])
    assert torch.allclose(head.activation(logits), torch.sigmoid(logits[:, 0]))
    assert reg.activation(logits).shape == (2,)
