"""The port's flash sampled-softmax CE (models_tpu_torch.ops.flash_ce and
.contrastive) and its contrastive head against the JAX package, on the CPU.

The same seeded numpy inputs go to both. The Pallas kernels run in interpret
mode, as tests/unit/test_ops.py runs them; the port's kernel wrappers take
their plain versions on CPU tensors. Tolerances: rtol 1e-5 on (m, s) and the
loss; rtol 2e-4, atol 1e-7 on gradients (fp32 sums over other tile orders),
as test_ops.py uses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import models_tpu.ops.contrastive as jcontrastive
from models_tpu.ops import flash_ce as jflash

import models_tpu_torch as mt
from models_tpu_torch.core.constants import MIN_FLOAT
from models_tpu_torch.core.types import ModelContext, to_device_batch, to_device_targets
from models_tpu_torch.data import Loader
from models_tpu_torch.ops import contrastive as tcontrastive
from models_tpu_torch.ops import flash_ce as tflash

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-7


def _inputs(seed, Q, N, D, bias_kind, zero_weights):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((Q, D)) * 0.3).astype(np.float32)
    pos = (rng.standard_normal((Q, D)) * 0.3).astype(np.float32)
    neg = (rng.standard_normal((N, D)) * 0.3).astype(np.float32)
    pid = rng.integers(0, 12, Q).astype(np.int32)  # few ids: many duplicates
    nid = rng.integers(0, 12, N).astype(np.int32)
    bias = None
    if bias_kind == "min":
        bias = (rng.standard_normal(N) * 0.1).astype(np.float32)
        bias[::5] = MIN_FLOAT  # invalid negatives, as the head marks them
    w = rng.uniform(0.3, 1.0, Q).astype(np.float32)
    if zero_weights:
        w[::4] = 0.0
    return q, pos, neg, pid, nid, bias, w


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# (N, downscore, bias, T): N a tile multiple and not; each option on and off
KERNEL_CASES = [
    (40, True, "min", 0.7),
    (37, False, None, 1.0),
    (37, True, None, 0.7),
    (40, False, "min", 1.0),
]


# D = 20 is no multiple of the card kernels' k-step of 8: they pad it
@pytest.mark.parametrize("D", [16, 20])
@pytest.mark.parametrize("N,downscore,bias_kind,T", KERNEL_CASES)
def test_plain_kernels_match_pallas_interpret(N, downscore, bias_kind, T, D):
    Q = 20
    q, pos, _, pid, nid, bias, w = _inputs(0, Q, N, D, bias_kind, zero_weights=True)
    neg = np.random.default_rng(1).standard_normal((N, D)).astype(np.float32) * 0.3
    pos_logit = (q * pos).sum(1).astype(np.float32) / np.float32(T)
    ids = (pid, nid) if downscore else (None, None)
    jm, js = jflash.lse_forward(_j(q), _j(pos_logit), _j(neg), _j(ids[0]), _j(ids[1]),
                                _j(bias), T, downscore, tq=8, tn=16, interpret=True)
    before = (tflash.lse_forward.launches, tflash.grad_query.launches, tflash.grad_neg.launches)
    tm, ts = tflash.lse_forward(_t(q), _t(pos_logit), _t(neg), _t(ids[0]), _t(ids[1]),
                                _t(bias), T, downscore)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=LOSS_RTOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=LOSS_RTOL)

    lse = (np.asarray(jm) + np.log(np.asarray(js))).astype(np.float32)
    gw = (w / w.sum()).astype(np.float32)
    args_j = (_j(q), _j(neg), _j(lse), _j(gw), _j(ids[0]), _j(ids[1]), _j(bias), T, downscore)
    args_t = (_t(q), _t(neg), _t(lse), _t(gw), _t(ids[0]), _t(ids[1]), _t(bias), T, downscore)
    jdq = jflash.grad_query(*args_j, tq=8, tn=16, interpret=True)
    jdn = jflash.grad_neg(*args_j, tq=8, tn=16, interpret=True)
    np.testing.assert_allclose(tflash.grad_query(*args_t).numpy(), np.asarray(jdq),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(tflash.grad_neg(*args_t).numpy(), np.asarray(jdn),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    # CPU tensors never reach a kernel
    assert before == (tflash.lse_forward.launches, tflash.grad_query.launches,
                      tflash.grad_neg.launches)


def test_wrappers_refuse_bf16_and_mismatched_operands():
    q = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="mixed-precision"):
        tflash.lse_forward(q.bfloat16(), torch.zeros(4), q, None, None, None, 1.0, False)
    with pytest.raises(ValueError, match="width"):
        tflash.grad_neg(q, torch.zeros(5, 7), torch.zeros(4), torch.zeros(4), None, None,
                        None, 1.0, False)
    with pytest.raises(ValueError, match="int32"):
        tflash.grad_query(q, q, torch.zeros(4), torch.zeros(4), torch.zeros(4),
                          torch.zeros(4, dtype=torch.int32), None, 1.0, True)


# (bias, weights, ids, alias pos and neg, T)
LOSS_CASES = {
    "plain": (False, False, False, False, 1.0),
    "logq-biases": (True, False, False, False, 0.7),
    "weights-with-zeros": (False, True, False, False, 1.0),
    "duplicate-ids": (False, True, True, False, 0.7),
    "in-batch-alias": (True, True, True, True, 0.7),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_sampled_softmax_loss_matches_jax_value_and_grad(case):
    with_bias, with_weights, with_ids, alias, T = LOSS_CASES[case]
    Q, N, D = 24, 24 if alias else 37, 16
    q, pos, neg, pid, nid, _, w = _inputs(3, Q, N, D, None, zero_weights=True)
    if alias:
        neg, nid = pos, pid  # in-batch: the positives are the negatives
    rng = np.random.default_rng(4)
    neg_bias = (rng.standard_normal(N) * 0.2).astype(np.float32) if with_bias else None
    pos_bias = (rng.standard_normal(Q) * 0.2).astype(np.float32) if with_bias else None
    weights = w if with_weights else None
    ids = (pid, nid) if with_ids else (None, None)

    def jloss(q_, pos_, neg_):
        neg_ = pos_ if alias else neg_
        return jcontrastive.sampled_softmax_loss(
            q_, pos_, neg_, _j(ids[0]), _j(ids[1]), _j(weights), _j(neg_bias), T, 8,
            pos_bias=_j(pos_bias))

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(_j(q), _j(pos), _j(neg))
    tq, tpos = _t(q).requires_grad_(), _t(pos).requires_grad_()
    tneg = tpos if alias else _t(neg).requires_grad_()
    tl = tcontrastive.sampled_softmax_loss(tq, tpos, tneg, _t(ids[0]), _t(ids[1]),
                                           _t(weights), _t(neg_bias), T, pos_bias=_t(pos_bias))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jg[0]), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    # aliased: the positive and negative gradients sum into one tensor
    np.testing.assert_allclose(tpos.grad.numpy(), np.asarray(jg[1]), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    if not alias:
        np.testing.assert_allclose(tneg.grad.numpy(), np.asarray(jg[2]), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
    if weights is not None:  # zero-weight rows give exactly zero d_query and d_pos
        dead = weights == 0
        assert not tq.grad.numpy()[dead].any()
        if not alias:
            assert not tpos.grad.numpy()[dead].any()


def _model_and_batch(name, n_valid, **kw):
    ds = mt.generate_data(name, num_rows=n_valid, seed=7)
    model = mt.TwoTowerModel(ds.schema, device="cpu", **kw)
    x, y = next(iter(Loader(ds, 48)))  # n_valid < 48: a padded tail batch
    return model, to_device_batch(x, "cpu"), to_device_targets(y, "cpu")


def _step_grads(model, x, y, fused):
    model.contrastive_output.fused_loss = "auto" if fused else False
    model.zero_grad(set_to_none=True)
    model.compile(optimizer="sgd", metrics=[])
    context = ModelContext(features=x, targets=y, step=0, need_logits=False)
    preds = model(x, targets=y, training=True, context=context)
    total, _ = model._compute_losses(model._as_pred_dict(preds), x,
                                     model._resolve_task_losses())
    total.backward()
    return float(total.detach()), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("name,kw", [
    ("e-commerce", dict(query_tower=(16, 8))),
    ("movielens-25m", dict(query_tower=(16, 8), embedding_dim=8, logits_temperature=0.7)),
])
def test_contrastive_output_fused_matches_unfused(name, kw):
    """Fused loss (K1-K3's plain versions) vs materialised logits + dense CE:
    equal loss and tower gradients, with padded rows and duplicate item ids."""
    model, x, y = _model_and_batch(name, 40, **kw)
    item = model.item_id_name
    x[item][5] = x[item][2]  # a planted duplicate positive
    assert not x["__row_valid__"].all()
    fused_loss, fused = _step_grads(model, x, y, fused=True)
    plain_loss, plain = _step_grads(model, x, y, fused=False)
    np.testing.assert_allclose(fused_loss, plain_loss, rtol=LOSS_RTOL)
    for n in plain:
        np.testing.assert_allclose(fused[n].numpy(), plain[n].numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=n)
