"""The port's mixed precision (the ``mixed_bfloat16`` policy, bf16 optimizer
slots, the bf16 forms of the flash-CE kernels) against the JAX package's, on
the CPU.

The same seeded numpy inputs go to both, each package under its own
``set_dtype_policy("mixed_bfloat16")``, restored to ``float32`` in a
``finally``: the policy is global in both. bf16 operands are rounded from the
same float32 arrays (round to nearest even on both sides). The Pallas kernels
run in interpret mode; the port's wrappers take their plain versions, which
widen bf16 operands to float32 (bf16 products are exact there). Tolerances,
each with its reason:

- Dense: rtol 1e-6, atol 1e-7 (fp32 sums of exact products in another order);
- K1-K3 and the loss: rtol 1e-5 on (m, s) and the loss, rtol 2e-4 / atol
  1e-7 on the float32 gradients, as the float32 forms are held. A cotangent
  returned in bf16 is the float32 one rounded, and two float32 values a few
  ulps apart round one bf16 ulp apart where they straddle a rounding
  boundary: such elements may differ by one bf16 ulp, at most 1% of them (``assert_bf16_rounded_close``);
- fit trajectories: losses rtol 1e-5, parameters atol 1e-5 (see
  ``test_mixed_fit_trajectory_matches_jax``);
- bf16 optimizer slots: adagrad's equal to JAX's bit for bit and its
  updates within rtol 1e-6 (the port's adagrad is optax's formula); Adam's
  (torch's, whose bias corrections are float64 where optax's are float32,
  7e-6 apart on the update) within the JAX package's own bound, rtol 2e-2,
  atol 1e-3.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

import models_tpu.ops.contrastive as jcontrastive
from models_tpu.blocks.mlp import Dense as JDense
from models_tpu.blocks.optimizer import low_precision_optimizer_state as jlow_precision
from models_tpu.core import policy as jpolicy
from models_tpu.data import Loader as JLoader
from models_tpu.data import generate_data as jax_generate
from models_tpu.models import TwoTowerModel as JTwoTowerModel
from models_tpu.ops import flash_ce as jflash

import models_tpu_torch as mt
from models_tpu_torch.blocks.mlp import Dense
from models_tpu_torch.blocks.optimizer import LowPrecisionState, low_precision_optimizer_state
from models_tpu_torch.blocks.optimizer import make_optimizer
from models_tpu_torch.core import policy as tpolicy
from models_tpu_torch.core.constants import MIN_FLOAT
from models_tpu_torch.ops import contrastive as tcontrastive
from models_tpu_torch.ops import flash_ce as tflash
from models_tpu_torch.ops.topk import ids_agree

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-7


@contextlib.contextmanager
def mixed_policy():
    """Both packages under ``mixed_bfloat16``; float32 again afterwards."""
    jpolicy.set_dtype_policy("mixed_bfloat16")
    tpolicy.set_dtype_policy("mixed_bfloat16")
    try:
        yield
    finally:
        jpolicy.set_dtype_policy("float32")
        tpolicy.set_dtype_policy("float32")


def _bf16(a):
    """(jax, torch) bf16 copies of one float32 numpy array, the same bits."""
    j, t = jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(np.asarray(a)).bfloat16()
    np.testing.assert_array_equal(np.asarray(j).view(np.int16), t.view(torch.int16).numpy())
    return j, t


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _np32(x):
    return np.asarray(x.detach().float() if torch.is_tensor(x) else jnp.asarray(x, jnp.float32))


def assert_bf16_rounded_close(got, want, err_msg=""):
    """Within rtol 2e-4 / atol 1e-7, but for at most 1% of the elements,
    which may be one bf16 ulp (of the larger) apart: the rounding of float32
    values a few ulps apart to bf16."""
    got, want = _np32(got), _np32(want)
    diff = np.abs(got - want)
    off = diff > GRAD_ATOL + GRAD_RTOL * np.abs(want)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(got), np.abs(want)) + 1e-45)) - 7)
    assert (diff[off] <= ulp[off]).all(), (err_msg, diff[off].max() / ulp[off].max())
    assert off.sum() <= 0.01 * off.size, (err_msg, int(off.sum()))


# ---------------------------------------------------------------------------
# the policy and the Dense layer
# ---------------------------------------------------------------------------


def test_policy_api_matches_jax():
    assert mt.get_dtype_policy() == jpolicy.get_dtype_policy() == "float32"
    assert tpolicy.compute_dtype() == torch.float32
    x = torch.ones(3)
    assert tpolicy.cast_compute(x) is x
    for bad in ("float16", "mixed_float16", "bfloat16"):
        with pytest.raises(ValueError) as tex:
            mt.set_dtype_policy(bad)
        with pytest.raises(ValueError) as jex:
            jpolicy.set_dtype_policy(bad)
        assert str(tex.value) == str(jex.value)
    assert mt.get_dtype_policy() == "float32"
    with mixed_policy():
        assert mt.get_dtype_policy() == jpolicy.get_dtype_policy() == "mixed_bfloat16"
        assert tpolicy.compute_dtype() == torch.bfloat16
        assert tpolicy.cast_compute(x).dtype == torch.bfloat16
        assert tpolicy.cast_compute(x.double()).dtype == torch.bfloat16
        for keep in (torch.arange(3, dtype=torch.int32), torch.arange(3), x > 0, 3.0, None):
            assert tpolicy.cast_compute(keep) is keep
            assert jpolicy.cast_compute(keep if not torch.is_tensor(keep) else None) is (
                keep if not torch.is_tensor(keep) else None)
        ids = jnp.arange(3, dtype=jnp.int32)
        assert jpolicy.cast_compute(ids) is ids
    assert mt.get_dtype_policy() == "float32"


@pytest.mark.parametrize("activation", [None, "relu"])
def test_dense_matches_jax_under_the_policy(activation):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((33, 40)).astype(np.float32)
    jd = JDense(24, activation=activation)
    with mixed_policy():
        jd(jnp.asarray(x))  # builds the kernel
        kernel = np.asarray(jd.kernel.value)
        bias = rng.standard_normal(24).astype(np.float32)
        jd.bias.value = jnp.asarray(bias)
        want = np.asarray(jd(jnp.asarray(x)))
        td = Dense(24, activation=activation, in_features=40, device="cpu")
        with torch.no_grad():
            td.weight.copy_(torch.from_numpy(kernel.T.copy()))
            td.bias.copy_(torch.from_numpy(bias))
        tx = torch.from_numpy(x).requires_grad_()
        got = td(tx)
        assert got.dtype == torch.float32 and want.dtype == np.float32
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-7)

        # the gradients pass through the bf16 casts, as JAX's do
        jgm, jgx = nnx.grad(lambda m, xx: jnp.sum(m(xx) ** 2), argnums=(0, 1))(
            jd, jnp.asarray(x))
        (got ** 2).sum().backward()
    np.testing.assert_allclose(td.weight.grad.numpy().T, np.asarray(jgm.kernel.value),
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=2e-4, atol=1e-6)
    # outside the policy the same layer runs in float32
    np.testing.assert_allclose(td(torch.from_numpy(x)).detach().numpy(),
                               np.maximum(x @ kernel + bias, 0) if activation else x @ kernel + bias,
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the bf16 forms of K1-K3 and the loss
# ---------------------------------------------------------------------------


def _inputs(seed, Q, N, D, bias_kind, zero_weights):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((Q, D)) * 0.3).astype(np.float32)
    pos = (rng.standard_normal((Q, D)) * 0.3).astype(np.float32)
    neg = (rng.standard_normal((N, D)) * 0.3).astype(np.float32)
    pid = rng.integers(0, 12, Q).astype(np.int32)
    nid = rng.integers(0, 12, N).astype(np.int32)
    bias = None
    if bias_kind == "min":
        bias = (rng.standard_normal(N) * 0.1).astype(np.float32)
        bias[::5] = MIN_FLOAT
    w = rng.uniform(0.3, 1.0, Q).astype(np.float32)
    if zero_weights:
        w[::4] = 0.0
    return q, pos, neg, pid, nid, bias, w


KERNEL_CASES = [
    (40, True, "min", 0.7),
    (37, False, None, 1.0),
    (37, True, None, 0.7),
]


@pytest.mark.parametrize("D", [16, 20])
@pytest.mark.parametrize("N,downscore,bias_kind,T", KERNEL_CASES)
def test_plain_bf16_kernels_match_pallas_interpret(N, downscore, bias_kind, T, D):
    Q = 20
    q, pos, neg, pid, nid, bias, w = _inputs(0, Q, N, D, bias_kind, zero_weights=True)
    (jq, tq), (jn, tn), (_, tpos) = _bf16(q), _bf16(neg), _bf16(pos)
    pos_logit = ((tq.float() * tpos.float()).sum(1) / T).numpy()
    ids = (pid, nid) if downscore else (None, None)
    jm, js = jflash.lse_forward(jq, _j(pos_logit), jn, _j(ids[0]), _j(ids[1]), _j(bias), T,
                                downscore, tq=8, tn=16, interpret=True)
    before = {f: (f.launches, f.launches_bf16)
              for f in (tflash.lse_forward, tflash.grad_query, tflash.grad_neg)}
    tm, ts = tflash.lse_forward(tq, _t(pos_logit), tn, _t(ids[0]), _t(ids[1]), _t(bias), T,
                                downscore)
    assert tm.dtype == ts.dtype == torch.float32
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=LOSS_RTOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=LOSS_RTOL)

    lse = (np.asarray(jm) + np.log(np.asarray(js))).astype(np.float32)
    gw = (w / w.sum()).astype(np.float32)
    rest_j = (_j(lse), _j(gw), _j(ids[0]), _j(ids[1]), _j(bias), T, downscore)
    rest_t = (_t(lse), _t(gw), _t(ids[0]), _t(ids[1]), _t(bias), T, downscore)
    jdq = jflash.grad_query(jq, jn, *rest_j, tq=8, tn=16, interpret=True)
    jdn = jflash.grad_neg(jq, jn, *rest_j, tq=8, tn=16, interpret=True)
    dq, dn = tflash.grad_query(tq, tn, *rest_t), tflash.grad_neg(tq, tn, *rest_t)
    assert dq.dtype == dn.dtype == torch.float32
    np.testing.assert_allclose(dq.numpy(), np.asarray(jdq), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(dn.numpy(), np.asarray(jdn), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    # CPU tensors never reach a kernel, in either form
    assert before == {f: (f.launches, f.launches_bf16)
                      for f in (tflash.lse_forward, tflash.grad_query, tflash.grad_neg)}


# (bias, weights, ids, alias, T); alias "leaf": the bf16 positives are the
# negatives; "cast": one float32 source cast twice, each cast on its own
LOSS_CASES = {
    "plain": (False, False, False, None, 1.0),
    "logq-biases": (True, False, False, None, 0.7),
    "duplicate-ids-weights": (False, True, True, None, 0.7),
    "in-batch-alias": (True, True, True, "leaf", 0.7),
    "in-batch-alias-cast": (True, True, True, "cast", 0.7),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_bf16_sampled_softmax_loss_matches_jax_value_and_grad(case):
    with_bias, with_weights, with_ids, alias, T = LOSS_CASES[case]
    Q, D = 24, 16
    N = Q if alias else 37
    q, pos, neg, pid, nid, _, w = _inputs(3, Q, N, D, None, zero_weights=True)
    if alias:
        nid = pid
    rng = np.random.default_rng(4)
    neg_bias = (rng.standard_normal(N) * 0.2).astype(np.float32) if with_bias else None
    pos_bias = (rng.standard_normal(Q) * 0.2).astype(np.float32) if with_bias else None
    weights = w if with_weights else None
    ids = (pid, nid) if with_ids else (None, None)

    def jloss(q_, pos_, neg_):
        if alias == "cast":  # float32 primals, each operand cast on its own
            q_, neg_, pos_ = (jpolicy.cast_compute(a) for a in (q_, pos_, pos_))
        elif alias == "leaf":
            neg_ = pos_
        return jcontrastive.sampled_softmax_loss(
            q_, pos_, neg_, _j(ids[0]), _j(ids[1]), _j(weights), _j(neg_bias), T, 8,
            pos_bias=_j(pos_bias))

    with mixed_policy():
        if alias == "cast":
            jargs = (_j(q), _j(pos), _j(pos))
            tq, tpos = _t(q).requires_grad_(), _t(pos).requires_grad_()
            tl = tcontrastive.sampled_softmax_loss(
                tpolicy.cast_compute(tq), tpolicy.cast_compute(tpos), tpolicy.cast_compute(tpos),
                _t(ids[0]), _t(ids[1]), _t(weights), _t(neg_bias), T, pos_bias=_t(pos_bias))
            leaves, dtype = (tq, tpos), torch.float32
        else:
            (jq, tq), (jp, tpos), (jn, tneg) = _bf16(q), _bf16(pos), _bf16(neg)
            jargs = (jq, jp, jp if alias else jn)
            tq.requires_grad_(), tpos.requires_grad_(), tneg.requires_grad_()
            tl = tcontrastive.sampled_softmax_loss(
                tq, tpos, tpos if alias else tneg, _t(ids[0]), _t(ids[1]), _t(weights),
                _t(neg_bias), T, pos_bias=_t(pos_bias))
            leaves, dtype = (tq, tpos) if alias else (tq, tpos, tneg), torch.bfloat16
        jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(*jargs)
        tl.backward()
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_RTOL)
    for i, leaf in enumerate(leaves):
        assert leaf.grad.dtype == dtype, (i, leaf.grad.dtype)
        assert np.asarray(jg[i]).dtype == np.dtype(jnp.dtype(dtype == torch.bfloat16
                                                              and jnp.bfloat16 or jnp.float32))
        # aliased: the positive and negative cotangents sum into one
        assert_bf16_rounded_close(leaf.grad, jg[i], err_msg=f"argument {i}")


# ---------------------------------------------------------------------------
# the bf16 optimizer slots
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["adagrad", "adam"])
def test_low_precision_optimizer_state_matches_jax(name):
    """Slots bf16 at rest after every step; adagrad's equal to JAX's bit for
    bit and each update within rtol 1e-6 of JAX's; Adam's updates and slots
    within rtol 2e-2, atol 1e-3 (the JAX package's own bound for its bf16
    updates against its fp32 ones) and its step count untouched."""
    rtol, atol = (1e-6, 1e-7) if name == "adagrad" else (2e-2, 1e-3)
    rng = np.random.default_rng(1)
    w0 = rng.standard_normal((8, 4)).astype(np.float32)
    grads = [rng.standard_normal((8, 4)).astype(np.float32) * 0.5 for _ in range(4)]
    jtx = jlow_precision(optax.adagrad(0.1) if name == "adagrad" else optax.adam(0.1),
                         "bfloat16")
    jparams = {"w": jnp.asarray(w0)}
    jstate = jtx.init(jparams)
    p = torch.from_numpy(w0.copy()).requires_grad_()
    opt = low_precision_optimizer_state(make_optimizer(name, [p], 0.1), "bfloat16")
    assert isinstance(opt, LowPrecisionState) and opt.state_dtype == torch.bfloat16
    for t, g in enumerate(grads, 1):
        ju, jstate = jtx.update({"w": jnp.asarray(g)}, jstate, jparams)
        jparams = optax.apply_updates(jparams, ju)
        before = p.detach().clone()
        p.grad = torch.from_numpy(g.copy())
        opt.step()
        np.testing.assert_allclose((p.detach() - before).numpy(), np.asarray(ju["w"]),
                                   rtol=rtol, atol=atol, err_msg=f"step {t}")
        state = opt.state[p]
        jslots = [x for x in jax.tree.leaves(jstate) if jnp.issubdtype(x.dtype, jnp.floating)]
        slots = [state[k] for k in ("sum",)] if name == "adagrad" else [
            state["exp_avg"], state["exp_avg_sq"]]
        assert len(slots) == len(jslots)
        for got, want in zip(slots, jslots):
            assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
            if name == "adagrad":
                np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                              np.asarray(want).view(np.int16), err_msg=f"step {t}")
            else:
                np.testing.assert_allclose(_np32(got), _np32(want), rtol=rtol, atol=atol)
        if name == "adam":
            assert state["step"].dtype == torch.float32 and float(state["step"]) == t


@pytest.mark.parametrize("name", ["adagrad", "adam"])
def test_low_precision_slots_live_in_one_flat_tensor(name):
    """The slots at rest are views of one flat bf16 tensor (a step casts them
    up in one copy and back in another), equal bit for bit to those of the
    same optimizer whose slots are rounded to bf16 one by one before each
    step, as are the parameters; slots that ``load_state_dict`` replaces are
    packed anew at the next step."""
    rng = np.random.default_rng(2)
    w0 = [rng.standard_normal(shape).astype(np.float32) for shape in ((8, 4), (5,), (3, 2, 2))]
    ps = [torch.from_numpy(w.copy()).requires_grad_() for w in w0]
    refs = [torch.from_numpy(w.copy()).requires_grad_() for w in w0]
    opt = low_precision_optimizer_state(make_optimizer(name, ps, 0.1), "bfloat16")
    ref = make_optimizer(name, refs, 0.1)

    def floating(state):
        return {k: v for k, v in state.items() if k != "step" and v.is_floating_point()}

    for t in range(4):
        if t == 2:
            opt.load_state_dict(opt.state_dict())
            assert all(v.dtype == torch.float32 for st in opt.state.values()
                       for v in floating(st).values())
        for st in ref.state.values():
            st.update({k: v.to(torch.bfloat16).float() for k, v in floating(st).items()})
        for p, r in zip(ps, refs):
            g = torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
            p.grad, r.grad = g, g.clone()
        opt.step()
        ref.step()
        storage = opt._rest.untyped_storage().data_ptr()
        for p, r in zip(ps, refs):
            np.testing.assert_array_equal(p.detach().numpy(), r.detach().numpy())
            slots, want = floating(opt.state[p]), floating(ref.state[r])
            assert slots.keys() == want.keys() and slots
            for k, v in slots.items():
                assert v.dtype == torch.bfloat16 and v.untyped_storage().data_ptr() == storage
                np.testing.assert_array_equal(v.view(torch.int16).numpy(),
                                              want[k].to(torch.bfloat16).view(torch.int16).numpy())


def test_optimizer_state_dtype_is_checked_at_compile():
    ds = mt.generate_data("e-commerce", num_rows=8, seed=0)
    model = mt.TwoTowerModel(ds.schema, query_tower=(8,), device="cpu")
    with pytest.raises(ValueError, match="floating"):
        model.compile("adagrad", optimizer_state_dtype="int8")
    model.compile("adagrad", optimizer_state_dtype=torch.bfloat16)
    assert model._optimizer_state_dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the model under the policy: fit trajectories, serving
# ---------------------------------------------------------------------------


def jax_flat(model, kind=nnx.Param):
    return {"/".join(str(p) for p in path): np.asarray(var[...])
            for path, var in nnx.state(model, kind).flat_state()}


def build_pair(name, num_rows, seed, tkw=None, **kw):
    jds = jax_generate(name, num_rows=num_rows, seed=seed)
    tds = mt.generate_data(name, num_rows=num_rows, seed=seed)
    jm = JTwoTowerModel(jds.schema, **kw)
    jm.compile()
    jm.build(JLoader(jds, 64))
    tm = mt.TwoTowerModel(tds.schema, device="cpu", **{**kw, **(tkw or {})})
    mt.load_jax_params(tm, jax_flat(jm))
    return jds, tds, jm, tm


def jax_noise(shape, salt, step, device):
    """The stochastic-rounding bits the JAX package draws for (salt, step)."""
    key = jax.random.fold_in(jax.random.key(salt), jnp.asarray(step, jnp.uint32))
    bits = np.asarray(jax.random.bits(key, tuple(shape), jnp.uint32)).view(np.int32)
    return torch.from_numpy(bits.copy()).to(device)


SMALL = dict(query_tower=(16, 8), embedding_dim=8)
FIT_CASES = {
    "adagrad": ("movielens-25m", {}, None),
    "adagrad-bf16-slots": ("movielens-25m", dict(optimizer_state_dtype="bfloat16"), None),
    "e-commerce-adagrad-bf16-slots": ("e-commerce", dict(optimizer_state_dtype="bfloat16"),
                                      None),
    "bf16-tables-sparse-adagrad": ("movielens-25m", dict(embedding_optimizer="adagrad"),
                                   "bfloat16"),
    "unfused": ("movielens-25m", {}, None),
}


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_mixed_fit_trajectory_matches_jax(case):
    """Two epochs of batches of 64 under ``mixed_bfloat16`` from the same
    weights. The two packages round the same float32 values to bf16, but
    their float32 sums run in other orders, and an activation whose float32
    values straddle a bf16 rounding boundary rounds one bf16 ulp apart:
    losses within rtol 1e-5, parameters within atol 1e-5 (measured: 1.2e-7
    and 3.1e-7 at most over these cases)."""
    name, ckw, table_dtype = FIT_CASES[case]
    kw = dict(SMALL, **({"embedding_dim": 8} if name == "movielens-25m" else {}))
    if name == "e-commerce":
        kw = dict(query_tower=(16, 8))
    jkw = dict(kw, table_dtype=getattr(jnp, table_dtype)) if table_dtype else kw
    tkw = dict(table_dtype=getattr(torch, table_dtype)) if table_dtype else {}
    jds, tds, jm, tm = build_pair(name, 300, 13, tkw=tkw, **jkw)
    if case == "unfused":  # the logits branch: contrastive_logits under the policy
        jm.contrastive_output.fused_loss = tm.contrastive_output.fused_loss = False
    with mixed_policy():
        for m in (jm, tm):
            m.compile(optimizer="adagrad", learning_rate=0.05, metrics=[], **ckw)
        tm._emb_opt and setattr(tm._emb_opt, "noise", jax_noise)
        jh = jm.fit(jds, epochs=2, batch_size=64, shuffle=False, verbose=0)
        th = tm.fit(tds, epochs=2, batch_size=64, shuffle=False, device="cpu")
    np.testing.assert_allclose(th.history["loss"], jh.history["loss"], rtol=1e-5)
    assert th.history["loss"][1] < th.history["loss"][0]
    params = dict(tm.named_parameters())
    for key, value in jax_flat(jm).items():
        parts = key.split("/")
        if parts[-1] == "kernel":
            parts, value = parts[:-1] + ["weight"], value.T
        got = params[".".join(parts)]
        assert got.dtype == (torch.bfloat16 if value.dtype.name == "bfloat16"
                             else torch.float32), key
        np.testing.assert_allclose(got.detach().float().numpy(), value.astype(np.float32),
                                   rtol=0, atol=1e-5, err_msg=key)
    if "optimizer_state_dtype" in ckw:
        assert all(v.dtype == torch.bfloat16 for st in tm._optimizer.state.values()
                   for v in st.values())


def test_fused_and_unfused_heads_agree_under_the_policy():
    """The fused loss (K1-K3's bf16 plain forms) against the unfused head's
    materialised logits, both under ``mixed_bfloat16``, one step from the
    same weights: the loss within rtol 1e-5; the gradients within 1e-2 of
    the model's largest |gradient|. Not closer: the unfused head rounds the
    query's two cotangents (positive and negatives) to bf16 each, the fused
    one their sum, and the two nearly cancel; the JAX package's two branches
    differ alike (each is held to JAX's own in
    ``test_mixed_fit_trajectory_matches_jax``)."""
    from models_tpu_torch.core.types import ModelContext, to_device_batch, to_device_targets
    from models_tpu_torch.data import Loader

    ds = mt.generate_data("movielens-25m", num_rows=64, seed=7)
    model = mt.TwoTowerModel(ds.schema, device="cpu", **SMALL)
    x, y = next(iter(Loader(ds, 64)))
    x, y = to_device_batch(x, "cpu"), to_device_targets(y, "cpu")
    out = {}
    with mixed_policy():
        for fused in (True, False):
            model.contrastive_output.fused_loss = "auto" if fused else False
            model.zero_grad(set_to_none=True)
            model.compile(optimizer="sgd", metrics=[])
            ctx = ModelContext(features=x, targets=y, step=0, need_logits=False)
            preds = model(x, targets=y, training=True, context=ctx)
            total, _ = model._compute_losses(model._as_pred_dict(preds), x,
                                             model._resolve_task_losses())
            total.backward()
            out[fused] = float(total), {n: p.grad.clone() for n, p in model.named_parameters()}
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=LOSS_RTOL)
    scale = max(float(g.abs().max()) for g in out[False][1].values())
    worst = max(float((out[True][1][n] - g).abs().max()) for n, g in out[False][1].items())
    assert worst <= 1e-2 * scale, worst / scale


def test_top_k_encoder_predict_matches_jax_under_the_policy():
    """Encoding under the policy (the Dense layers take bf16 operands), then
    the float32 index: scores within 1e-5, and on the rows whose scores hold
    no near-tie (every gap between neighbours above twice that) the ids
    equal JAX's; the other rows' ids agree outside their near-ties."""
    jds, tds, jm, tm = build_pair("e-commerce", 300, 5, query_tower=(16, 8))
    with mixed_policy():
        jout = jm.to_top_k_encoder(jds, k=5, batch_size=64).predict(jds, batch_size=64)
        tout = tm.to_top_k_encoder(tds, k=5, batch_size=64, device="cpu").predict(
            tds, batch_size=64, device="cpu")
    assert tout["scores"].dtype == np.float32
    np.testing.assert_allclose(tout["scores"], jout["scores"], rtol=0, atol=1e-5)
    tie_free = np.diff(-jout["scores"], axis=1).min(axis=1) > 2e-5
    assert tie_free.mean() > 0.8
    np.testing.assert_array_equal(tout["ids"][tie_free], jout["ids"][tie_free])
    assert ids_agree(tout["scores"], tout["ids"], jout["scores"], jout["ids"], 1e-5)
