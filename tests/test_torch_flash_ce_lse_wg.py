"""The arithmetic of the bf16 flash-CE forward on ``wgmma`` (K1-bf16,
``lse_wg``) against the JAX package's Pallas kernel, on the CPU.

On the card ``lse_wg`` takes the logit sums from ``wgmma`` (bf16 products,
exact in fp32; each 32 deep summed from zero, the parts added in depth
order), takes the max over ``x' + bias`` (``MIN_FLOAT`` where masked) and
scales it once by ``1 / T``, and forms each exponential as
``2 ** fma(x' + bias, log2(e) / T, -m log2(e))`` with ``ex2.approx``
(``csrc/flash_ce.cu``, ``lse_tile``). ``ops/flash_ce.py::lse_forward_ex2``
models that arithmetic; here it is held to the Pallas kernel in interpret
mode on the same bf16 inputs (numpy from a seed, rounded to bf16 alike on
both sides) within 1e-5 of the largest value, the tolerance
``chip_smoke.py`` holds the card's (m, s) to (``FCE_TOL``): the fold rounds
``m log2(e)`` once, about ``|m| 2**-24`` in the exponent.

The max must not move with the fold: on inputs whose logit sums are exact
in fp32 in any order (multiples of 1/8 up to 1, biases of 1/64), the
model's m equals the plain version's bit for bit. The plain version divides
by T and the kernels multiply by 1 / T, as they did before the fold, so
that check takes temperatures whose reciprocal is exact (1 and 0.5); 0.7
stays in the tolerance test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from models_tpu.ops import flash_ce as jflash

from models_tpu_torch.core.constants import MIN_FLOAT
from models_tpu_torch.ops import flash_ce as tflash

FCE_TOL = 1e-5  # of the largest |value|, as chip_smoke.py


def _bf16(a):
    """(jax, torch) bf16 copies of one float32 numpy array, the same bits."""
    j, t = jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).bfloat16()
    np.testing.assert_array_equal(np.asarray(j).view(np.int16), t.view(torch.int16).numpy())
    return j, t


def _inputs(seed, Q, N, D, bias_kind):
    """Seeded operands as the towers give them, ids with planted duplicates
    (few distinct values, and the negatives' first ids the queries'), a
    bias with MIN_FLOAT on some negatives."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((Q, D)) * 0.3).astype(np.float32)
    neg = (rng.standard_normal((N, D)) * 0.3).astype(np.float32)
    pos_logit = (rng.standard_normal(Q) * 0.5).astype(np.float32)
    pid = rng.integers(0, 12, Q).astype(np.int32)
    nid = rng.integers(0, 12, N).astype(np.int32)
    nid[: min(Q, N) // 2] = pid[: min(Q, N) // 2]
    bias = None
    if bias_kind == "min":
        bias = (rng.standard_normal(N) * 0.1).astype(np.float32)
        bias[::7] = MIN_FLOAT
    return q, neg, pos_logit, pid, nid, bias


def _rel(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


# (Q, N, downscore, bias, T): ragged Q and N past several 64-wide tiles, N
# within one tile, duplicate ids masked, MIN_FLOAT biases, a temperature
CASES = [
    (100, 300, True, "min", 0.7),
    (100, 300, False, None, 1.0),
    (64, 130, True, None, 1.0),
    (37, 50, True, "min", 0.7),
]


@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("Q,N,downscore,bias_kind,T", CASES)
def test_lse_wg_model_matches_pallas_interpret(Q, N, downscore, bias_kind, T, D):
    q, neg, pos_logit, pid, nid, bias = _inputs(Q * 1000 + N + D, Q, N, D, bias_kind)
    (jq, tq), (jn, tn) = _bf16(q), _bf16(neg)
    opt = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    ids = (pid, nid) if downscore else (None, None)
    jm, js = jflash.lse_forward(jq, jnp.asarray(pos_logit), jn, opt(ids[0]), opt(ids[1]),
                                opt(bias), T, downscore, tq=64, tn=128, interpret=True)
    jm, js = np.asarray(jm, np.float64), np.asarray(js, np.float64)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    args = (tq, torch.from_numpy(pos_logit), tn, t(ids[0]), t(ids[1]), t(bias), T, downscore)
    m, s = tflash.lse_forward_ex2(*args)
    assert m.dtype == s.dtype == torch.float32 and m.shape == s.shape == (Q,)
    assert bool(torch.isfinite(m).all() and torch.isfinite(s).all())
    assert _rel(m, jm) <= FCE_TOL
    assert _rel(s, js) <= FCE_TOL
    # the lse the backward kernels take, as the loss takes it
    lse = m.double() + torch.log(s.double())
    assert _rel(lse, jm + np.log(js)) <= FCE_TOL
    # and the plain version, which the CPU route runs, within the same
    pm, ps = tflash.lse_forward(*args)
    assert _rel(m, pm.double().numpy()) <= FCE_TOL
    assert _rel(s, ps.double().numpy()) <= FCE_TOL


def _exact_inputs(seed, Q, N, D):
    """Operands of multiples of 1/8 in [-1, 1] and biases of multiples of
    1/64 in [-4, 4] (MIN_FLOAT on some): every logit sum is exact in fp32,
    in any order. Every third positive logit lies above every logit."""
    rng = np.random.default_rng(seed)
    q = (rng.integers(-8, 9, (Q, D)) / 8).astype(np.float32)
    neg = (rng.integers(-8, 9, (N, D)) / 8).astype(np.float32)
    pos_logit = (rng.integers(-256, 257, Q) / 64).astype(np.float32)
    pos_logit[::3] = 80.0  # above every logit: those rows' max is the positive
    pid = rng.integers(0, 9, Q).astype(np.int32)
    nid = rng.integers(0, 9, N).astype(np.int32)
    bias = (rng.integers(-256, 257, N) / 64).astype(np.float32)
    bias[::11] = MIN_FLOAT
    return q, neg, pos_logit, pid, nid, bias


@pytest.mark.parametrize("T", [1.0, 0.5])
@pytest.mark.parametrize("Q,N,D,downscore", [(100, 300, 64, True), (37, 130, 16, False)])
def test_lse_wg_model_max_is_the_plain_max(Q, N, D, downscore, T):
    q, neg, pos_logit, pid, nid, bias = _exact_inputs(Q + N + D, Q, N, D)
    args = (torch.from_numpy(q).bfloat16(), torch.from_numpy(pos_logit),
            torch.from_numpy(neg).bfloat16(), torch.from_numpy(pid), torch.from_numpy(nid),
            torch.from_numpy(bias), T, downscore)
    sums = tflash.logit_parts(args[0], args[2])
    assert torch.equal(sums, torch.from_numpy(q.astype(np.float64) @ neg.T.astype(np.float64))
                       .float())  # the premise: exact sums
    m, _ = tflash.lse_forward_ex2(*args)
    pm, _ = tflash.lse_forward_plain(*args)
    np.testing.assert_array_equal(m.numpy().view(np.int32), pm.numpy().view(np.int32))
    # the max is a logit or the positive: some rows take each
    assert bool((m == args[1]).any()) and bool((m != args[1]).any())


def test_logit_parts_sum_each_32_deep_from_zero():
    """Depth past a 32-deep part starts a new fp32 sum: a part that cancels
    to zero leaves no trace of its large terms in the next part's sum."""
    q = torch.zeros(1, 33, dtype=torch.bfloat16)
    neg = torch.zeros(1, 33, dtype=torch.bfloat16)
    q[0, 0], q[0, 1], q[0, 32] = 2.0 ** 20, -(2.0 ** 20), 2.0 ** -20
    neg[0, :] = 1.0
    assert float(tflash.logit_parts(q, neg)[0, 0]) == 2.0 ** -20
