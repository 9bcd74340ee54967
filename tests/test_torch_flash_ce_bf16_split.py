"""The arithmetic of the bf16 flash-CE backward kernels (K2-bf16 ``grad_query``,
K3-bf16 ``grad_neg``) against the JAX package's Pallas kernels, on the CPU.

On the card the bf16 forms take each fp32 coefficient ``c`` as three bf16
parts, ``hi = bf16(c)``, ``mid = bf16(c - hi)``, ``lo = bf16(c - hi - mid)``
(all rounding to nearest), multiply each part by the bf16 row (exact in
fp32) and sum each 32 rows from zero in fp32 (``csrc/flash_ce.cu``,
``grad_wg``). ``ops/flash_ce.py::grad_query_split3`` / ``grad_neg_split3``
model that arithmetic; here they are held to the Pallas kernels in interpret
mode on the same bf16 inputs (numpy from a seed, rounded to bf16 alike on both
sides), under the tolerances ``tests/test_torch_mixed_precision.py`` holds
the bf16 forms to: rtol 2e-4, atol 1e-7 (fp32 sums of the same products in
another order).

The split's bound: ``c - hi`` is exact in fp32 (at most 16 significant bits
are left below hi's) and so is ``c - hi - mid`` (at most 8, which bf16
holds), so the three parts sum to ``c`` exactly while the remainders stay in
bf16's normal range (``|c| >= 2**-110``): within fp32's unit roundoff,
``2**-24 |c|``. Below that only bf16's subnormal spacing bounds the last
part, ``2**-134`` absolute. A one-part split (``bf16(c)`` alone) keeps 8
bits, ``2**-9 |c|``: the controls show that it misses both the bound and the
kernels' tolerance on the same inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from models_tpu.ops import flash_ce as jflash

from models_tpu_torch.core.constants import MIN_FLOAT
from models_tpu_torch.ops import flash_ce as tflash

GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-7  # as tests/test_torch_mixed_precision.py
UNIT_ROUNDOFF = 2.0 ** -24  # fp32's
LAST_PART_FLOOR = 2.0 ** -134  # half of bf16's smallest subnormal


def _coefficients(seed, n=4096):
    """fp32 values over many magnitudes, as softmax coefficients take them:
    ``gw * exp(x - lse) / T`` for logits far below and near the lse."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-80.0, 0.0, n) * rng.choice([0.01, 0.1, 1.0], n)
    c = rng.uniform(0.0, 1.0, n) * np.exp(x) / rng.choice([0.7, 1.0], n)
    return torch.from_numpy(c.astype(np.float32))


def _parts_sum(parts):
    return sum(p.double() for p in parts)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_three_bf16_parts_reconstruct_the_coefficient(seed):
    c = _coefficients(seed)
    hi, mid, lo = tflash.split3_bf16(c)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    err = (_parts_sum((hi, mid, lo)) - c.double()).abs()
    normal = c.abs() >= 2.0 ** -110
    assert bool(normal.any()) and float(err[normal].max()) == 0.0  # exact in bf16's range
    assert bool((err[normal] <= UNIT_ROUNDOFF * c.double().abs()[normal]).all())
    assert float(err.max()) <= LAST_PART_FLOOR
    # each part is the remainder of those before it, rounded to nearest
    assert torch.equal(hi, c.bfloat16())
    assert torch.equal(mid, (c - hi.float()).bfloat16())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_one_bf16_part_misses_the_unit_roundoff(seed):
    """The control: bf16(c) alone is about 2**-9 off, not 2**-24."""
    c = _coefficients(seed)
    err = (c.bfloat16().double() - c.double()).abs()
    off = err > UNIT_ROUNDOFF * c.double().abs()
    assert float(off.float().mean()) > 0.9
    assert float((err / c.double().abs().clamp_min(1e-300)).max()) > 2.0 ** -10


def _inputs(seed, Q, N, D, bias_kind, zero_weights):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((Q, D)) * 0.3).astype(np.float32)
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
    return q, neg, pid, nid, bias, w


def _bf16(a):
    """(jax, torch) bf16 copies of one float32 numpy array, the same bits."""
    j, t = jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).bfloat16()
    np.testing.assert_array_equal(np.asarray(j).view(np.int16), t.view(torch.int16).numpy())
    return j, t


def _case(Q, N, D, downscore, bias_kind, T):
    """The Pallas kernels' dq and dneg (interpret mode) and the inputs of the
    port's model, for one seeded case."""
    q, neg, pid, nid, bias, w = _inputs(Q * 1000 + N + D, Q, N, D, bias_kind, True)
    (jq, tq), (jn, tn) = _bf16(q), _bf16(neg)
    ids = (pid, nid) if downscore else (None, None)
    opt = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    pos_logit = np.zeros(Q, np.float32)
    jm, js = jflash.lse_forward(jq, jnp.asarray(pos_logit), jn, opt(ids[0]), opt(ids[1]),
                                opt(bias), T, downscore, tq=8, tn=16, interpret=True)
    lse = (np.asarray(jm) + np.log(np.asarray(js))).astype(np.float32)
    gw = (w / w.sum()).astype(np.float32)
    rest_j = (jnp.asarray(lse), jnp.asarray(gw), opt(ids[0]), opt(ids[1]), opt(bias), T,
              downscore)
    jdq = np.asarray(jflash.grad_query(jq, jn, *rest_j, tq=8, tn=16, interpret=True))
    jdn = np.asarray(jflash.grad_neg(jq, jn, *rest_j, tq=8, tn=16, interpret=True))
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    rest_t = (t(lse), t(gw), t(ids[0]), t(ids[1]), t(bias), T, downscore)
    return (tq, tn, rest_t), jdq, jdn


# (Q, N, downscore, bias, T): N past one 32-row part and ragged, fewer rows
# than a part, masked pairs and MIN_FLOAT biases, a temperature
SPLIT_CASES = [
    (40, 64, True, "min", 0.7),
    (64, 37, False, None, 1.0),
    (20, 20, True, None, 0.7),
]


@pytest.mark.parametrize("D", [16, 20, 64])
@pytest.mark.parametrize("Q,N,downscore,bias_kind,T", SPLIT_CASES)
def test_split3_gradients_match_pallas_interpret(Q, N, downscore, bias_kind, T, D):
    (tq, tn, rest), jdq, jdn = _case(Q, N, D, downscore, bias_kind, T)
    dq = tflash.grad_query_split3(tq, tn, *rest)
    dn = tflash.grad_neg_split3(tq, tn, *rest)
    assert dq.dtype == dn.dtype == torch.float32
    assert dq.shape == (Q, D) and dn.shape == (N, D)
    np.testing.assert_allclose(dq.numpy(), jdq, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(dn.numpy(), jdn, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    # the model computes what the plain versions compute, up to sum order
    np.testing.assert_allclose(dq.numpy(), tflash.grad_query_plain(tq, tn, *rest).numpy(),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(dn.numpy(), tflash.grad_neg_plain(tq, tn, *rest).numpy(),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("D", [16, 64])
def test_one_part_product_misses_the_tolerance(D):
    """The control: the coefficients rounded to bf16 once, times the same rows
    (exact products, the same 32-row sums), miss rtol 2e-4 on the inputs the
    three-part model passes."""
    Q, N, downscore, bias_kind, T = SPLIT_CASES[0]
    (tq, tn, rest), jdq, jdn = _case(Q, N, D, downscore, bias_kind, T)
    lse, gw, pid, nid, bias = rest[:5]
    coef = tflash._coef(tq, tn, lse, gw, pid, nid, bias, T, downscore)

    def one_part(c, rows):
        out = torch.zeros(c.shape[0], rows.shape[1])
        for k0 in range(0, c.shape[1], tflash.SPLIT_ROWS):
            out += (c[:, k0:k0 + tflash.SPLIT_ROWS].bfloat16().float()
                    @ rows[k0:k0 + tflash.SPLIT_ROWS].float())
        return out

    for got, want in ((one_part(coef, tn), jdq), (one_part(coef.T, tq), jdn)):
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_split3_product_sums_each_32_rows_from_zero():
    """Rows past a 32-row part start a new fp32 sum: a part that cancels to
    zero leaves no trace of its large terms in the next part's sum."""
    coef = torch.tensor([[1.0] * 32 + [2.0 ** -20]], dtype=torch.float32)
    rows = torch.zeros(33, 1, dtype=torch.bfloat16)
    rows[0, 0], rows[1, 0], rows[32, 0] = 2.0 ** 20, -(2.0 ** 20), 1.0
    out = tflash.split3_product(coef, rows)
    assert float(out[0, 0]) == 2.0 ** -20
