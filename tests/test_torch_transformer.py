"""The port's session transformer against the JAX package's, on the CPU.

Each configuration (GPT2: causal; BERT; XLNet: relative attention; ALBERT:
one layer shared; Roberta) is built in JAX at a small width (d_model 16, 2
heads, inputs 12 wide so that ``in_proj`` exists), its parameters carried
over with ``load_jax_params``, and both take the same seeded (B, L, 12)
inputs with ragged masks, one row fully padded: outputs within atol 2e-5,
and the gradients of ``sum(out * w)`` (w seeded) with respect to every
parameter and to the input within 2e-5 of the largest |gradient| of all
(float32 sums in another order through two layers; the key bias's
gradient is rounding noise, its true value 0). Then: causality (a
change to a later item leaves earlier positions alone), a fully padded row
and the last valid position after the shift stay finite with finite
gradients, the introspection taps, and the output adapters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from models_tpu.core.types import ModelContext as JContext
from models_tpu.core.types import SequenceFeature as JSF
from models_tpu.transformer import block as jtb

import models_tpu_torch as mt
from models_tpu_torch.core.types import ModelContext, SequenceFeature
from models_tpu_torch.transformer import block as ttb

B, L, D_IN, D = 4, 6, 12, 16
ATOL = 2e-5
GRAD_TOL = 2e-5

CONFIGS = {
    "gpt2": ("GPT2Block", {}),
    "bert": ("BertBlock", {}),
    "roberta": ("RobertaBlock", {}),
    "xlnet": ("XLNetBlock", {}),
    "albert": ("AlbertBlock", {"n_layer": 3}),
}


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, D_IN)).astype(np.float32)
    lengths = np.array([6, 3, 0, 1])  # row 2 fully padded
    mask = np.arange(L)[None, :] < lengths[:, None]
    w = rng.normal(size=(B, L, D)).astype(np.float32)
    return x, mask, w


def jax_params(block):
    return {"/".join(str(p) for p in path): np.asarray(v[...])
            for path, v in nnx.state(block, nnx.Param).flat_state()}


def build(name):
    fn, kw = CONFIGS[name]
    kw = {"n_layer": 2, **kw}
    jb = getattr(jtb, fn)(d_model=D, n_head=2, dropout=0.0, seed=3, **kw)
    x, mask, _ = inputs()
    jb(JSF(jnp.asarray(x), jnp.asarray(mask)))  # builds in_proj
    tb = getattr(ttb, fn)(d_model=D, n_head=2, dropout=0.0, seed=3, in_features=D_IN,
                          device="cpu", **kw)
    mt.load_jax_params(tb, jax_params(jb))
    return jb, tb


def jax_forward_and_grads(jb, x, mask, w):
    graphdef, params, rest = nnx.split(jb, nnx.Param, ...)

    def f(p, xv):
        blk = nnx.merge(graphdef, p, rest)
        out = blk(JSF(xv, jnp.asarray(mask)))
        return jnp.sum(out.values * w), out.values

    (_, out), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    grads = {"/".join(str(p) for p in path): np.asarray(v[...])
             for path, v in gp.flat_state()}
    return np.asarray(out), grads, np.asarray(gx)


def port_grads(tb):
    out = {}
    for name, p in tb.named_parameters():
        parts, g = name.split("."), p.grad.numpy()
        if parts[-1] == "weight":
            parts, g = parts[:-1] + ["kernel"], g.T
        out["/".join(parts)] = g
    return out


def assert_rel_close(got, want, tol, what, scale):
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max|d| {err:.3g} of {scale:.3g}"


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_block_forward_and_gradients_match_jax(name):
    jb, tb = build(name)
    x, mask, w = inputs()
    jout, jgrads, jgx = jax_forward_and_grads(jb, x, mask, w)
    xt = torch.from_numpy(x).requires_grad_()
    out = tb(SequenceFeature(xt, torch.from_numpy(mask)))
    assert torch.equal(out.mask, torch.from_numpy(mask))
    np.testing.assert_allclose(out.values.detach().numpy(), jout, rtol=0, atol=ATOL)
    (out.values * torch.from_numpy(w)).sum().backward()
    tgrads = port_grads(tb)
    assert sorted(tgrads) == sorted(jgrads)
    scale = max(float(np.abs(g).max()) for g in list(jgrads.values()) + [jgx])
    for key, g in jgrads.items():
        assert_rel_close(tgrads[key], g, GRAD_TOL, key, scale)
    assert_rel_close(xt.grad.numpy(), jgx, GRAD_TOL, "input", scale)


def test_albert_shares_one_layer_and_xlnet_has_no_position_table():
    _, albert = build("albert")
    _, xlnet = build("xlnet")
    assert len(albert.layers) == 1 and albert.n_layers == 3
    assert xlnet.pos_emb is None and xlnet.layers[0].wr is not None


@pytest.mark.parametrize("name", ["gpt2", "xlnet"])
def test_causality_and_padding(name):
    """GPT2: changing the item at position 4 leaves positions 0-3 alone
    and moves position 4; a padded key never reaches a valid query (XLNet
    too)."""
    _, tb = build(name)
    x, mask, _ = inputs()
    x, mask = torch.from_numpy(x), torch.from_numpy(mask)
    base = tb(SequenceFeature(x, mask)).values
    x2 = x.clone()
    x2[0, 4] += 1.0
    moved = tb(SequenceFeature(x2, mask)).values
    if name == "gpt2":
        assert torch.equal(moved[0, :4], base[0, :4])
    assert not torch.allclose(moved[0, 4], base[0, 4])
    x3 = x.clone()
    x3[1, 3:] += 5.0  # row 1 has 3 valid positions: its padding changes
    padded = tb(SequenceFeature(x3, mask)).values
    assert torch.equal(padded[1, :3], base[1, :3])


def test_fully_masked_rows_stay_finite():
    """A fully padded row, and the last valid position after
    SequencePredictNext (no valid key under the causal mask), average the
    values uniformly: finite outputs and finite gradients."""
    _, tb = build("gpt2")
    x, mask, w = inputs()
    mask[1, 0] = False  # row 1: position 0 sees no valid key (causal)
    xt = torch.from_numpy(x).requires_grad_()
    out = tb(SequenceFeature(xt, torch.from_numpy(mask))).values
    assert bool(torch.isfinite(out).all())
    (out * torch.from_numpy(w)).sum().backward()
    assert bool(torch.isfinite(xt.grad).all())
    assert all(bool(torch.isfinite(p.grad).all()) for p in tb.parameters())


def test_introspection_taps_and_adapters():
    """hidden_states (inputs and every layer) and attentions (one (B, H, L,
    L) a layer, rows summing to 1) in the context, as in JAX; the adapters
    pool as the JAX ones do."""
    jb = jtb.BertBlock(d_model=D, n_head=2, n_layer=2, dropout=0.0, seed=3,
                       output_hidden_states=True, output_attentions=True)
    x, mask, _ = inputs()
    jctx = JContext()
    jout = jb(JSF(jnp.asarray(x), jnp.asarray(mask)), context=jctx)
    tb = ttb.BertBlock(d_model=D, n_head=2, n_layer=2, dropout=0.0, seed=3, in_features=D_IN,
                       output_hidden_states=True, output_attentions=True, device="cpu")
    mt.load_jax_params(tb, jax_params(jb))
    ctx = ModelContext()
    out = tb(SequenceFeature(torch.from_numpy(x), torch.from_numpy(mask)), context=ctx)
    assert len(ctx["hidden_states"]) == len(jctx["hidden_states"]) == 3
    for got, want in zip(ctx["hidden_states"] + ctx["attentions"],
                         jctx["hidden_states"] + jctx["attentions"]):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    assert ctx["attentions"][0].shape == (B, 2, L, L)
    hs = ttb.HiddenStates()(out, context=ctx)
    assert hs["last_hidden_state"] is out and len(hs["hidden_states"]) == 3
    assert ttb.AttentionWeights()(out, context=ctx)["attentions"] is ctx["attentions"]
    jsf = JSF(jout.values, jout.mask)
    for summary in ("last", "mean", "first"):
        np.testing.assert_allclose(ttb.SequenceSummary(summary)(out).detach().numpy(),
                                   np.asarray(jtb.SequenceSummary(summary)(jsf)), atol=ATOL)
    np.testing.assert_allclose(
        ttb.TransformerInferenceHiddenState()(out).detach().numpy(),
        np.asarray(jtb.TransformerInferenceHiddenState()(jsf)), atol=ATOL)
    assert ttb.TransformerInferenceHiddenState()(out, training=True) is out
    assert ttb.LastHiddenState()(out) is out
    pooled = ttb.PoolerOutput(D, device="cpu")(out)
    assert pooled.shape == (B, D) and bool((pooled.abs() <= 1).all())
