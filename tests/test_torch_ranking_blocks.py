"""The ranking slice's blocks against the JAX package's, on the CPU: the same
seeded numpy inputs through both, the JAX block's parameters carried over
with ``load_jax_params``.

Tolerances: outputs within rtol 1e-5, atol 1e-6 (fp32 sums of a few
products in another order); gradients alike. The dot interaction's
selection is exact, so it agrees to the gram's own tolerance. BatchNorm's
running statistics after three training calls within rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from models_tpu.blocks.cross import Cross as JCross
from models_tpu.blocks.interaction import DotProductInteraction as JDot
from models_tpu.blocks.interaction import FMBlock as JFMBlock
from models_tpu.blocks.interaction import XDeepFmOuterProduct as JCIN
from models_tpu.blocks.mlp import BatchNorm as JBatchNorm
from models_tpu.blocks.mlp import DenseResidualBlock as JResidual
from models_tpu.blocks.mlp import LayerNorm as JLayerNorm
from models_tpu.core.aggregation import StackFeatures as JStack
from models_tpu.data import generate_data as jax_generate
from models_tpu.inputs.continuous import ContinuousEmbedding as JContEmb
from models_tpu.inputs.embedding import Embeddings as JEmbeddings
from models_tpu.inputs.embedding import _fused_groups as jax_fused_groups
from models_tpu.schema import Schema as JSchema
from models_tpu.schema import create_categorical_column as jcat
from models_tpu.data.synthetic import known_schema as jax_known_schema

import models_tpu_torch as mt
from models_tpu_torch.blocks import (BatchNorm, Cross, DenseResidualBlock,
                                     DotProductInteraction, Dropout, FMBlock, LayerNorm,
                                     XDeepFmOuterProduct, get_activation)
from models_tpu_torch.core.aggregation import StackFeatures
from models_tpu_torch.core.types import to_device_batch
from models_tpu_torch.data.synthetic import known_schema
from models_tpu_torch.inputs import ContinuousEmbedding, ContinuousProjection, Embeddings
from models_tpu_torch.inputs.embedding import FusedEmbeddingTables, _fused_groups
from models_tpu_torch.schema import Schema
from models_tpu_torch.schema import create_categorical_column as tcat

RTOL, ATOL = 1e-5, 1e-6


def jax_flat(module):
    return {"/".join(str(p) for p in path): np.asarray(var[...])
            for path, var in nnx.state(module, nnx.Variable).flat_state()}


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol, err_msg=msg)


def rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("self_interaction", [False, True])
def test_dot_product_interaction(self_interaction):
    x = rand(6, 27, 16)
    w = rand(6, 27 * 28 // 2 if self_interaction else 27 * 26 // 2, seed=1)
    jfn = JDot(self_interaction=self_interaction)
    jout, jgrad = jfn(jnp.asarray(x)), jax.grad(lambda v: jnp.sum(jfn(v) * w))(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    tout = DotProductInteraction(self_interaction=self_interaction)(tx)
    (tout * torch.from_numpy(w)).sum().backward()
    assert tout.shape == jout.shape
    close(tout, jout)
    close(tx.grad, jgrad)


def test_fm_block_and_its_first_and_second_order_terms():
    jds = jax_generate("e-commerce", num_rows=32, seed=2)
    tds = mt.generate_data("e-commerce", num_rows=32, seed=2)
    jfm = JFMBlock(jds.schema, latent_dim=8)
    tfm = FMBlock(tds.schema, latent_dim=8, device="cpu")
    mt.load_jax_params(tfm, jax_flat(jfm))
    from models_tpu.core.types import to_device_batch as jax_batch
    from models_tpu.data import Loader as JLoader

    jx, _ = next(iter(JLoader(jds, 32)))
    tx, _ = next(iter(mt.Loader(tds, 32)))
    jout = jfm(jax_batch(jx))
    tout = tfm(to_device_batch(tx, "cpu"))
    assert tout.shape == (32, 1)
    close(tout, jout)


@pytest.mark.parametrize("low_rank_dim", [None, 4])
def test_cross_layer_full_and_low_rank(low_rank_dim):
    x0, x = rand(8, 24), rand(8, 24, seed=1)
    jc = JCross(low_rank_dim=low_rank_dim, seed=3)
    jout = jc((jnp.asarray(x0), jnp.asarray(x)))
    tc = Cross(low_rank_dim=low_rank_dim, in_features=24, device="cpu")
    mt.load_jax_params(tc, jax_flat(jc))
    tout = tc((torch.from_numpy(x0), torch.from_numpy(x)))
    close(tout[0], x0, rtol=0, atol=0)
    close(tout[1], jout[1])
    # one tensor stands for (x0, x0)
    close(tc(torch.from_numpy(x0))[1], jc(jnp.asarray(x0))[1])


def test_batch_norm_training_inference_and_running_statistics():
    """Three training calls (batch statistics, the running ones moving by
    momentum 0.99, biased variance), then inference on the running ones."""
    jbn = JBatchNorm()
    jbn(jnp.asarray(rand(4, 12)))  # builds it
    tbn = BatchNorm(in_features=12, device="cpu")
    mt.load_jax_params(tbn, jax_flat(jbn))
    for step in range(3):
        x = rand(32, 12, seed=10 + step, scale=3.0) + step
        jout = jbn(jnp.asarray(x), training=True)  # no context: updates in place
        tout = tbn(torch.from_numpy(x), training=True)
        close(tout, jout)
    close(tbn.mean, jbn.mean.value, rtol=1e-6, atol=1e-7)
    close(tbn.var, jbn.var.value, rtol=1e-6, atol=1e-7)
    assert not np.allclose(np.asarray(jbn.mean.value), 0)
    x = rand(16, 12, seed=20)
    close(tbn(torch.from_numpy(x)), jbn(jnp.asarray(x), training=False))
    # torch's BatchNorm1d is another function (momentum's sense, unbiased var)
    ref = torch.nn.BatchNorm1d(12, momentum=0.01, eps=1e-3)
    for step in range(3):
        ref(torch.from_numpy(rand(32, 12, seed=10 + step, scale=3.0) + step))
    assert not torch.allclose(ref.running_var, tbn.var, rtol=1e-6)


def test_layer_norm():
    x = rand(10, 16, scale=2.0) + 1.0
    jln = JLayerNorm()
    jout = jln(jnp.asarray(x))
    tln = LayerNorm(in_features=16, device="cpu")
    mt.load_jax_params(tln, jax_flat(jln))
    close(tln(torch.from_numpy(x)), jout)


def test_dense_residual_block_with_batch_norm():
    x = rand(16, 12)
    jb = JResidual(low_rank_dim=3, seed=2)
    jb(jnp.asarray(x))
    tb = DenseResidualBlock(low_rank_dim=3, in_features=12, device="cpu")
    mt.load_jax_params(tb, jax_flat(jb))
    close(tb(torch.from_numpy(x), training=True), jb(jnp.asarray(x), training=True))
    close(tb.norm.mean, jb.norm.mean.value, rtol=1e-6, atol=1e-7)
    close(tb(torch.from_numpy(x)), jb(jnp.asarray(x)))


def test_stack_features_takes_sorted_key_order():
    vals = {name: rand(3, 4, seed=i) for i, name in enumerate(["b", "__bottom__", "C10", "C2",
                                                                "a"])}
    jout = JStack()({k: jnp.asarray(v) for k, v in vals.items()})
    tout = StackFeatures()({k: torch.from_numpy(v) for k, v in vals.items()})
    close(tout, jout, rtol=0, atol=0)
    order = sorted(vals)
    for i, name in enumerate(order):
        assert np.array_equal(tout[:, i].numpy(), vals[name])


@pytest.mark.parametrize("name", ["criteo", "criteo-small"])
@pytest.mark.parametrize("dim", [8, 64, 128])
def test_fused_groups_are_the_jax_packages(name, dim):
    want = [[c.name for c in g] for g in jax_fused_groups(list(jax_known_schema(name).categorical),
                                                          dim)]
    got = [[c.name for c in g] for g in _fused_groups(list(known_schema(name).categorical), dim)]
    assert got == want
    if name == "criteo" and dim == 64:
        assert len(got) == 3 and sum(map(len, got)) == 13


def _mixed_schemas():
    cards = [3, 900, 17, 5000, 40000, 120, 2, 9000, 7]
    return (JSchema([jcat(f"c{i}", c) for i, c in enumerate(cards)]),
            Schema([tcat(f"c{i}", c) for i, c in enumerate(cards)]))


def test_fused_embeddings_match_jax_tables_lookups_and_gradients():
    """Fused groups and per-domain tables by the same names and shapes; the
    lookup and the tables' gradients (the JAX one-hot backward against
    ``F.embedding``'s) agree."""
    js, ts = _mixed_schemas()
    jemb = JEmbeddings(js, dim=8, sequence_combiner="mean", fused=True)
    temb = Embeddings(ts, dim=8, sequence_combiner="mean", fused=True, device="cpu")
    jparams = jax_flat(jemb)
    tparams = {k.replace(".", "/"): tuple(v.shape) for k, v in temb.named_parameters()}
    assert tparams == {k: v.shape for k, v in jparams.items()}
    assert any(isinstance(t, FusedEmbeddingTables) for t in temb.branches.values())
    mt.load_jax_params(temb, jparams)
    rng = np.random.default_rng(0)
    ids = {c.name: rng.integers(0, c.cardinality, size=64).astype(np.int32) for c in ts}
    w = {c.name: rand(64, 8, seed=i) for i, c in enumerate(ts)}

    graphdef, state, rest = nnx.split(jemb, nnx.Param, ...)

    def jloss(params):
        out = nnx.merge(graphdef, params, rest)({k: jnp.asarray(v) for k, v in ids.items()})
        return sum(jnp.sum(out[k] * w[k]) for k in out), out

    (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(state)
    tout = temb({k: torch.from_numpy(v) for k, v in ids.items()})
    sum((tout[k] * torch.from_numpy(w[k])).sum() for k in tout).backward()
    assert sorted(tout) == sorted(jout)
    for k in jout:
        close(tout[k], jout[k], rtol=0, atol=0, msg=k)
    jg = {"/".join(str(p) for p in path): np.asarray(v[...])
          for path, v in jgrads.flat_state()}
    for name, p in temb.named_parameters():
        close(p.grad, jg[name.replace(".", "/")], msg=name)


def test_dropout_rate_zero_and_inference_are_identities_and_rate_half_scales():
    x = torch.from_numpy(rand(200, 50)) + 5.0
    assert Dropout(0.0)(x, training=True) is x
    assert Dropout(0.5)(x) is x
    d = Dropout(0.5, seed=3)
    out = d(x, training=True)
    kept = out != 0
    n = x.numel()
    # keep share within 5 standard deviations of the binomial's mean
    assert abs(kept.float().sum().item() - n / 2) < 5 * (n * 0.25) ** 0.5
    assert torch.equal(out[kept], x[kept] / 0.5)
    # the generator advances: a second call draws another mask
    assert not torch.equal(d(x, training=True) != 0, kept)
    # the same seed draws the same mask
    assert torch.equal(Dropout(0.5, seed=3)(x, training=True), out)


def test_continuous_embedding_and_projection():
    x = rand(12, seed=4)
    jce = JContEmb(num_embeddings=6, dim=4, seed=1)
    tce = ContinuousEmbedding(num_embeddings=6, dim=4, seed=1, device="cpu")
    mt.load_jax_params(tce, jax_flat(jce))
    close(tce(torch.from_numpy(x)), jce(jnp.asarray(x)))
    out = tce({"a": torch.from_numpy(x), "b": torch.from_numpy(x[::-1].copy())})
    assert sorted(out) == ["a", "b"] and out["a"].shape == (12, 4)
    schema = known_schema("criteo-small")
    proj = mt.blocks.Dense(5, in_features=13, device="cpu")
    block = ContinuousProjection(schema, proj)
    ds = mt.generate_data("criteo-small", num_rows=8, seed=0)
    xb, _ = next(iter(mt.Loader(ds, 8)))
    xb = to_device_batch(xb, "cpu")
    cols = torch.stack([xb[f"I{i}"] for i in sorted(range(1, 14), key=lambda i: f"I{i}")], 1)
    close(block(xb), proj(cols), rtol=0, atol=0)
    assert block.out_features == 5


def test_xdeepfm_outer_product():
    x0, xp = rand(4, 5, 6), rand(4, 3, 6, seed=1)
    jc = JCIN(dim=7, seed=2)
    jout = jc((jnp.asarray(xp), jnp.asarray(x0)))
    tc = XDeepFmOuterProduct(7, 3, 5, device="cpu")
    mt.load_jax_params(tc, jax_flat(jc))
    close(tc((torch.from_numpy(xp), torch.from_numpy(x0))), jout)


@pytest.mark.parametrize("name", ["relu", "sigmoid", "tanh", "gelu", "silu", "elu", "softplus",
                                  "selu", "leaky_relu", "relu6"])
def test_activations_are_jax_nn(name):
    x = rand(64, scale=3.0)
    close(get_activation(name)(torch.from_numpy(x)), getattr(jax.nn, name)(jnp.asarray(x)))
    assert get_activation("linear") is None and get_activation(None) is None
    with pytest.raises(ValueError, match="Unknown activation"):
        get_activation("nope")


def test_categorical_head_and_column_sample_weights():
    """CategoricalOutput over a column's classes (logits, the softmax of
    ``activation``, the sparse CE default) and ColumnBasedSampleWeight's
    binary class weights on a Prediction, against JAX."""
    from models_tpu.core.types import ModelContext as JContext
    from models_tpu.core.types import Prediction as JPrediction
    from models_tpu.outputs.base import CategoricalOutput as JCategorical
    from models_tpu.outputs.base import ColumnBasedSampleWeight as JWeights

    from models_tpu_torch.core.types import ModelContext, Prediction
    from models_tpu_torch.outputs import CategoricalOutput, ColumnBasedSampleWeight

    x, ids = rand(16, 12), np.random.default_rng(1).integers(0, 30, 16).astype(np.int32)
    jhead = JCategorical(jcat("genre", 29))
    jpred = jhead(jnp.asarray(x), targets=jnp.asarray(ids))
    thead = CategoricalOutput(tcat("genre", 29), in_features=12, device="cpu")
    mt.load_jax_params(thead, jax_flat(jhead))
    tpred = thead(torch.from_numpy(x), targets=torch.from_numpy(ids))
    assert thead.block_name == jhead.block_name == "genre/CategoricalOutput"
    assert thead.default_loss == jhead.default_loss == "sparse_categorical_crossentropy"
    close(tpred.outputs, jpred.outputs)
    close(thead.activation(tpred.outputs), jhead.activation(jpred.outputs))
    assert [m.name for m in thead.default_metrics()[0].metrics] == [
        m.name for m in jhead.default_metrics()[0].metrics]

    col = np.array([0, 1, 1, 0, 2], np.int32)
    prev = rand(5, seed=3)
    jw = JWeights("clicks", binary_class_weights=(0.5, 2.0))(
        JPrediction(outputs=jnp.zeros((5, 1)), sample_weight=jnp.asarray(prev)),
        context=JContext(features={"clicks": jnp.asarray(col)}))
    tw = ColumnBasedSampleWeight("clicks", binary_class_weights=(0.5, 2.0))(
        Prediction(outputs=torch.zeros(5, 1), sample_weight=torch.from_numpy(prev)),
        context=ModelContext(features={"clicks": torch.from_numpy(col)}))
    close(tw.sample_weight, jw.sample_weight, rtol=0, atol=0)


def test_output_block_builds_a_head_per_target():
    jds = jax_generate("movielens-25m", num_rows=8, seed=0)
    from models_tpu.outputs.base import OutputBlock as JOutputBlock

    jheads = JOutputBlock(jds.schema)
    theads = mt.OutputBlock(known_schema("movielens-25m"), in_features=4, device="cpu")
    assert sorted(theads.branches) == sorted(jheads.branches)
    assert {k: type(v).__name__ for k, v in theads.branches.items()} == {
        k: type(v).__name__ for k, v in jheads.branches.items()}
    single = mt.OutputBlock(known_schema("criteo-small"), in_features=4, device="cpu")
    assert isinstance(single, mt.BinaryOutput) and single.target == "label"
