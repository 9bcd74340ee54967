"""The port's block DSL against the JAX package's, on the CPU: layers whose
widths build at a model's build pass, the combinators, the aggregations and
the registries.

Each case runs the same seeded numpy inputs through a JAX block and its
port; where the block holds parameters, the JAX block is built first (one
eager call) and its parameters are carried over with ``load_jax_params``.
Outputs within rtol 1e-5, atol 1e-6 (fp32 sums of a few products in
another order); input gradients alike. A lazily built layer must draw
exactly what the same layer given ``in_features`` draws (bit for bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import models_tpu as mm
from models_tpu.blocks.cross import CrossBlock as JCrossBlock
from models_tpu.blocks.mlp import MLPBlock as JMLPBlock
from models_tpu.core import aggregation as jagg
from models_tpu.core import block as jblock
from models_tpu.core import combinators as jcomb
from models_tpu.core.types import SequenceFeature as JSeq

import models_tpu_torch as mt
from models_tpu_torch.blocks import mlp as tmlp
from models_tpu_torch.blocks.cross import CrossBlock
from models_tpu_torch.blocks.mlp import Dense, DenseResidualBlock, LayerNorm, MLPBlock
from models_tpu_torch.core import aggregation as tagg
from models_tpu_torch.core import block as tblock
from models_tpu_torch.core import combinators as tcomb
from models_tpu_torch.core.types import SequenceFeature
from models_tpu_torch.registry import aggregation_registry, block_registry

RTOL, ATOL = 1e-5, 1e-6


def jax_params(module):
    return {"/".join(str(p) for p in path): np.asarray(v[...])
            for path, v in nnx.state(module, nnx.Param).flat_state()}


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def run_both(jb, tb, x, w_seed=9):
    """Outputs and input gradients of ``sum(out * w)`` through both blocks,
    a (B, F) input; the JAX block built first and carried over."""
    jout = jb(jnp.asarray(x))
    params = jax_params(jb)
    if params:
        tb(torch.from_numpy(x))  # build
        mt.load_jax_params(tb, params)
    w = rand(*np.asarray(jout).shape, seed=w_seed)
    jgrad = jax.grad(lambda v: jnp.sum(jb(v) * w))(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    tout = tb(tx)
    (tout * torch.from_numpy(w)).sum().backward()
    close(tout, jout)
    close(tx.grad, jgrad)


# ---- widths inferred at the build pass ----------------------------------

LAZY_EAGER = {
    "dense": (lambda **kw: Dense(6, activation="relu", seed=3, **kw), ["weight", "bias"]),
    "dense-he-normal": (lambda **kw: Dense(6, kernel_init="he_normal", seed=1, **kw),
                        ["weight", "bias"]),
    "mlp": (lambda **kw: MLPBlock([8, 4], normalization="batch_norm", seed=2, **kw), None),
    "cross-low-rank": (lambda **kw: CrossBlock(depth=2, low_rank_dim=3, seed=5, **kw), None),
    "residual": (lambda **kw: DenseResidualBlock(low_rank_dim=2, seed=4, **kw), None),
    "layer-norm": (lambda **kw: LayerNorm(**kw), None),
}


@pytest.mark.parametrize("case", sorted(LAZY_EAGER))
def test_lazy_build_draws_what_an_eager_build_draws(case):
    make, _ = LAZY_EAGER[case]
    lazy, eager = make(), make(in_features=12, device="cpu")
    assert not isinstance(lazy, tmlp.LazyMixin) or not lazy.built
    x = torch.from_numpy(rand(5, 12))
    lazy(x)
    assert dict(lazy.named_parameters()).keys() == dict(eager.named_parameters()).keys()
    for (name, a), (_, b) in zip(lazy.named_parameters(), eager.named_parameters()):
        assert torch.equal(a, b), name
    assert torch.equal(lazy(x), eager(x))


def test_lazy_layers_match_jax_after_both_build():
    jb = JCrossBlock(depth=2, seed=1) >> JMLPBlock([8, 4], seed=2)
    tb = CrossBlock(depth=2, seed=1) >> MLPBlock([8, 4], seed=2)
    # the crosses and both Dense layers wait for the input
    assert sum(isinstance(m, tmlp.LazyMixin) and not m.built for m in tb.modules()) == 4
    run_both(jb, tb, rand(6, 10))


def test_model_build_pass_and_output_block():
    """``Model.build`` builds every lazy layer on at most 32 rows, and the
    parameters equal an eager build's; ``OutputBlock(schema)`` takes its
    width there."""
    ds = mt.generate_data("e-commerce", num_rows=80, seed=1)
    inputs = mt.InputBlockV2(ds.schema, dim=8, device="cpu")

    def model(**kw):
        body = inputs >> MLPBlock([16, 8], seed=3, **kw)
        return mt.Model(body, mt.OutputBlock(ds.schema, in_features=kw.get("in_features") and 8,
                                             device="cpu"))

    lazy, eager = model(), model(in_features=inputs.out_features, device="cpu")
    assert len(lazy.unbuilt_layers()) == 4  # the MLP's two Dense layers, each head's Dense
    assert len(eager.unbuilt_layers()) == 0
    calls = []
    lazy.register_forward_pre_hook(lambda m, args: calls.append(args[0]["__row_valid__"].shape))
    lazy.build(mt.Loader(ds, 64), device="cpu")
    assert calls == [(32,)] and not lazy.unbuilt_layers()
    lazy.build(ds, device="cpu")  # nothing left: no forward
    assert len(calls) == 1
    for (name, a), (_, b) in zip(lazy.named_parameters(), eager.named_parameters()):
        assert torch.equal(a, b), name


def test_fit_builds_before_the_optimizer():
    ds = mt.generate_data("e-commerce", num_rows=64, seed=2)
    body = mt.InputBlockV2(ds.schema, dim=4, device="cpu") >> MLPBlock([8])
    model = mt.Model(body, mt.OutputBlock(ds.schema))
    model.compile(optimizer="adam", learning_rate=1e-2)
    model.fit(ds, batch_size=32, device="cpu")
    dense = model.blocks[0].layers[-1]
    n_opt = sum(p.numel() for g in model._optimizer.param_groups for p in g["params"])
    assert dense.built and n_opt == sum(p.numel() for p in model.parameters())


def test_unbuilt_layer_in_a_graph_capture_raises(monkeypatch):
    monkeypatch.setattr(tmlp, "_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="not built"):
        Dense(4)(torch.ones(2, 3))
    Dense(4, in_features=3)(torch.ones(2, 3))  # built layers run as ever


def test_fresh_copy_of_an_unbuilt_block_draws_anew():
    a = MLPBlock([4], seed=1)
    b = tblock.fresh_copy(a, 2)
    x = torch.ones(2, 3)
    assert not torch.equal(a(x), b(x))
    assert b[0].seed == a[0].seed + 7919 * 2


# ---- aggregations ---------------------------------------------------------

def _feats(names, shapes, seed=0, seq=()):
    out = {}
    for i, (n, s) in enumerate(zip(names, shapes)):
        out[n] = rand(*s, seed=seed + i)
    masks = {n: np.random.default_rng(seed + 50).random(shapes[names.index(n)][:2]) > 0.3
             for n in seq}
    return out, masks


def _wrap(vals, masks, torch_side):
    if torch_side:
        return {k: (SequenceFeature(torch.from_numpy(v).requires_grad_(), torch.from_numpy(masks[k]))
                    if k in masks else torch.from_numpy(v).requires_grad_()) for k, v in vals.items()}
    return {k: (JSeq(jnp.asarray(v), jnp.asarray(masks[k])) if k in masks else jnp.asarray(v))
            for k, v in vals.items()}


AGGREGATIONS = {
    "sum": (["b", "a", "c"], [(5, 4), (5, 4), (5,)], ()),
    "element-wise-sum": (["a", "b"], [(5, 4), (5, 4)], ()),
    "element-wise-multiply": (["b", "a"], [(5, 4), (5, 4)], ()),
    "element-wise-sum-item-multi": (["seq", "ctx", "ctx2"], [(5, 3, 4), (5, 4), (5, 4)], ()),
    "cosine": (["q", "c"], [(5, 6), (5, 6)], ()),
    "masked_mean": (["s1", "s2"], [(5, 3, 4), (5, 3, 2)], ("s1", "s2")),
    "concat": (["z", "a"], [(5, 2), (5,)], ()),
    "stack": (["b", "a"], [(5, 3), (5, 3)], ()),
    "sequence-max": (["s", "x"], [(5, 3, 2), (5, 2)], ("s",)),
}


@pytest.mark.parametrize("name", sorted(AGGREGATIONS))
def test_aggregation_by_name_matches_jax(name):
    names, shapes, seq = AGGREGATIONS[name]
    vals, masks = _feats(names, shapes, seq=seq)
    jfn = jagg.TabularAggregation.parse(name)
    tfn = tagg.TabularAggregation.parse(name)
    assert type(tfn).__name__ == type(jfn).__name__
    jout = jfn(_wrap(vals, masks, False))
    w = rand(*np.asarray(jout).shape, seed=3)
    jgrads = jax.grad(lambda v: jnp.sum(jfn({k: (JSeq(x, jnp.asarray(masks[k])) if k in masks
                                                else x) for k, x in v.items()}) * w))(
        {k: jnp.asarray(v) for k, v in vals.items()})
    tin = _wrap(vals, masks, True)
    tout = tfn(tin)
    (tout * torch.from_numpy(w)).sum().backward()
    close(tout, jout)
    for k in vals:
        leaf = tin[k].values if isinstance(tin[k], SequenceFeature) else tin[k]
        close(leaf.grad, jgrads[k])


def test_sum_residual_matches_jax():
    vals, _ = _feats(["shortcut", "a", "b"], [(4, 3)] * 3)
    jout = jagg.SumResidual(activation="relu")({k: jnp.asarray(v) for k, v in vals.items()})
    tout = tagg.SumResidual(activation="relu")({k: torch.from_numpy(v) for k, v in vals.items()})
    close(tout, jout)


def test_registries_hold_the_jax_names():
    for name in ("concat", "stack", "sum", "element-wise-sum", "sum-residual", "cosine",
                 "element-wise-multiply", "element-wise-sum-item-multi", "masked_mean",
                 "sequence-mean", "sequence-last"):
        assert name in aggregation_registry
    assert isinstance(block_registry.parse("no-op"), tblock.NoOp)
    with pytest.raises(KeyError, match="not registered"):
        aggregation_registry["nope"]


# ---- combinators ----------------------------------------------------------

def test_parallel_block_with_named_aggregation_and_selection():
    jb = jcomb.ParallelBlock({"x": JMLPBlock([3], seed=1), "y": JMLPBlock([2], seed=2)},
                             aggregation="concat", strict=True)
    tb = tcomb.ParallelBlock({"x": MLPBlock([3], seed=1), "y": MLPBlock([2], seed=2)},
                             aggregation="concat")
    run_both(jb, tb, rand(4, 5))
    assert tb.select_by_name("y") is tb.branches["y"]
    assert isinstance(tb.aggregation, tagg.ConcatFeatures)


def test_parallel_block_of_positional_branches_and_select_by_tag():
    ds = mt.generate_data("e-commerce", num_rows=8)
    user = mt.Embeddings(ds.schema.select_by_tag(mt.Tags.USER), dim=4, device="cpu")
    item = mt.Embeddings(ds.schema.select_by_tag(mt.Tags.ITEM), dim=4, device="cpu")
    pb = tcomb.ParallelBlock(user, item)
    assert list(pb.branches) == ["embeddings", "embeddings_1"]
    assert pb.schema is not None and len(pb.schema) == len(user.schema) + len(item.schema)
    sel = pb.select_by_tag(mt.Tags.ITEM)
    assert list(sel.branches.values()) == [item]


def test_sequential_pre_post_and_fluent_composition():
    def double(x):
        return x * 2

    jb = jcomb.SequentialBlock([JMLPBlock([4], seed=1)], pre=double, post=jblock.NoOp())
    tb = tcomb.SequentialBlock([MLPBlock([4], seed=1)], pre=double, post="no-op")
    run_both(jb, tb, rand(3, 5))
    # a >> b flattens plain SequentialBlocks; connect and repeat add blocks
    a, b = MLPBlock([4]), MLPBlock([3])
    assert len(a >> b) == 2 and len(a.connect(b, tblock.Debug())) == 3
    rep = Dense(5, seed=1).repeat(3)
    assert len(rep) == 3 and rep[1].seed == 1 + 7919
    par = Dense(2).repeat_in_parallel(2, aggregation="concat")
    assert list(par.branches) == ["branch_0", "branch_1"]
    assert par(torch.ones(2, 3)).shape == (2, 4)
    assert isinstance(Dense(1).as_model(), mt.Model)


@pytest.mark.parametrize("kind", ["residual", "shortcut", "branch"])
def test_connect_combinators_match_jax(kind):
    if kind == "residual":
        jb = JMLPBlock([5], seed=1).connect_with_residual(JMLPBlock([5], seed=2),
                                                          activation="relu")
        tb = MLPBlock([5], seed=1).connect_with_residual(MLPBlock([5], seed=2),
                                                         activation="relu")
    elif kind == "shortcut":
        jb = JMLPBlock([5], seed=1).connect_with_shortcut(JMLPBlock([3], seed=2))
        tb = MLPBlock([5], seed=1).connect_with_shortcut(MLPBlock([3], seed=2))
    else:
        jb = JMLPBlock([5], seed=1).connect_branch(JMLPBlock([3], seed=2), JMLPBlock([2], seed=3),
                                                   aggregation="concat")
        tb = MLPBlock([5], seed=1).connect_branch(MLPBlock([3], seed=2), MLPBlock([2], seed=3),
                                                  aggregation="concat")
    run_both(jb, tb, rand(4, 5))


def test_filter_as_tabular_map_values_and_cond_match_jax():
    vals = {"a": rand(4, 3), "b": rand(4, 3, seed=1), "c": rand(4, 3, seed=2)}
    jx = {k: jnp.asarray(v) for k, v in vals.items()}
    tx = {k: torch.from_numpy(v) for k, v in vals.items()}
    for sel, excl in ((["a", "c"], False), ("b", True)):
        assert sorted(tcomb.Filter(sel, exclude=excl)(tx)) == sorted(
            jcomb.Filter(sel, exclude=excl)(jx))
    schema = mt.generate_data("e-commerce", num_rows=4).schema
    jschema = mm.generate_data("e-commerce", num_rows=4).schema
    tf = tcomb.Filter(mt.Tags.USER).set_schema(schema)
    jf = jcomb.Filter(mm.Tags.USER).set_schema(jschema)
    assert tf.schema.column_names == jf.schema.column_names
    with pytest.raises(ValueError, match="set_schema"):
        tcomb.Filter(mt.Tags.USER)(tx)
    assert list(tcomb.AsTabular("out")(tx["a"])) == ["out"]
    close(tcomb.MapValues(tblock.Lambda(torch.tanh))(tx)["b"],
          jcomb.MapValues(jblock.Lambda(jnp.tanh))(jx)["b"])
    tcond = tcomb.Cond(lambda x: x > 0, torch.exp, torch.neg)
    jcond = jcomb.Cond(lambda x: x > 0, jnp.exp, jnp.negative)
    close(tcond(tx["a"]), jcond(jx["a"]))
    close(tcomb.Cond(lambda x: x.sum() > 0, torch.exp)(tx["c"]),
          jcomb.Cond(lambda x: x.sum() > 0, jnp.exp)(jx["c"]))


def test_call_block_passes_only_declared_keywords_and_as_block():
    seen = {}

    def fn(x, training=False):
        seen["training"] = training
        return x

    lam = tblock.as_block(fn)
    assert isinstance(lam, tblock.Lambda) and lam.block_name == "fn"
    lam(torch.ones(1), training=True, context=None, targets=None)
    assert seen == {"training": True}
    assert tblock.call_block(fn, 3, context=1) == 3
    with pytest.raises(TypeError):
        tblock.as_block(3)
    body = MLPBlock([2]) >> tblock.Lambda(torch.relu)
    kinds = [type(b).__name__ for b in tblock.iter_blocks(body)]
    assert kinds[0] == "SequentialBlock" and {"Dense", "Lambda"} <= set(kinds)


def test_model_pre_post_and_first_last():
    ds = mt.generate_data("e-commerce", num_rows=16, seed=3)
    body = mt.InputBlockV2(ds.schema, dim=4, device="cpu") >> MLPBlock([4])
    seen = []
    model = mt.Model(body, mt.OutputBlock(ds.schema), pre=lambda x: seen.append(1) or x)
    assert model.first is body and model.last is model.blocks[-1]
    out = model.predict(ds, batch_size=8, device="cpu")
    assert set(out) == {"click/BinaryOutput", "conversion/BinaryOutput"} and seen


def test_heads_keywords_and_schema_helpers_match_jax():
    """``ModelOutput(task_name=, sample_weight_column=)``,
    ``ContrastiveOutput(query_name=, candidate_name=)``, ``TopKOutput(to_call=)``,
    ``MMOEBlock(gate_block=)``, the schema helpers."""
    from models_tpu.core.types import ModelContext as JContext
    from models_tpu.outputs.base import BinaryOutput as JBinary

    x, w = rand(6, 5), np.abs(rand(6, seed=1))
    jh = JBinary("click", task_name="ctr", sample_weight_column="w")
    jpred = jh(jnp.asarray(x), targets={"click": jnp.ones(6)},
               context=JContext(features={"w": jnp.asarray(w)}))
    th = mt.BinaryOutput("click", task_name="ctr", sample_weight_column="w")
    th(torch.from_numpy(x))  # build
    mt.load_jax_params(th, jax_params(jh))
    tpred = th(torch.from_numpy(x), targets={"click": torch.ones(6)},
               context=mt.core.ModelContext(features={"w": torch.from_numpy(w)}))
    assert th.block_name == jh.block_name == "ctr"
    close(tpred.outputs, jpred.outputs)
    close(tpred.sample_weight, jpred.sample_weight)
    head = mt.ContrastiveOutput(negative_samplers="in-batch", query_name="q", candidate_name="c",
                                target="item")
    assert (head.query_name, head.candidate_name) == ("q", "c")
    layer = mt.BruteForce(k=3)
    assert mt.TopKOutput(k=3, to_call=layer).topk_layer is layer
    gate = Dense(2)
    assert mt.MMOEBlock(["a", "b"], (4,), in_features=3, num_experts=2, gate_block=gate,
                        device="cpu").experts.out_features == 4
    jschema = mm.generate_data("e-commerce", num_rows=2).schema
    tschema = mt.generate_data("e-commerce", num_rows=2).schema
    assert mt.categorical_cardinalities(tschema) == mm.schema.categorical_cardinalities(jschema)
    assert mt.categorical_domains(tschema) == mm.schema.categorical_domains(jschema)
