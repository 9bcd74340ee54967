"""The port's public surface against the JAX package's.

- Every public name of ``dir(models_tpu)`` resolves on ``models_tpu_torch``.
- The JAX package's public methods exist on the port's classes, less the
  JAX-only mechanisms named in ``JAX_ONLY_METHODS`` with their reasons.
- For every callable of both root namespaces, and every public method of
  their classes, JAX's parameter names (less the JAX-only ones of
  ``JAX_ONLY_PARAMS``) are a prefix of the port's, in order, with equal
  defaults: the port's own parameters (``device``, ``in_features``,
  ``generator``, ...) come after all of JAX's.
- ``tests/unit/test_core_dsl.py::test_compat_shims_behave``'s checks in
  torch, the ``MerlinModel`` protocol on a port model, and the repairs of
  two faults on both packages: ``fit`` on fewer rows than one batch raises
  JAX's ``ValueError``, and the constructors' and entry points' signatures.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import models_tpu as mm
import models_tpu_torch as mt

# Methods of the JAX package with no meaning on the port, each with its reason.
JAX_ONLY_METHODS = {
    "state_update_targets": "the nnx state a jitted step writes back; torch "
                            "modules update their buffers in place",
    "to_table": "Dataset.to_table returns a pyarrow Table; the port has no "
                "pyarrow (its columns: Dataset.table / columns / to_numpy_dict)",
    "tree_flatten": "the JAX pytree protocol of SequenceFeature",
    "tree_unflatten": "the JAX pytree protocol of SequenceFeature",
}

# Parameters of the JAX package's callables with no meaning on the port.
JAX_ONLY_PARAMS = {
    "interpret": "runs a Pallas kernel in its interpreter",
    "fused_tile": "the Pallas flash-CE tile",
    "_params": "JAX's private (graphdef, params, rest) of a jitted fit's "
               "validation",
}

# Engine-internal methods whose argument is a JAX pytree by nature.
PYTREE_METHODS = {
    "MultiOptimizer.build": "JAX builds an optax transform over a params "
                            "pytree; the port's takes the named parameters of "
                            "a torch module",
}

NNX_METHODS = set(dir(nnx.Module)) | set(dir(object))


def public_names():
    return sorted(n for n in dir(mm) if not n.startswith("_"))


def test_every_root_name_resolves():
    missing = [n for n in public_names() if not hasattr(mt, n)]
    assert not missing, missing


def _same_default(a, b):
    if a is inspect.Parameter.empty or b is inspect.Parameter.empty:
        return a is b
    if isinstance(b, torch.dtype):  # a JAX dtype against the torch one
        return np.dtype(a).name == str(b).replace("torch.", "")
    if callable(a) or callable(b):
        return type(a) is type(b)
    return a == b


def _params(fn):
    """The parameters of a function, or of a class's constructor (its
    ``__init__``, a NamedTuple's ``__new__``; nnx's metaclass hides the
    constructor from ``inspect.signature(cls)``), less ``self`` and
    ``**kwargs``."""
    if inspect.isclass(fn):
        init = fn.__new__ if fn.__init__ in (object.__init__, tuple.__init__) else fn.__init__
        fn = init
        drop_first = True
    else:
        drop_first = False
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    params = list(sig.parameters.values())[1 if drop_first else 0:]
    return [p for p in params if p.kind is not inspect.Parameter.VAR_KEYWORD]


def _prefix_fault(jfn, tfn):
    """None when JAX's parameters are a prefix of the port's, in order and
    with equal defaults; else what differs."""
    jp, tp = _params(jfn), _params(tfn)
    if jp is None or tp is None:
        return None
    jp = [p for p in jp if p.name not in JAX_ONLY_PARAMS]
    for i, p in enumerate(jp):
        if i >= len(tp) or tp[i].name != p.name or tp[i].kind != p.kind:
            return (f"parameter {i}: JAX {[q.name for q in jp]}, "
                    f"port {[q.name for q in tp]}")
        if not _same_default(p.default, tp[i].default):
            return f"{p.name}: default {p.default!r} in JAX, {tp[i].default!r} in the port"
    return None


def _shared_callables():
    for name in public_names():
        jo, to = getattr(mm, name), getattr(mt, name)
        if inspect.ismodule(jo) or not callable(jo):
            continue
        yield name, jo, to
        if not (inspect.isclass(jo) and inspect.isclass(to)):
            continue
        for attr in sorted(dir(jo)):
            if attr.startswith("_") or attr in NNX_METHODS or attr in JAX_ONLY_METHODS:
                continue
            static = inspect.getattr_static(jo, attr, None)
            if isinstance(static, property) or not callable(getattr(jo, attr, None)):
                continue
            yield f"{name}.{attr}", getattr(jo, attr), getattr(to, attr, None)


def test_jax_methods_exist_on_the_port():
    missing = []
    for name in public_names():
        jo, to = getattr(mm, name), getattr(mt, name)
        if not (inspect.isclass(jo) and inspect.isclass(to)):
            continue
        for attr in dir(jo):
            if attr.startswith("_") or attr in NNX_METHODS or attr in JAX_ONLY_METHODS:
                continue
            if not hasattr(to, attr):
                missing.append(f"{name}.{attr}")
    assert not missing, missing


def test_jax_parameters_are_a_prefix_of_the_port_s():
    faults = {}
    for label, jfn, tfn in _shared_callables():
        if label in PYTREE_METHODS or tfn is None:
            continue
        fault = _prefix_fault(jfn, tfn)
        if fault:
            faults[label] = fault
    assert not faults, "\n".join(f"{k}: {v}" for k, v in sorted(faults.items()))


def _submodule_pairs():
    """Callables off the root that the two packages share by path."""
    import models_tpu.inputs.continuous as jco
    import models_tpu.inputs.embedding as jemb
    import models_tpu.losses as jlosses
    import models_tpu.utils.callbacks as jcb
    import models_tpu_torch.inputs.continuous as tco
    import models_tpu_torch.inputs.embedding as temb
    import models_tpu_torch.losses as tlosses
    import models_tpu_torch.utils.callbacks as tcb

    return {
        "ProfilerCallback": (jcb.ProfilerCallback, tcb.ProfilerCallback),
        "get_loss": (jlosses.get_loss, tlosses.get_loss),
        "FusedEmbeddingTables": (jemb.FusedEmbeddingTables, temb.FusedEmbeddingTables),
        "Continuous.set_schema": (jco.Continuous.set_schema, tco.Continuous.set_schema),
        "BaseModel": (mm.BaseModel, mt.BaseModel),
    }


@pytest.mark.parametrize("name", sorted(_submodule_pairs()))
def test_named_signatures_off_the_root(name):
    jfn, tfn = _submodule_pairs()[name]
    assert _prefix_fault(jfn, tfn) is None, _prefix_fault(jfn, tfn)


def test_compat_shims_behave():
    """``tests/unit/test_core_dsl.py::test_compat_shims_behave`` in torch."""
    w = np.arange(20, dtype=np.float32).reshape(5, 4)
    t = mt.EmbeddingTable(4, mt.create_categorical_column("x", 4),
                          initializer=mt.TensorInitializer(w), device="cpu")
    np.testing.assert_allclose(t.embeddings.detach().numpy(), w)

    sf = mt.SequenceFeature(torch.ones(2, 3), torch.ones(2, 3, dtype=torch.bool))
    assert isinstance(mt.ToDense()({"s": sf})["s"], torch.Tensor)
    assert mt.ToSparse()(sf) is sf
    out = mt.ToOneHot(5)(torch.tensor([1, 3]))
    assert out.shape == (2, 5) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(mm.ToOneHot(5)(jnp.array([1, 3]))))

    opts = mt.EmbeddingOptions(embedding_dim_default=16)
    emb = mt.Embeddings(mt.Schema([mt.create_categorical_column("a", 10)]),
                        **opts.to_kwargs(), device="cpu")
    assert emb["a"].dim == 16

    agg = mt.SequenceAggregator("mean")
    out = agg({"s": mt.SequenceFeature(torch.ones(1, 2, 4), torch.ones(1, 2, dtype=torch.bool))})
    np.testing.assert_allclose(out.numpy(), 1.0)


def test_ported_methods_match_jax():
    """The methods this slice adds, on the same inputs in both packages."""
    vals = np.arange(12, dtype=np.float32).reshape(2, 3, 2)
    mask = np.array([[True, True, False], [True, False, False]])
    jsf = mm.SequenceFeature(jnp.asarray(vals), jnp.asarray(mask))
    tsf = mt.SequenceFeature(torch.from_numpy(vals), torch.from_numpy(mask))
    np.testing.assert_array_equal(tsf.masked(-1).numpy(), np.asarray(jsf.masked(-1)))
    assert tsf.with_values(tsf.values + 1).mask is tsf.mask
    assert tsf.with_mask(~tsf.mask).values is tsf.values
    assert tsf.dtype == torch.float32
    offsets, flat = np.array([0, 2, 5]), np.arange(5, dtype=np.int32)
    jr = mm.SequenceFeature.from_values_offsets(flat, offsets, 4)
    tr = mt.SequenceFeature.from_values_offsets(flat, offsets, 4)
    np.testing.assert_array_equal(tr.values, jr.values)
    np.testing.assert_array_equal(tr.mask, jr.mask)

    scores = np.array([[3.0, 2.0, 1.0]], np.float32)
    ids = np.array([[7, 5, 9]], np.int32)
    jp = mm.TopKPrediction(jnp.asarray(scores), jnp.asarray(ids)).with_k(2)
    tp = mt.TopKPrediction(torch.from_numpy(scores), torch.from_numpy(ids)).with_k(2)
    np.testing.assert_array_equal(tp.identifiers.numpy(), np.asarray(jp.identifiers))
    jdf, tdf = jp.to_df().to_numpy_dict(), tp.to_df().to_numpy_dict()
    for key in ("top_ids", "top_scores"):
        np.testing.assert_array_equal(tdf[key + "__values"], jdf[key + "__values"])
        np.testing.assert_array_equal(tdf[key + "__offsets"], jdf[key + "__offsets"])
        assert tdf[key + "__values"].dtype == jdf[key + "__values"].dtype

    ctx = mt.ModelContext()
    ctx.mask = torch.ones(2)
    assert ctx.mask is ctx["mask"]
    assert mt.Prediction(torch.ones(1)).predictions is not None
    assert mt.Prediction._fields == mm.Prediction._fields

    schema = mt.generate_data("movielens-25m", num_rows=4).schema
    copy = schema.copy()
    assert copy == schema and copy.column_schemas[0] is not schema.column_schemas[0]
    assert schema.remove_by_tag(mt.Tags.USER) == schema.excluding_by_tag(mt.Tags.USER)
    assert schema.remove_col("userId") == schema.excluding_by_name("userId")

    bf = mt.BruteForce(k=2).index(torch.randn(13, 4), device="cpu")
    assert bf.num_candidates == 13
    head = mt.CategoricalTarget(6, in_features=4, device="cpu")
    np.testing.assert_array_equal(head.embedding_lookup(torch.tensor([1, 4])).detach().numpy(),
                                  head.embeddings[[1, 4]].detach().numpy())
    table = mt.EmbeddingTable(3, mt.create_categorical_column("item", 9), device="cpu")
    assert mt.EmbeddingTablePrediction(table).embeddings is table.embeddings or torch.equal(
        mt.EmbeddingTablePrediction(table).embeddings, table.embeddings)


def test_merlin_model_protocol_on_a_port_model():
    """``tests/unit/test_backends.py:66-80`` on the port's models."""
    schema = mt.Schema([
        mt.create_categorical_column("user_id", 10, tags=(mt.Tags.USER, mt.Tags.USER_ID)),
        mt.create_categorical_column("item_id", 10, tags=(mt.Tags.ITEM, mt.Tags.ITEM_ID)),
    ])
    assert isinstance(mt.MatrixFactorizationModel(schema, dim=4, device="cpu"), mt.MerlinModel)
    assert isinstance(mt.api.MerlinModel, type) and mt.MerlinModel is mt.api.MerlinModel


def _mf(pkg, **dev):
    ds = pkg.generate_data("movielens-25m", num_rows=300)
    model = pkg.MatrixFactorizationModel(ds.schema, dim=4, **dev)
    model.compile(optimizer="adagrad", learning_rate=0.05, metrics=[])
    return model, ds


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_fit_on_fewer_rows_than_a_batch_raises(pkg):
    """A fit whose loader yields no full batch raises the JAX package's
    ``ValueError`` in both packages, where the port ran no step and
    returned zeros (a model with no lazy layer draws no batch to build)."""
    model, ds = _mf(mm) if pkg == "jax" else _mf(mt, device="cpu")
    kw = {} if pkg == "jax" else {"device": "cpu"}
    with pytest.raises(ValueError, match=r"Loader produced no batches: dataset has 300 rows "
                                         r"for batch_size=512 \(drop_last=True\)"):
        model.fit(ds, epochs=1, batch_size=512, **kw)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_fit_prints_a_line_an_epoch_by_default(pkg, capsys):
    model, ds = _mf(mm) if pkg == "jax" else _mf(mt, device="cpu")
    kw = {} if pkg == "jax" else {"device": "cpu"}
    model.fit(ds, epochs=2, batch_size=100, **kw)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("Epoch ")]
    assert [ln.split(" - ")[0] for ln in lines] == ["Epoch 1/2", "Epoch 2/2"]
    assert " - loss: " in lines[0]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_retrieval_model_v2_forms(pkg):
    """``RetrievalModelV2(query=q, output=o)`` is the tied form (no
    candidate tower), and ``RetrievalModelV2(encoder, head)`` takes the
    blocks in a row: in both packages."""
    p = mm if pkg == "jax" else mt
    dev = {} if pkg == "jax" else {"device": "cpu"}
    schema = p.generate_data("movielens-25m", num_rows=8).schema
    item_col = schema.item_id_column
    table = p.EmbeddingTable(4, item_col, **dev)
    query = p.EmbeddingEncoder(p.EmbeddingTable(4, schema.user_id_column, **dev))
    head = p.ContrastiveOutput(table)
    tied = p.RetrievalModelV2(query=query, output=head, schema=schema)
    assert tied.query_encoder is query and tied.candidate_encoder is None
    assert tied.contrastive_output is head
    blocks = p.RetrievalModelV2(query, head)
    assert blocks.query_encoder is query and blocks.contrastive_output is head
    assert blocks.candidate_encoder is None


def test_the_remaining_signature_defaults():
    assert inspect.signature(mt.CategoricalOutput).parameters["to_call"].default is None
    assert mt.CategoricalOutput().to_call is None
    assert mt.Precision().name == "precision" and mt.Recall().name == "recall"
    with pytest.raises(TypeError):
        mt.MultiOptimizer()
    gate = mt.ExpertsGate(3, seed=1, in_features=5, device="cpu")
    assert gate.gate.weight.shape == (3, 5)
    dense = mt.Dense(6, seed=3)
    dense.build(torch.zeros(2, 12))
    assert dense.weight.shape == (6, 12) and dense.built
    ref = mt.Dense(6, seed=3, in_features=12, device="cpu")
    assert torch.equal(dense.weight, ref.weight)
    width = mt.Dense(6, seed=3)
    width.build(12, device="cpu")
    assert torch.equal(width.weight, ref.weight)
