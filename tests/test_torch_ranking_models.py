"""The port's ranking models (DLRM, DCN-v2 stacked and parallel with low
rank, DeepFM, NCF) against the JAX package's, on the CPU.

Both packages draw the same rows from one seed; the JAX model's parameters
(and BatchNorm's running statistics) are carried over with
``load_jax_params``. Then, for each model: ``predict`` (the heads'
activations) within atol 1e-6; three adagrad steps at lr 0.05 in batches of
64, unshuffled, with the heads' default metrics: every logged loss within
rtol 1e-5, the metrics within atol 1e-6 (the same counts), every parameter
within rtol 1e-4, atol 1e-6 (fp32 sums in another order, compounded over
three steps); then ``evaluate`` (loss rtol 1e-5, metrics atol 1e-6) and
``predict`` again.

The binary heads' loss: the JAX package's form ``max(x, 0) - x y +
log1p(exp(-|x|))`` has the gradient ``-y`` at a logit of exactly 0 (JAX
takes ``|x|``'s derivative there as 1), where ``sigmoid(0) - y`` is right;
the port's loss has the right one. A dead ReLU layer gives such logits (the
stacked DCN here has one row of them), so the JAX reference trains with the
same loss written as ``softplus(x) - x y`` (the ``jax_bce`` fixture), whose
gradient is right everywhere (``tests/test_torch_ranking_metrics.py`` holds
both forms at 0).

The DLRM's row-sparse training is held against the JAX package's row-sparse
trajectory. The JAX ``DLRMBlock`` calls its embeddings without the context
(``models_tpu/blocks/dlrm.py:56``), so its row-sparse ``fit`` finds no
lookup and raises; the test threads the context through (the function the
JAX package means, ROADMAP.md queue 3) by patching that one call.
"""

import jax
import numpy as np
import pytest
import torch
from flax import nnx

import models_tpu.losses as jlosses
import models_tpu.blocks.dlrm as jdlrm
from models_tpu.blocks.mlp import MLPBlock as JMLPBlock
from models_tpu.data import Loader as JLoader
from models_tpu.data import generate_data as jax_generate
from models_tpu.models import DCNModel as JDCN
from models_tpu.models import DeepFMModel as JDeepFM
from models_tpu.models import DLRMModel as JDLRM
from models_tpu.models import NCFModel as JNCF
from models_tpu.schema import Schema as JSchema
from models_tpu.schema import Tags as JTags
from models_tpu.schema import ColumnSchema as JColumn
from models_tpu.schema import Domain as JDomain
from models_tpu.schema import create_categorical_column as jcat

import models_tpu_torch as mt
from models_tpu_torch.blocks.mlp import MLPBlock
from models_tpu_torch.schema import ColumnSchema, Domain, Schema, Tags
from models_tpu_torch.schema import create_categorical_column as tcat

BATCH = 64
STEPS = 3


def jax_state(model):
    """Parameters and other variables (BatchNorm's statistics), no slots."""
    return {"/".join(str(p) for p in path): np.asarray(var[...])
            for path, var in nnx.state(model, nnx.Variable).flat_state()
            if "sparse_slots" not in path}


def jax_slots(model):
    return {"/".join(str(p) for p in path): np.asarray(var[...])
            for path, var in nnx.state(model, nnx.Variable).flat_state()
            if "sparse_slots" in path}


def port_state(model, slots=False):
    """The port's parameters and buffers (or its slots) under JAX's names."""
    out = {}
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        if ("sparse_slots" in name) != slots or name.endswith(".offsets"):
            continue
        parts = name.split(".")
        value = t.detach().float().numpy()
        if parts[-1] == "weight":
            parts, value = parts[:-1] + ["kernel"], value.T
        out["/".join(parts)] = value
    return out


def ncf_schemas():
    """user / item ids of small cardinality, a binary and a regression target."""
    def cols(cat, column, domain, tags):
        return [cat("user_id", 499, tags=(tags.USER, tags.USER_ID)),
                cat("item_id", 299, tags=(tags.ITEM, tags.ITEM_ID)),
                column("click", tags=(tags.BINARY_CLASSIFICATION, tags.TARGET), dtype="int32",
                       int_domain=domain(0, 1, is_categorical=False)),
                column("rating", tags=(tags.REGRESSION, tags.TARGET), dtype="float32")]

    return (JSchema(cols(jcat, JColumn, JDomain, JTags)),
            Schema(cols(tcat, ColumnSchema, Domain, Tags)))


def data(name, rows, seed):
    if name == "ncf":
        js, ts = ncf_schemas()
        return jax_generate(js, num_rows=rows, seed=seed), mt.generate_data(ts, num_rows=rows,
                                                                            seed=seed)
    return (jax_generate(name, num_rows=rows, seed=seed),
            mt.generate_data(name, num_rows=rows, seed=seed))


def dcn_bn_deep(ts):
    width = mt.inputs.InputBlockV2(ts, dim=8, device="cpu").out_features
    return (JMLPBlock((16, 8), normalization="batch_norm"),
            MLPBlock((16, 8), normalization="batch_norm", in_features=width, device="cpu"))


CASES = {
    "dlrm": ("criteo-small", lambda js, ts: (
        JDLRM(js, embedding_dim=8, bottom_block=(16,), top_block=(16, 8)),
        mt.DLRMModel(ts, embedding_dim=8, bottom_block=(16,), top_block=(16, 8), device="cpu"))),
    "dcn-stacked": ("e-commerce", lambda js, ts: (
        JDCN(js, depth=2, deep_block=(16, 8), embedding_dim=8),
        mt.DCNModel(ts, depth=2, deep_block=(16, 8), embedding_dim=8, device="cpu"))),
    "dcn-parallel-low-rank": ("e-commerce", lambda js, ts: (
        JDCN(js, depth=1, deep_block=(16,), stacked=False, low_rank_dim=4, embedding_dim=8),
        mt.DCNModel(ts, depth=1, deep_block=(16,), stacked=False, low_rank_dim=4,
                    embedding_dim=8, device="cpu"))),
    "dcn-batch-norm": ("e-commerce", lambda js, ts: (
        JDCN(js, depth=1, deep_block=dcn_bn_deep(ts)[0], embedding_dim=8),
        mt.DCNModel(ts, depth=1, deep_block=dcn_bn_deep(ts)[1], embedding_dim=8,
                    device="cpu"))),
    "deepfm": ("e-commerce", lambda js, ts: (
        JDeepFM(js, embedding_dim=8, deep_block=(16,)),
        mt.DeepFMModel(ts, embedding_dim=8, deep_block=(16,), device="cpu"))),
    "ncf": ("ncf", lambda js, ts: (
        JNCF(js, embedding_dim=8, mlp_block=(16,)),
        mt.NCFModel(ts, embedding_dim=8, mlp_block=(16,), device="cpu"))),
}


def _bce_softplus(labels, logits, sample_weight=None):
    labels = labels.reshape(logits.shape).astype(logits.dtype)
    return jlosses._weighted_mean(jax.nn.softplus(logits) - logits * labels, sample_weight)


@pytest.fixture
def jax_bce(monkeypatch):
    """The JAX package's binary heads train with ``softplus(x) - x y``."""
    monkeypatch.setitem(jlosses.loss_registry._store, "binary_crossentropy", _bce_softplus)


def build_pair(case, rows=STEPS * BATCH, seed=4):
    name, make = CASES[case]
    jds, tds = data(name, rows, seed)
    jm, tm = make(jds.schema, tds.schema)
    jm.compile(optimizer="adagrad", learning_rate=0.05)
    jm.build(JLoader(jds, BATCH))
    mt.load_jax_params(tm, jax_state(jm))
    return jds, tds, jm, tm


def assert_state_close(tm, jm, slots=False, rtol=1e-4, atol=1e-6):
    want = jax_slots(jm) if slots else jax_state(jm)
    got = port_state(tm, slots=slots)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=rtol, atol=atol, err_msg=key)


def assert_logs_close(got, want):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if key == "examples_per_sec":
            continue
        if key.startswith("loss") or key == "regularization_loss":
            np.testing.assert_allclose(got[key], value, rtol=1e-5, atol=1e-7, err_msg=key)
        else:
            np.testing.assert_allclose(got[key], value, atol=1e-6, err_msg=key)


def assert_predictions_close(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].shape == np.asarray(want[key]).shape
            np.testing.assert_allclose(got[key], want[key], atol=1e-6, err_msg=key)
    else:
        assert got.shape == np.asarray(want).shape
        np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_matches_jax(case, jax_bce):
    jds, tds, jm, tm = build_pair(case)
    assert_predictions_close(tm.predict(tds, batch_size=BATCH, device="cpu"),
                             jm.predict(jds, batch_size=BATCH))
    tm.compile(optimizer="adagrad", learning_rate=0.05)
    jh = jm.fit(jds, epochs=1, batch_size=BATCH, shuffle=False, verbose=0)
    th = tm.fit(tds, epochs=1, batch_size=BATCH, shuffle=False, device="cpu")
    assert tm._step == STEPS
    assert_logs_close(th.history, jh.history)
    assert_state_close(tm, jm)
    assert_logs_close(tm.evaluate(tds, batch_size=BATCH, device="cpu"),
                      jm.evaluate(jds, batch_size=BATCH))
    assert_predictions_close(tm.predict(tds, batch_size=BATCH, device="cpu"),
                             jm.predict(jds, batch_size=BATCH))


def test_batch_norm_statistics_move_in_training():
    _, tds, _, tm = build_pair("dcn-batch-norm")
    bn = tm.blocks[0].layers[4]
    assert isinstance(bn, mt.blocks.BatchNorm)
    before = bn.mean.clone()
    tm.compile(optimizer="adagrad", learning_rate=0.05, metrics=[])
    tm.fit(tds, epochs=1, batch_size=BATCH, shuffle=False, device="cpu")
    assert not torch.equal(before, bn.mean)


def _dlrm_call_with_context(self, inputs, *, training=False, context=None, **kwargs):
    """``models_tpu/blocks/dlrm.py::DLRMBlock.__call__`` with the context
    passed to the embeddings."""
    import jax.numpy as jnp

    parts = dict(self.embeddings(inputs, context=context))
    bottom_out = None
    if self.continuous is not None:
        cont = self.continuous(inputs)
        x = jnp.concatenate([v for _, v in sorted(cont.items())], axis=-1)
        bottom_out = self.bottom(x, training=training) if self.bottom is not None else x
        parts["__bottom__"] = bottom_out
    interactions = self.interaction(self.stack(parts))
    if bottom_out is not None:
        interactions = jnp.concatenate([bottom_out, interactions], axis=-1)
    return self.top(interactions, training=training) if self.top is not None else interactions


def test_dlrm_row_sparse_matches_jax(monkeypatch, jax_bce):
    """Row-sparse adagrad on the fused table (one table of 26 x 1008 rows),
    dense adagrad on the MLPs; two epochs of three steps."""
    monkeypatch.setattr(jdlrm.DLRMBlock, "__call__", _dlrm_call_with_context)
    jds, tds, jm, tm = build_pair("dlrm")
    kw = dict(optimizer="adagrad", learning_rate=0.05, embedding_optimizer="adagrad",
              metrics=[])
    jm.compile(**kw)
    tm.compile(**kw)
    jh = jm.fit(jds, epochs=2, batch_size=BATCH, shuffle=False, verbose=0)
    th = tm.fit(tds, epochs=2, batch_size=BATCH, shuffle=False, device="cpu")
    assert_logs_close(th.history, jh.history)
    (table,) = tm._sparse_tables
    assert isinstance(table, mt.inputs.FusedEmbeddingTables) and table.input_dim == 26 * 1008
    assert_state_close(tm, jm)
    assert_state_close(tm, jm, slots=True)


def _fit(model, ds, spe, epochs=2):
    model.compile(optimizer="adagrad", learning_rate=0.05, steps_per_execution=spe)
    return model.fit(ds, epochs=epochs, batch_size=32, shuffle=True, device="cpu").history


@pytest.mark.parametrize("case", ["dlrm", "dcn-batch-norm"])
def test_steps_per_execution_equals_one_step_at_a_time(case):
    """k = 4 steps a chunk on the packed columns (the eager chunk on the
    CPU) against one step at a time: the same arithmetic in the same order,
    so bit for bit, BatchNorm's statistics and the metrics included."""
    _, tds, _, a = build_pair(case)
    _, _, _, b = build_pair(case)
    ha, hb = _fit(a, tds, 1), _fit(b, tds, 4)
    assert tds._device_train_pack is not None and b._step == a._step == 12
    for key in ha:
        if key != "examples_per_sec":
            assert ha[key] == hb[key], key
    for (name, x), (_, y) in zip(list(a.named_parameters()) + list(a.named_buffers()),
                                 list(b.named_parameters()) + list(b.named_buffers())):
        assert torch.equal(x, y), name


def test_criteo_pack_is_forty_int32_columns_and_round_trips():
    """13 float32 columns bit-cast, 26 int32 ids and the label: 160-byte
    rows, as K9 gathers them on the card; the unpacked continuous columns
    equal the loader's batch bit for bit."""
    ds = mt.generate_data("criteo-small", num_rows=96, seed=1)
    loader = mt.Loader(ds, 32, drop_last=True)
    pack = mt.Model._device_train_pack(loader, torch.device("cpu"))
    assert pack.packed.shape == (96, 40) and pack.packed.dtype == torch.int32
    x, y = mt.Model._make_unpack(pack.spec)(pack.packed[:32])
    hx, hy = next(iter(mt.Loader(ds, 32)))
    for name in [f"I{i}" for i in range(1, 14)]:
        assert x[name].dtype == torch.float32
        assert np.array_equal(x[name].numpy().view(np.int32), hx[name].view(np.int32)), name
    for name in [f"C{i}" for i in range(1, 27)]:
        assert np.array_equal(x[name].numpy(), hx[name]), name
    assert np.array_equal(y.numpy(), hy)


def test_predict_gives_probabilities_and_the_regression_value():
    _, tds, _, tm = build_pair("ncf")
    out = tm.predict(tds, batch_size=50, device="cpu")
    assert sorted(out) == ["click/BinaryOutput", "rating/RegressionOutput"]
    p = out["click/BinaryOutput"]
    assert p.shape == (STEPS * BATCH,) and ((p >= 0) & (p <= 1)).all()
    assert out["rating/RegressionOutput"].shape == (STEPS * BATCH,)


def test_ranking_entry_points_need_a_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    ds = mt.generate_data("criteo-small", num_rows=8, seed=0)
    for make in (lambda: mt.DLRMModel(ds.schema, embedding_dim=8),
                 lambda: mt.DCNModel(ds.schema),
                 lambda: mt.DeepFMModel(ds.schema, embedding_dim=8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
