"""The port's Wide&Deep model against the JAX package's, on the CPU.

The wide path's two forms: the port sums the wide kernel's entries at each
column's ids (and at each cross's bucket), the JAX package multiplies the
kernel by the dense multi-hot encoding; they agree within rtol 1e-5, atol
1e-6 (one fp32 sum of a few hundred terms in another order), for scalar and
list columns (a row's repeated ids once under ``multi_hot``). The whole
model, its parameters carried over with ``load_jax_params``: ``predict``
within atol 1e-6; three adagrad steps at lr 0.05 in batches of 32,
unshuffled, dense and row-sparse: the losses within rtol 1e-5, every
parameter within rtol 1e-4, atol 1e-6; ``evaluate`` alike.
"""

import jax
import numpy as np
import pytest
import torch
from flax import nnx

import models_tpu as mm
import models_tpu.losses as jlosses
from models_tpu.models.ranking import _WidePath as JWidePath
from models_tpu.schema import Schema as JSchema
from models_tpu.schema import Tags as JTags
from models_tpu.schema import create_categorical_column as jcat
from models_tpu.schema import create_continuous_column as jcont

import models_tpu_torch as mt
from models_tpu_torch.core.types import to_device_batch
from models_tpu_torch.models.ranking import _WidePath
from models_tpu_torch.schema import Schema, Tags
from models_tpu_torch.schema import create_categorical_column as tcat
from models_tpu_torch.schema import create_continuous_column as tcont

BATCH, STEPS = 32, 3


def schemas(list_col=False):
    def cols(cat, cont, tags):
        out = [cat(f"c{i}", card, tags=(tags.CATEGORICAL,))
               for i, card in enumerate((40, 9, 120, 25))]
        if list_col:
            out.append(cat("tags", 30, tags=(tags.CATEGORICAL,), is_list=True, max_seq_length=6))
        out += [cont("x0"), cont("x1"),
                cat("label", 1, tags=(tags.TARGET, tags.BINARY_CLASSIFICATION))]
        return out

    return JSchema(cols(jcat, jcont, JTags)), Schema(cols(tcat, tcont, Tags))


def jax_state(model):
    return {"/".join(str(p) for p in path): np.asarray(v[...])
            for path, v in nnx.state(model, nnx.Variable).flat_state()
            if "sparse_slots" not in path}


def port_state(model):
    out = {}
    for name, t in model.state_dict().items():  # no non-persistent buffer
        if "sparse_slots" in name:
            continue
        parts, value = name.split("."), t.detach().numpy()
        if parts[-1] == "weight":
            parts, value = parts[:-1] + ["kernel"], value.T
        out["/".join(parts)] = value
    return out


def close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


@pytest.fixture
def jax_bce(monkeypatch):
    """The JAX binary heads train with ``softplus(x) - x y`` (the gradient at
    a zero logit, as ``tests/test_torch_ranking_models.py`` explains)."""
    def bce(labels, logits, sample_weight=None):
        labels = labels.reshape(logits.shape).astype(logits.dtype)
        return jlosses._weighted_mean(jax.nn.softplus(logits) - logits * labels, sample_weight)

    monkeypatch.setitem(jlosses.loss_registry._store, "binary_crossentropy", bce)


@pytest.mark.parametrize("case", ["crosses", "lists-multi-hot", "lists-count"])
def test_wide_path_gathered_form_equals_the_dense_form_and_jax(case):
    lists = case != "crosses"
    js, ts = schemas(list_col=lists)
    tds = mt.generate_data(ts, num_rows=64, seed=3)
    jwide = JWidePath(js, crosses=not lists, seed=2)
    wide = _WidePath(ts, crosses=not lists, seed=2, device="cpu")
    if case == "lists-count":
        jwide.encoding.output_mode = wide.encoding.output_mode = "count"
    tx, _ = next(iter(mt.Loader(tds, 64)))
    tx = to_device_batch(tx, "cpu")
    if lists:  # a repeated id in every row
        v = tx["tags"].values
        v[:, 1] = v[:, 0]
    jx = {k: (mm.SequenceFeature(np.asarray(v.values), np.asarray(v.mask))
              if isinstance(v, mt.SequenceFeature) else np.asarray(v)) for k, v in tx.items()}
    jout = jwide(mm.core.types.to_device_batch(jx))
    mt.load_jax_params(wide, jax_state(jwide))
    assert wide.linear.weight.shape == (1, jwide.linear.kernel.shape[0])
    gathered = wide(tx)
    close(gathered.detach(), wide.dense_forward(tx).detach())
    close(gathered.detach(), jout)
    g = torch.autograd.grad(gathered.square().sum(), wide.linear.weight)[0]
    d = torch.autograd.grad(wide.dense_forward(tx).square().sum(), wide.linear.weight)[0]
    close(g, d)


def build_pair(rows=STEPS * BATCH, seed=4):
    js, ts = schemas()
    jds = mm.generate_data(js, num_rows=rows, seed=seed)
    tds = mt.generate_data(ts, num_rows=rows, seed=seed)
    jm = mm.WideAndDeepModel(js, embedding_dim=8, deep_block=(16, 8), seed=1)
    tm = mt.WideAndDeepModel(ts, embedding_dim=8, deep_block=(16, 8), seed=1, device="cpu")
    jm.build(mm.Loader(jds, BATCH))
    mt.load_jax_params(tm, jax_state(jm))
    return jds, tds, jm, tm


@pytest.mark.parametrize("sparse", [False, True])
def test_wide_and_deep_matches_jax(sparse, jax_bce):
    jds, tds, jm, tm = build_pair()
    close(tm.predict(tds, batch_size=BATCH, device="cpu"), jm.predict(jds, batch_size=BATCH))
    kw = dict(optimizer="adagrad", learning_rate=0.05)
    if sparse:
        kw.update(embedding_optimizer="adagrad", metrics=[])
    jm.compile(**kw)
    tm.compile(**kw)
    jh = jm.fit(jds, epochs=1, batch_size=BATCH, shuffle=False, verbose=0)
    th = tm.fit(tds, epochs=1, batch_size=BATCH, shuffle=False, device="cpu")
    for key, value in jh.history.items():
        if key.startswith("loss"):
            close(th.history[key], value, atol=1e-7, msg=key)
    if sparse:
        assert len(tm._sparse_tables) == 4
    want, got = jax_state(jm), port_state(tm)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        close(got[key], value, rtol=1e-4, msg=key)
    jev, tev = jm.evaluate(jds, batch_size=BATCH), tm.evaluate(tds, batch_size=BATCH, device="cpu")
    close(tev["loss"], jev["loss"])
    if not sparse:
        close(tev["label/auc"] if "label/auc" in tev else tev["auc"],
              jev["label/auc"] if "label/auc" in jev else jev["auc"])


def test_wide_and_deep_on_criteo_small_has_the_full_wide_width():
    schema = mt.generate_data("criteo-small", num_rows=2).schema
    tm = mt.WideAndDeepModel(schema, device="cpu")
    wide = tm.blocks[0].branches["wide"]
    cards = [c.cardinality for c in schema.categorical]
    assert len(cards) == 26 and wide.linear.weight.shape == (1, sum(cards) + 325 * 1000)
    assert len(wide.crosses.crosses) == 325
    ds = mt.generate_data("criteo-small", num_rows=64, seed=1)
    x, _ = next(iter(mt.Loader(ds, 64)))
    x = to_device_batch(x, "cpu")
    close(wide(x).detach(), wide.dense_forward(x).detach())
