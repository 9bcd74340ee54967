"""The port's pairwise ranking losses and the contrastive head's choice of
route against the JAX package's, on the CPU.

Each pairwise loss (column 0 the positive, 1..N the negatives) under each of
the JAX package's registry names, with no weight, (B,) weights and (B, 1+N)
per-candidate weights (``_weighted_mean``'s 2-D rules): the value within
rtol 1e-5 and the gradient within 1e-5 of its largest element (float32
softmaxes and sums of N terms taken in another order: about 1e-6 apart).
The matrix factorization compiled with ``loss="bpr", metrics=[]`` trains on
bpr, not on the fused softmax CE: its
three steps equal the JAX model's with ``fused_loss=False`` (losses rtol
1e-5, tables atol 1e-6) and differ from the CE model's. (The JAX model's
default route gives CE's loss under ``loss="bpr"``, ROADMAP.md queue 3.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from models_tpu import losses as jlosses
from models_tpu.data import Loader as JLoader
from models_tpu.data import generate_data as jax_generate
from models_tpu.models import MatrixFactorizationModel as JMF
from models_tpu.registry import loss_registry

import models_tpu_torch as mt
from models_tpu_torch import losses as tlosses
from models_tpu_torch.core.types import ModelContext
from models_tpu_torch.outputs.contrastive import ContrastiveOutput, ContrastiveSampleWeight
from models_tpu_torch.schema import Tags
from models_tpu_torch.schema import create_categorical_column as tcat

PAIRWISE = ["bpr", "bpr-max", "bpr_max", "bpr-max-paper", "bpr_max_paper", "top1", "top1_v2",
            "top1-v2", "top1_max", "top1-max", "logistic", "hinge"]
B, N = 6, 9


def _inputs(weights):
    rng = np.random.default_rng(len(weights))
    logits = rng.normal(scale=2.0, size=(B, 1 + N)).astype(np.float32)
    labels = np.zeros_like(logits)
    labels[:, 0] = 1.0
    w = {"none": None,
         "rows": rng.uniform(0.1, 2.0, B).astype(np.float32),
         "candidates": rng.uniform(0.1, 2.0, (B, 1 + N)).astype(np.float32)}[weights]
    return logits, labels, w


@pytest.mark.parametrize("weights", ["none", "rows", "candidates"])
@pytest.mark.parametrize("name", PAIRWISE)
def test_pairwise_loss_matches_jax(name, weights):
    logits, labels, w = _inputs(weights)
    jfn = loss_registry[name]
    jw = None if w is None else jnp.asarray(w)
    want, jgrad = jax.value_and_grad(
        lambda x: jfn(jnp.asarray(labels), x, jw))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = tlosses.get_loss(name)(torch.from_numpy(labels), x,
                                 None if w is None else torch.from_numpy(w))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    scale = float(jnp.abs(jgrad).max())
    assert float(np.abs(x.grad.numpy() - np.asarray(jgrad)).max()) <= 1e-5 * max(scale, 1e-6)


def test_every_jax_loss_name_resolves_in_the_port():
    for name in sorted(loss_registry._store):
        assert callable(tlosses.get_loss(name)), name
    with pytest.raises(KeyError, match="nope"):
        tlosses.get_loss("nope")


@pytest.mark.parametrize("fn", ["categorical_crossentropy", "binary_crossentropy"])
def test_two_d_weights_on_rowwise_and_elementwise_losses(fn):
    """(B, 1+N) weights: the softmax CE takes the positive's column, the
    binary CE weighs each element."""
    logits, labels, w = _inputs("candidates")
    want = getattr(jlosses, fn)(jnp.asarray(labels), jnp.asarray(logits), jnp.asarray(w))
    got = getattr(tlosses, fn)(torch.from_numpy(labels), torch.from_numpy(logits),
                               torch.from_numpy(w))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def _head(post=None, fused_loss="auto"):
    col = tcat("item_id", 19, tags=(Tags.ITEM, Tags.ITEM_ID))
    table = mt.inputs.EmbeddingTable(4, col, seed=0, device="cpu")
    return ContrastiveOutput(table, negative_samplers="in-batch", post=post,
                             fused_loss=fused_loss)


@pytest.mark.parametrize("case", ["cce", "default", "bpr", "fused_loss=False", "post"])
def test_the_head_fuses_only_the_categorical_ce(case):
    """A training step that needs no logits takes the fused loss only where
    the head's compiled loss is the categorical CE and nothing else asks
    for the logits."""
    head = _head(post=ContrastiveSampleWeight(2.0) if case == "post" else None,
                 fused_loss=False if case == "fused_loss=False" else "auto")
    losses = {"cce": tlosses.categorical_crossentropy, "bpr": tlosses.bpr_loss}
    ctx = ModelContext(features={"item_id": torch.tensor([3, 5, 7])}, need_logits=False)
    if case in losses:
        ctx["head_losses"] = {head.block_name: losses[case]}
    pred = head(torch.randn(3, 4), training=True, context=ctx)
    fused = case in ("cce", "default")
    assert (pred.precomputed_loss is not None) == fused
    if not fused:
        assert pred.outputs.shape == (3, 4)


def _mf_pair(loss, fused_loss=False):
    jds = jax_generate("movielens-25m", num_rows=3 * 64, seed=0)
    tds = mt.generate_data("movielens-25m", num_rows=3 * 64, seed=0)
    jm = JMF(jds.schema, dim=8, seed=3)
    jm.contrastive_output.fused_loss = fused_loss
    kw = dict(optimizer="adagrad", learning_rate=0.05, loss=loss, metrics=[])
    jm.compile(**kw)
    jm.build(JLoader(jds, 64))
    tm = mt.MatrixFactorizationModel(tds.schema, dim=8, seed=3, device="cpu")
    tm.compile(**kw)
    mt.load_jax_params(tm, {"/".join(str(p) for p in path): np.asarray(v[...])
                            for path, v in nnx.state(jm, nnx.Param).flat_state()})
    jh = jm.fit(jds, batch_size=64, shuffle=False, verbose=0).history
    th = tm.fit(tds, batch_size=64, shuffle=False, device="cpu").history
    return jm, tm, jh, th


def test_bpr_without_metrics_trains_on_bpr():
    jm, tm, jh, th = _mf_pair("bpr")
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5)
    jp = {"/".join(str(p) for p in path): np.asarray(v[...])
          for path, v in nnx.state(jm, nnx.Param).flat_state()}
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jp[name.replace(".", "/")], rtol=0,
                                   atol=1e-6, err_msg=name)
    _, _, jce, ce = _mf_pair("categorical_crossentropy", fused_loss="auto")
    assert abs(th["loss"][0] - ce["loss"][0]) > 1.0  # bpr (about 0.69) is not the CE (about 4.3)
    # the reference's fault: its default route trains on the CE under "bpr"
    _, _, jauto, tauto = _mf_pair("bpr", fused_loss="auto")
    assert jauto["loss"] == jce["loss"] and tauto["loss"] == th["loss"]
