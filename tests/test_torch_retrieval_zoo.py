"""The port's retrieval zoo beyond the two-tower model's defaults (the
matrix factorization, YouTube-DNN, the two-tower model's ``post``,
``l2_norm`` and Block towers, the V1 retrieval blocks, ``EmbeddingEncoder``,
``DotProduct``, the tied ``CategoricalOutput``, ``L2Norm``, the
beyond-accuracy metrics and ``TopKLayer``) against the JAX package's, on
the CPU.

Both packages draw the same rows from one seed (``movielens-25m``: 162,541
users, 56,680 items; batches of 64, dim 8) and the JAX model's parameters
are carried over with ``load_jax_params``. Tolerances, each with its
reason:

- trajectories (adagrad, lr 0.05, three steps): every logged loss rtol
  1e-5, every float32 parameter atol 1e-6 (float32 sums in another order);
  a bf16 table bit for bit, its stochastic rounding given JAX's bits (as
  ``tests/test_torch_sparse_training.py`` gives them);
- forwards and served scores atol 2e-5 (three float32 layers), served ids
  equal (the scores are tie-free);
- the corpus ``evaluate``: loss rtol 1e-5, metrics atol 1e-6 (the same
  ranks); the beyond-accuracy metrics rtol 1e-6 (one float32 sum).

The popularity sampler is given JAX's draws for each step (JAX folds the
step into its key; the port draws from a generator).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from models_tpu.blocks import retrieval as jblocks
from models_tpu.core.types import ModelContext as JContext
from models_tpu.data import Loader as JLoader
from models_tpu.data import generate_data as jax_generate
from models_tpu.inputs.embedding import EmbeddingTable as JTable
from models_tpu.metrics import evaluation as jeval
from models_tpu.models import MatrixFactorizationModel as JMF
from models_tpu.models import TwoTowerModel as JTwoTower
from models_tpu.models import YoutubeDNNRetrievalModel as JYT
from models_tpu.outputs import ContrastiveSampleWeight as JCSW
from models_tpu.outputs.base import CategoricalOutput as JCategorical
from models_tpu.outputs.base import DotProduct as JDot
from models_tpu.outputs.queue import CachedCrossBatchSampler as JCross
from models_tpu.outputs.sampling import PopularityBasedSampler as JPop
from models_tpu.schema import Tags as JTags
from models_tpu.transforms.bias import PopularityLogitsCorrection as JPLC
from models_tpu.transforms.regularization import L2Norm as JL2Norm

import models_tpu_torch as mt
from models_tpu_torch.blocks import retrieval as tblocks
from models_tpu_torch.core.encoder import EmbeddingEncoder
from models_tpu_torch.core.types import ModelContext
from models_tpu_torch.metrics import evaluation as teval
from models_tpu_torch.outputs import (CachedCrossBatchSampler, CategoricalOutput,
                                      ContrastiveSampleWeight, DotProduct, TopKLayer)
from models_tpu_torch.outputs.sampling import PopularityBasedSampler
from models_tpu_torch.outputs.topk import BruteForce
from models_tpu_torch.schema import Tags
from models_tpu_torch.transforms import L2Norm, PopularityLogitsCorrection

B, DIM, LR = 64, 8, 0.05
CATALOG = 56_681  # movieIds 0..56680


def jax_vars(model, kind=nnx.Variable):
    return {"/".join(str(p) for p in path): np.asarray(v[...])
            for path, v in nnx.state(model, kind).flat_state()}


def jax_noise(shape, salt, step, device):
    """The stochastic-rounding bits the JAX package draws for (salt, step)."""
    key = jax.random.fold_in(jax.random.key(salt), jnp.asarray(step, jnp.uint32))
    bits = np.asarray(jax.random.bits(key, tuple(shape), jnp.uint32)).view(np.int32)
    return torch.from_numpy(bits.copy()).to(device)


def port_state(model, buffers=True):
    """The port's parameters (and buffers) under the JAX paths (Dense
    weights transposed back to kernels), the row-sparse slots left out."""
    out = {}
    named = list(model.named_parameters()) + (list(model.named_buffers()) if buffers else [])
    for name, t in named:
        if ".sparse_slots." in name:
            continue
        parts = name.split(".")
        if parts[-1] == "weight":
            parts, t = parts[:-1] + ["kernel"], t.T
        out["/".join(parts)] = t.detach()
    return out


def assert_state_close(tm, jm, kind=nnx.Variable, atol=1e-6):
    want = {k: v for k, v in jax_vars(jm, kind).items() if "/sparse_slots/" not in k}
    got = port_state(tm, buffers=kind is not nnx.Param)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        t = got[key]
        if t.dtype == torch.bfloat16:
            bits = np.asarray(value).view(np.int16)
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), bits, err_msg=key)
        elif t.is_floating_point():
            np.testing.assert_allclose(t.numpy(), np.asarray(value, np.float32), rtol=0,
                                       atol=atol, err_msg=key)
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(value), err_msg=key)


def assert_logs_close(got, want):
    for key, value in want.items():
        if key == "examples_per_sec":
            continue
        tol = dict(rtol=1e-5, atol=1e-7) if key.startswith("loss") or \
            key == "regularization_loss" else dict(rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[key], value, err_msg=key, **tol)


def data(rows=3 * B, seed=0):
    return (jax_generate("movielens-25m", num_rows=rows, seed=seed),
            mt.generate_data("movielens-25m", num_rows=rows, seed=seed))


def fit_both(jm, tm, jds, tds, learning_rate=LR, **compile_kw):
    kw = dict(optimizer="adagrad", learning_rate=learning_rate, metrics=[], **compile_kw)
    jm.compile(**kw)
    tm.compile(**kw)
    if tm._emb_opt is not None:
        tm._emb_opt.noise = jax_noise
    jh = jm.fit(jds, epochs=1, batch_size=B, shuffle=False, verbose=0).history
    th = tm.fit(tds, epochs=1, batch_size=B, shuffle=False, device="cpu").history
    assert sorted(th) == sorted(jh)
    assert_logs_close(th, jh)
    return jh, th


def mf_pair(jds, tds, jsamplers="in-batch", tsamplers="in-batch", table_dtype=None, **kw):
    jm = JMF(jds.schema, dim=DIM, seed=3, negative_samplers=jsamplers,
             table_dtype=getattr(jnp, table_dtype) if table_dtype else None, **kw)
    jm.compile(optimizer="adagrad", learning_rate=LR, metrics=[])
    jm.build(JLoader(jds, B))
    tm = mt.MatrixFactorizationModel(tds.schema, dim=DIM, seed=3, negative_samplers=tsamplers,
                                     table_dtype=getattr(torch, table_dtype) if table_dtype
                                     else None, device="cpu", **kw)
    mt.load_jax_params(tm, {k: v for k, v in jax_vars(jm).items() if "/sparse_slots/" not in k})
    return jm, tm


def jax_draws(tsampler, jsampler):
    """Give the port's popularity sampler the JAX sampler's ids, step by
    step, and JAX's probabilities: ``log(id + 2) - log(id + 1)`` cancels in
    float32 (at id 26,783 one ulp of the logs is 2.6% of the difference), and
    torch's and XLA's logs may differ by an ulp there
    (:func:`test_popularity_probabilities_within_the_float32_cancellation`)."""
    calls = []
    tsampler.sampling_probs = lambda ids, max_id: torch.from_numpy(np.array(
        jsampler.sampling_probs(jnp.asarray(ids.numpy()), max_id))).to(ids.device)

    def sample_ids(n, max_id, device):
        key = jax.random.fold_in(jax.random.key(jsampler.seed), len(calls))
        calls.append(None)
        return torch.from_numpy(np.array(jsampler._zipf_sample(key, n, max_id))).to(device)

    tsampler.sample_ids = sample_ids
    return calls


def test_mf_structure_and_defaults():
    jds, tds = data(B)
    jm, tm = mf_pair(jds, tds)
    assert sorted(n for n, _ in tm.named_parameters()) == [
        "_query.block.table", "blocks.1.table.table"]
    assert isinstance(tm.query_encoder, EmbeddingEncoder) and tm.candidate_encoder is None
    assert tm.block_name == "matrix_factorization"
    assert tm.contrastive_output.tying.table is tm.contrastive_output.table
    # dim inferred as the larger of the two columns' widths
    auto = mt.MatrixFactorizationModel(tds.schema, device="cpu")
    assert auto.query_encoder.table.dim == JMF(jds.schema).query_encoder.table.dim == 48
    assert mt.models.MatrixFactorizationModelV2 is mt.MatrixFactorizationModel
    assert mt.models.TwoTowerModelV2 is mt.TwoTowerModel


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_mf_row_sparse_with_cross_batch_matches_jax(table_dtype):
    """Both tables row-sparse (K7 on fp32, stochastic rounding and K8 on
    bf16), the item table tied, ``["in-batch", cross-batch]`` negatives."""
    jds, tds = data()
    jm, tm = mf_pair(jds, tds, ["in-batch", JCross(128, DIM)],
                     ["in-batch", CachedCrossBatchSampler(128, DIM)],
                     table_dtype=None if table_dtype == "float32" else table_dtype)
    fit_both(jm, tm, jds, tds, embedding_optimizer="adagrad")
    assert {t.block_name for t in tm._sparse_tables} == {"userId", "movieId"}
    assert_state_close(tm, jm)
    for t in tm._embedding_tables():
        np.testing.assert_allclose(t.sparse_slots["acc"].numpy(),
                                   jax_vars(jm)[f"{'_query/block' if t.block_name == 'userId' else 'blocks/1/table'}/sparse_slots/acc"],
                                   rtol=1e-6, atol=1e-7)


def small_catalog(num_rows=3 * B, seed=5):
    """Users 0..99 and items 0..29: a batch's positives and the popularity
    sampler's draws share ids."""
    from models_tpu.data import Dataset as JDataset
    from models_tpu.schema import Schema as JSchema
    from models_tpu.schema import create_categorical_column as jcat
    from models_tpu_torch.schema import create_categorical_column as tcat

    rng = np.random.default_rng(seed)
    cols = {"userId": rng.integers(0, 100, num_rows).astype(np.int32),
            "movieId": rng.integers(0, 30, num_rows).astype(np.int32)}
    out = []
    for cat, Schema, T, Dataset in ((jcat, JSchema, JTags, JDataset),
                                    (tcat, mt.Schema, Tags, mt.Dataset)):
        schema = Schema([cat("userId", 99, tags=(T.USER, T.USER_ID)),
                         cat("movieId", 29, tags=(T.ITEM, T.ITEM_ID))])
        out.append(Dataset({k: v.copy() for k, v in cols.items()}, schema=schema))
    return out


def test_tied_table_two_sites_take_the_jax_order():
    """A tied table looked up at two sites in one step (the positives and
    the popularity sampler's negatives, overlapping ids; T = 0.1 and lr 0.5,
    so that the order shows) under the row-sparse adagrad: the JAX package
    applies ``neg`` before ``pos`` (its lookups come back from the traced
    step in sorted key order); the port does too, and the forward's order
    would give another item table."""
    jds, tds = small_catalog()
    jsp = JPop(max_num_samples=16, seed=1)
    tsp = PopularityBasedSampler(max_num_samples=16, seed=1)
    kw = dict(logits_temperature=0.1)
    jm, tm = mf_pair(jds, tds, [jsp], [tsp], **kw)
    jax_draws(tsp, jsp)
    fit_both(jm, tm, jds, tds, embedding_optimizer="adagrad", learning_rate=0.5)
    assert_state_close(tm, jm)
    # the same run with each table's updates in the forward's order
    _, tm2 = mf_pair(jds, tds, [jsp], [tsp], **kw)
    calls = jax_draws(tsp, jsp)
    tm2.compile(optimizer="adagrad", learning_rate=0.5, metrics=[], embedding_optimizer="adagrad")
    sorted_order = mt.Model._apply_sparse

    def in_forward_order(self, lookups):
        for table in self._sparse_tables:
            for t, ids, rows, _ in lookups:
                if t is table:
                    self._emb_opt.apply(table, ids, rows.grad, self._step)

    mt.Model._apply_sparse = in_forward_order
    try:
        tm2.fit(tds, epochs=1, batch_size=B, shuffle=False, device="cpu")
    finally:
        mt.Model._apply_sparse = sorted_order
    assert len(calls) == 3
    item = "blocks/1/table/table"
    gap = float((port_state(tm2)[item] - torch.from_numpy(jax_vars(jm)[item])).abs().max())
    assert gap > 1e-4, gap


def test_mf_l2_reg_and_post_match_jax():
    """``l2_reg`` adds its term to the loss (and the gradient); a
    ``ContrastiveSampleWeight`` post routes the head to its logits."""
    jds, tds = data()
    kw = dict(l2_reg=1e-4)
    jm, tm = mf_pair(jds, tds, post=None, **kw)
    jh, th = fit_both(jm, tm, jds, tds)
    assert th["regularization_loss"][0] > 0
    assert_state_close(tm, jm)
    jm = JMF(jds.schema, dim=DIM, seed=3, post=JCSW(2.0, 0.5))
    jm.compile(optimizer="adagrad", learning_rate=LR, metrics=[])
    jm.build(JLoader(jds, B))
    tm = mt.MatrixFactorizationModel(tds.schema, dim=DIM, seed=3, device="cpu",
                                     post=ContrastiveSampleWeight(2.0, 0.5))
    mt.load_jax_params(tm, jax_vars(jm, nnx.Param))
    fit_both(jm, tm, jds, tds)
    assert_state_close(tm, jm, nnx.Param)


def test_mf_serving_evaluation_and_exports_match_jax():
    """``to_top_k_encoder()`` over the tied table (no candidates given),
    ``evaluate(item_corpus=True)``, ``query_embeddings()`` with no dataset."""
    jds, tds = data()
    jm, tm = mf_pair(jds, tds)
    fit_both(jm, tm, jds, tds)
    jenc = jm.to_top_k_encoder(k=10)
    tenc = tm.to_top_k_encoder(k=10, device="cpu")
    assert tenc.blocks[-1].topk_layer.n_valid == CATALOG
    want = jenc.predict(jds, batch_size=B)
    got = tenc.predict(tds, batch_size=B, device="cpu")
    np.testing.assert_array_equal(got["ids"], np.asarray(want["ids"]))
    np.testing.assert_allclose(got["scores"], np.asarray(want["scores"]), rtol=0, atol=2e-5)
    jm.compile(optimizer="adagrad", learning_rate=LR)
    tm.compile(optimizer="adagrad", learning_rate=LR)
    want = jm.evaluate(jds, batch_size=B, item_corpus=True, verbose=0)
    got = tm.evaluate(tds, batch_size=B, item_corpus=True, device="cpu")
    assert "recall_at_10" in got
    assert_logs_close(got, {k: v for k, v in want.items() if k in got})
    for which in ("query", "candidate"):
        w = getattr(jm, f"{which}_embeddings")().to_numpy_dict()
        g = getattr(tm, f"{which}_embeddings")().to_numpy_dict()
        np.testing.assert_array_equal(g["id"], w["id"])
        np.testing.assert_allclose(g["embedding"], w["embedding__values"].reshape(len(w["id"]), -1),
                                   rtol=0, atol=1e-6)


def yt_pair(jds, tds, num_sampled=16):
    jm = JYT(jds.schema, num_sampled=num_sampled, seed=0)
    jm.compile(optimizer="adagrad", learning_rate=LR, metrics=[])
    jm.build(JLoader(jds, B))
    tm = mt.YoutubeDNNRetrievalModel(tds.schema, num_sampled=num_sampled, seed=0, device="cpu")
    mt.load_jax_params(tm, jax_vars(jm, nnx.Param))
    return jm, tm


def test_youtube_dnn_forward_steps_and_serving_match_jax():
    jds, tds = data()
    jm, tm = yt_pair(jds, tds)
    assert tm.block_name == "youtube_dnn"
    assert tm.contrastive_output.table.dim == 32  # inferred from 56,680 items
    (sampler,) = tm.contrastive_output.samplers
    assert sampler.max_num_samples == 16 and sampler.max_id == CATALOG - 1
    np.testing.assert_allclose(tm.predict(tds, batch_size=B, device="cpu"),
                               np.asarray(jm.predict(jds, batch_size=B)), rtol=0, atol=2e-5)
    calls = jax_draws(sampler, jm.contrastive_output.samplers[0])
    fit_both(jm, tm, jds, tds)
    assert len(calls) == 3
    assert_state_close(tm, jm, nnx.Param)
    want = jm.to_top_k_encoder(k=10).predict(jds, batch_size=B)
    got = tm.to_top_k_encoder(k=10, device="cpu").predict(tds, batch_size=B, device="cpu")
    np.testing.assert_array_equal(got["ids"], np.asarray(want["ids"]))
    np.testing.assert_allclose(got["scores"], np.asarray(want["scores"]), rtol=0, atol=2e-5)


def test_popularity_probabilities_within_the_float32_cancellation():
    """The port's and the JAX package's logQ probabilities over the whole
    catalog, each within two ulps of ``log(id + 2)`` (over ``log(C + 1)``)
    of the exact value: the bound of the float32 formula both copy."""
    max_id = CATALOG - 1
    ids = np.arange(CATALOG)
    exact = (np.log(ids + 2.0) - np.log(ids + 1.0)) / np.log(max_id + 2.0)
    bound = 2 * np.spacing(np.log(ids + 2.0).astype(np.float32)) / np.log(max_id + 2.0)
    got = PopularityBasedSampler.sampling_probs(torch.from_numpy(ids), max_id).numpy()
    want = np.asarray(JPop(max_num_samples=1).sampling_probs(jnp.asarray(ids), max_id))
    for probs in (got, want):
        assert (np.abs(probs - exact) <= bound).all()


def test_youtube_dnn_fused_equals_unfused():
    """With fixed draws, the fused loss (logQ on the positive and the
    negatives) against the unfused logits' CE, through the model."""
    _, tds = data(B)
    tm = mt.YoutubeDNNRetrievalModel(tds.schema, num_sampled=16, seed=0, device="cpu")
    sampler = tm.contrastive_output.samplers[0]
    ids = torch.randint(0, CATALOG, (16,), generator=torch.Generator().manual_seed(1),
                        dtype=torch.int32)
    sampler.sample_ids = lambda n, max_id, device: ids
    x, y = next(iter(mt.Loader(tds, B)))
    xb = mt.core.types.to_device_batch(x, "cpu")
    losses = []
    for fused in (True, False):
        ctx = ModelContext(features=xb, need_logits=not fused)
        pred = tm(xb, training=True, context=ctx)
        losses.append(pred.precomputed_loss if fused else
                      mt.losses.categorical_crossentropy(pred.targets, pred.outputs))
    np.testing.assert_allclose(losses[0].item(), losses[1].item(), rtol=1e-5)


def _post(post, csw, plc, schema):
    freqs = np.random.default_rng(0).integers(1, 100, CATALOG).astype(np.float32)
    weights = np.random.default_rng(1).uniform(0.5, 2.0, CATALOG).astype(np.float32)
    return {
        "constant": lambda: csw(2.0, 0.5),
        "column": lambda: csw("w", 0.5),
        "per-candidate": lambda: csw(weights, weights[::-1].copy(), schema=schema),
        "popularity": lambda: plc(freqs),
    }[post]()


@pytest.mark.parametrize("post", ["constant", "column", "per-candidate", "popularity"])
def test_contrastive_post_blocks_match_jax(post):
    """Each post block on a tied head over ``["in-batch", popularity]``
    negatives: the head's logits, its (B, 1+N) weights and the loss."""
    from models_tpu.losses import categorical_crossentropy as jce
    from models_tpu.outputs import ContrastiveOutput as JOut

    jds, tds = data(B)
    rng = np.random.default_rng(2)
    q = rng.normal(size=(B, DIM)).astype(np.float32)
    ids = rng.integers(0, CATALOG, B).astype(np.int32)
    w = rng.uniform(0.5, 2.0, B).astype(np.float32)  # the "column" form's feature
    jtable = JTable(DIM, jds.schema.item_id_column, seed=2)
    ttable = mt.inputs.EmbeddingTable(DIM, tds.schema.item_id_column, device="cpu")
    with torch.no_grad():
        ttable.table.copy_(torch.from_numpy(np.asarray(jtable.table.value)))
    jsp, tsp = JPop(max_num_samples=16, seed=1), PopularityBasedSampler(16, seed=1)
    jax_draws(tsp, jsp)
    jhead = JOut(jtable, negative_samplers=["in-batch", jsp],
                 post=_post(post, JCSW, JPLC, jds.schema))
    thead = mt.ContrastiveOutput(ttable, negative_samplers=["in-batch", tsp],
                                 post=_post(post, ContrastiveSampleWeight,
                                            PopularityLogitsCorrection, tds.schema))
    want = jhead(jnp.asarray(q), training=True, context=JContext(
        features={"movieId": jnp.asarray(ids), "w": jnp.asarray(w)}, step=0))
    got = thead(torch.from_numpy(q), training=True, context=ModelContext(
        features={"movieId": torch.from_numpy(ids), "w": torch.from_numpy(w)}, step=0))
    assert got.outputs.shape == (B, 1 + B + 16)
    np.testing.assert_allclose(got.outputs.detach().numpy(), np.asarray(want.outputs), rtol=0,
                               atol=2e-6)
    if post != "popularity":
        assert got.sample_weight.shape == got.outputs.shape
        np.testing.assert_allclose(got.sample_weight.numpy(), np.asarray(want.sample_weight),
                                   rtol=1e-6)
    loss = mt.losses.categorical_crossentropy(got.targets, got.outputs, got.sample_weight)
    np.testing.assert_allclose(loss.item(), float(jce(want.targets, want.outputs,
                                                      want.sample_weight)), rtol=1e-5)


@pytest.mark.parametrize("post", ["constant", "per-candidate", "popularity"])
def test_two_tower_post_blocks_match_jax(post):
    """Three steps of the two-tower model with the post block. (The column
    form is held above: the data's continuous columns have mean about 0, so
    as weights their sum comes near 0.)"""
    jds, tds = data()

    def make(csw, plc, schema):
        return _post(post, csw, plc, schema)

    kw = dict(query_tower=(16, 8), embedding_dim=DIM)
    jm = JTwoTower(jds.schema, post=make(JCSW, JPLC, jds.schema), **kw)
    jm.compile()
    jm.build(JLoader(jds, B))
    tm = mt.TwoTowerModel(tds.schema, post=make(ContrastiveSampleWeight,
                                                PopularityLogitsCorrection, tds.schema),
                          device="cpu", **kw)
    mt.load_jax_params(tm, jax_vars(jm, nnx.Param))
    fit_both(jm, tm, jds, tds)
    assert_state_close(tm, jm, nnx.Param)


def test_two_tower_l2_norm_and_block_towers():
    jds, tds = data()
    kw = dict(query_tower=(16, 8), embedding_dim=DIM, l2_norm=True, logits_temperature=0.2)
    jm = JTwoTower(jds.schema, **kw)
    jm.compile()
    jm.build(JLoader(jds, B))
    tm = mt.TwoTowerModel(tds.schema, device="cpu", **kw)
    assert isinstance(tm.query_encoder.layers[-1], L2Norm)
    mt.load_jax_params(tm, jax_vars(jm, nnx.Param))
    fit_both(jm, tm, jds, tds)
    assert_state_close(tm, jm, nnx.Param)
    # Block towers: taken as given; the item tower a re-seeded copy of the query's
    user = tds.schema.select_by_tag(Tags.USER)
    tower = mt.core.SequentialBlock([mt.inputs.InputBlockV2(user, dim=DIM, device="cpu"),
                                     mt.blocks.MLPBlock((8,), in_features=DIM + 1, device="cpu")])
    tm = mt.TwoTowerModel(tds.schema, query_tower=tower, device="cpu")
    assert tm.query_encoder is tower and tm.candidate_encoder is not tower
    pq = dict(tm.query_encoder.named_parameters())
    pc = dict(tm.candidate_encoder.named_parameters())
    assert sorted(pq) == sorted(pc)
    assert all(pq[n].data_ptr() != pc[n].data_ptr() and not torch.equal(pq[n], pc[n])
               for n in pq if pq[n].ndim == 2)
    item = mt.core.SequentialBlock([mt.inputs.InputBlockV2(user, dim=DIM, device="cpu")])
    assert mt.TwoTowerModel(tds.schema, query_tower=tower, item_tower=item,
                            device="cpu").candidate_encoder is item


def test_l2norm_dotproduct_and_tied_categorical_output_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 6)).astype(np.float32)
    c = rng.normal(size=(5, 6)).astype(np.float32)
    np.testing.assert_allclose(L2Norm()(torch.from_numpy(x)).numpy(),
                               np.asarray(JL2Norm()(jnp.asarray(x))), rtol=1e-6, atol=1e-7)
    got = L2Norm()({"a": torch.from_numpy(x)})["a"]
    np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(
        DotProduct()({"query": torch.from_numpy(x), "candidate": torch.from_numpy(c)}).numpy(),
        np.asarray(JDot()({"query": jnp.asarray(x), "candidate": jnp.asarray(c)})),
        rtol=1e-6, atol=1e-6)
    jds, tds = data(B)
    jtable = JTable(6, jds.schema.item_id_column, seed=2)
    ttable = mt.inputs.EmbeddingTable(6, tds.schema.item_id_column, device="cpu")
    with torch.no_grad():
        ttable.table.copy_(torch.from_numpy(np.asarray(jtable.table.value)))
    jhead, thead = JCategorical(jtable), CategoricalOutput(ttable)
    assert thead.target == jhead.target == "movieId" and thead.num_classes == CATALOG
    want = jhead(jnp.asarray(x), targets={"movieId": jnp.arange(5)})
    got = thead(torch.from_numpy(x), targets={"movieId": torch.arange(5)})
    assert got.outputs.shape == (5, CATALOG)
    np.testing.assert_allclose(got.outputs.detach().numpy(), np.asarray(want.outputs), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(thead.activation(got.outputs).detach().numpy(),
                               np.asarray(jhead.activation(want.outputs)), rtol=1e-5,
                               atol=1e-9)
    # without in_features the head's Dense builds at its first call
    lazy = CategoricalOutput(10)
    assert not lazy.to_call.dense.built
    out = lazy(torch.ones(3, 7), targets={"x": torch.arange(3)}).outputs
    assert out.shape == (3, 10) and lazy.to_call.dense.weight.shape == (10, 7)


@pytest.mark.parametrize("name", ["NoveltyAt", "PopularityBiasAt", "ItemCoverageAt"])
def test_evaluation_metrics_match_jax(name):
    rng = np.random.default_rng(3)
    freqs = rng.integers(0, 50, 40).astype(np.float32)
    jm, tm = getattr(jeval, name)(freqs, k=5), getattr(teval, name)(freqs, k=5)
    js, ts = jm.init_state(), tm.init_state("cpu")
    for step in range(3):
        ids = rng.integers(-1, 40, (6, 7)).astype(np.int32)  # -1: a top-k list's padding
        w = rng.uniform(0.5, 1.5, 6).astype(np.float32) if step else None
        scores = np.zeros((6, 7), np.float32)
        js = jm.update(js, jnp.asarray(scores), jnp.asarray(ids),
                       sample_weight=None if w is None else jnp.asarray(w))
        ts = tm.update(ts, torch.from_numpy(scores), torch.from_numpy(ids),
                       sample_weight=None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(float(tm.result(ts)), float(jm.result(js)), rtol=1e-6)
    assert mt.registry.metric_registry[jm.name] is getattr(teval, name)


def test_retrieval_blocks_match_jax():
    jds, tds = data(B)
    jmf = jblocks.MatrixFactorizationBlock(jds.schema, dim=DIM, seed=1)
    tmf = tblocks.MatrixFactorizationBlock(tds.schema, dim=DIM, seed=1, device="cpu")
    assert tmf.block_name == "mf" and sorted(tmf.branches) == ["candidate", "query"]
    mt.load_jax_params(tmf, jax_vars(jmf, nnx.Param))
    x, _ = next(iter(mt.Loader(tds, B)))
    jx, _ = next(iter(JLoader(jds, B)))
    jx = {k: jnp.asarray(v) for k, v in jx.items() if not hasattr(v, "mask")}
    xb = mt.core.types.to_device_batch(x, "cpu")
    want = jmf(jx, context=JContext(features=jx))
    got = tmf(xb, context=ModelContext(features=xb))
    for key in ("query", "candidate"):
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want[key]), atol=1e-7)
    assert isinstance(tblocks.QueryItemIdsEmbeddingsBlock(tds.schema, DIM, device="cpu")
                      .branches["query"], EmbeddingEncoder)
    tt = tblocks.TwoTowerBlock(tds.schema, (16, 8), embedding_dim=DIM, device="cpu")
    out = tt(xb)
    assert tt.block_name == "two_tower" and out["query"].shape == out["candidate"].shape == (B, 8)
    assert isinstance(tblocks.TowerBlock(tmf, "t"), mt.core.SequentialBlock)
    dual = tblocks.DualEncoderBlock(tmf.branches["query"], tmf.branches["candidate"])
    assert dual.block_name == "dual_encoder"
    scorer = tblocks.ItemRetrievalScorer(["in-batch", "cross-batch"],
                                         sampling_downscore_false_negatives=False,
                                         item_id_feature_name="movieId", logits_temperature=0.5)
    assert scorer.target == "movieId" and not scorer.downscore_false_negatives
    assert isinstance(scorer.samplers[1], CachedCrossBatchSampler)
    assert scorer.logits_scaler.temperature == 0.5


def test_embedding_encoder_reads_its_feature_and_passes_the_context():
    _, tds = data(B)
    table = mt.inputs.EmbeddingTable(DIM, tds.schema["userId"], device="cpu")
    enc = EmbeddingEncoder(table)
    x = mt.core.types.to_device_batch(next(iter(mt.Loader(tds, B)))[0], "cpu")
    np.testing.assert_array_equal(enc(x).detach().numpy(), enc(x["userId"]).detach().numpy())
    table.sparse_routed = True
    ctx = ModelContext(sparse_lookups=[])
    enc(x, context=ctx)
    ((t, ids, rows, key),) = ctx["sparse_lookups"]
    assert t is table and key == "userId" and rows.requires_grad
    np.testing.assert_array_equal(enc.to_dataset().to_numpy_dict()["id"],
                                  np.arange(tds.schema["userId"].cardinality))
    with pytest.raises(TypeError):
        EmbeddingEncoder(mt.blocks.Dense(2, in_features=2))


def test_topk_layer_indexes_every_dataset_layout():
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(70, 4)).astype(np.float32)
    ids = np.arange(100, 170)
    q = torch.from_numpy(rng.normal(size=(3, 4)).astype(np.float32))
    want = BruteForce(5).index(emb, ids, device="cpu")(q)
    layouts = [{"id": ids, "embedding": emb},
               {"id": ids, "embedding__values": emb.reshape(-1)},
               {"id": ids, **{f"d{i}": emb[:, i] for i in range(4)}}]
    for layout in layouts:
        got = BruteForce(5).index_from_dataset(layout, device="cpu")(q)
        assert torch.equal(got.identifiers, want.identifiers)
        assert torch.equal(got.scores, want.scores)
    assert issubclass(BruteForce, TopKLayer)
    with pytest.raises(ValueError, match="unique"):
        BruteForce(5).index_from_dataset({"id": np.zeros(70), "embedding": emb}, device="cpu")
    BruteForce(5).index_from_dataset({"id": np.zeros(70), "embedding": emb},
                                     check_unique_ids=False, device="cpu")
