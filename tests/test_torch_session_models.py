"""The port's session models (``SessionBasedTransformerModel``: GPT2 next
item, XLNet masked LM, popularity-sampled negatives), its tied contrastive
head on sequences and its bucketed chunk route, against the JAX package's,
on the CPU.

Both packages draw the same rows from one seed (``sequence-testing``, four
positions, batches of 16) and the JAX model's parameters are carried over
with ``load_jax_params``. Tolerances, each with its reason:

- forward (``predict``: the tied table's full-catalog scores) atol 2e-5;
- trajectories with adagrad (lr 0.05), three steps: every logged loss
  rtol 1e-5, every parameter rtol 1e-4 / atol 1e-6 (the ranking tests'
  bounds: float32 sums in another order, compounded over three steps);
- Adam (lr 1e-3): its first step moves an element by about lr * sign(g)
  wherever |g| >> eps, and a gradient that is rounding noise (the key
  bias's, whose true value is 0) may take either sign in either package:
  parameters within atol 2 * lr * steps (the most such an element can
  move apart), losses rtol 1e-4;
- ``evaluate``: loss rtol 1e-5, the top-k metrics atol 1e-6 (the same
  counts; the ranks are tie-free but for MIN_FLOAT false negatives, which
  rank below every positive);
- the tied head, fused and unfused, against JAX's: loss rtol 1e-5,
  gradients within 2e-5 of the largest;
- the popularity sampler's probabilities atol 2e-7 (a difference of two
  float32 logs near 4.6, a few of their ulps);
- ``mixed_bfloat16``: losses rtol 1e-4 and parameters atol 1e-4 after three
  adagrad steps (products of bf16 operands exact in float32 in both; a
  float32 value a few ulps apart may round to the next bf16 ulp, 2**-8 of
  it, where the two packages sum in other orders).

The random draws are the JAX package's: ``SequenceMaskRandom.draw`` and the
popularity sampler's ``sample_ids`` are given JAX's draws for each step
(JAX folds the step into its key; the port draws from a generator).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from models_tpu.core.policy import set_dtype_policy as jax_set_policy
from models_tpu.data import Dataset as JDataset
from models_tpu.data import Loader as JLoader
from models_tpu.data import generate_data as jax_generate
from models_tpu.models.session import SessionBasedTransformerModel as JSession
from models_tpu.schema import Schema as JSchema
from models_tpu.schema import Tags as JTags
from models_tpu.schema import create_categorical_column as jcat
from models_tpu.transformer import block as jtb
from models_tpu.transforms import sequence as jseq

import models_tpu_torch as mt
from models_tpu_torch.core.types import ModelContext, SequenceFeature
from models_tpu_torch.models.session import SessionBasedTransformerModel as TSession
from models_tpu_torch.outputs.contrastive import ContrastiveOutput
from models_tpu_torch.schema import Schema, Tags
from models_tpu_torch.schema import create_categorical_column as tcat
from models_tpu_torch.transformer import block as ttb
from models_tpu_torch.transforms import sequence as tseq

TARGET = "item_id_seq"
BATCH, STEPS = 16, 3


def jax_params(model):
    return {"/".join(str(p) for p in path): np.asarray(v[...])
            for path, v in nnx.state(model, nnx.Param).flat_state()}


def port_params(model):
    out = {}
    for name, p in model.named_parameters():
        parts, value = name.split("."), p.detach().float().numpy()
        if parts[-1] == "weight":
            parts, value = parts[:-1] + ["kernel"], value.T
        out["/".join(parts)] = value
    return out


def assert_params_close(tm, jm, rtol=1e-4, atol=1e-6):
    want, got = jax_params(jm), port_params(tm)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value.astype(np.float32), rtol=rtol, atol=atol,
                                   err_msg=key)


def assert_logs_close(got, want, rtol=1e-5):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if key == "examples_per_sec":
            continue
        if key.startswith("loss") or key == "regularization_loss":
            np.testing.assert_allclose(got[key], value, rtol=rtol, atol=1e-7, err_msg=key)
        else:
            np.testing.assert_allclose(got[key], value, atol=1e-6, err_msg=key)


def blocks(name, jax_side):
    tb = jtb if jax_side else ttb
    kw = dict(d_model=16, n_head=2, n_layer=2, dropout=0.0)
    if not jax_side:
        kw["device"] = "cpu"
    return getattr(tb, {"gpt2": "GPT2Block", "xlnet": "XLNetBlock"}[name])(**kw)


def build_pair(name="gpt2", rows=STEPS * BATCH, seed=4, data=None, **model_kw):
    """The JAX model built and its parameters loaded into the port's."""
    if data is None:
        jds = jax_generate("sequence-testing", num_rows=rows, seed=seed)
        tds = mt.generate_data("sequence-testing", num_rows=rows, seed=seed)
    else:
        jds, tds = data
    jm = JSession(jds.schema, transformer=blocks(name, True), embedding_dim=8, **model_kw)
    jm.compile(optimizer="adagrad", learning_rate=0.05)
    jm.build(JLoader(jds, BATCH))
    tm = TSession(tds.schema, transformer=blocks(name, False), embedding_dim=8, device="cpu",
                  **model_kw)
    mt.load_jax_params(tm, jax_params(jm))
    return jds, tds, jm, tm


def pres(jds, tds, kind="next"):
    cls = {"next": "SequencePredictNext", "last": "SequencePredictLast"}[kind]
    return getattr(jseq, cls)(jds.schema, TARGET), getattr(tseq, cls)(tds.schema, TARGET)


def fit_both(jm, tm, jds, tds, jpre, tpre, epochs=1, **compile_kw):
    kw = dict(optimizer="adagrad", learning_rate=0.05, metrics=[], **compile_kw)
    jm.compile(**kw)
    tm.compile(**kw)
    jh = jm.fit(jds, epochs=epochs, batch_size=BATCH, shuffle=False, verbose=0, pre=jpre)
    th = tm.fit(tds, epochs=epochs, batch_size=BATCH, shuffle=False, pre=tpre, device="cpu")
    return jh.history, th.history


@pytest.mark.parametrize("name", ["gpt2", "xlnet"])
def test_next_item_model_matches_jax(name):
    """predict; three steps through fit(pre=SequencePredictNext) on the
    fused loss (no metrics); evaluate with SequencePredictLast (B queries)
    and SequencePredictNext (B * L positions, the prediction mask as
    weights); predict again."""
    jds, tds, jm, tm = build_pair(name)
    np.testing.assert_allclose(tm.predict(tds, batch_size=BATCH, device="cpu"),
                               np.asarray(jm.predict(jds, batch_size=BATCH)), rtol=0, atol=2e-5)
    jh, th = fit_both(jm, tm, jds, tds, *pres(jds, tds))
    assert tm._step == STEPS
    assert_logs_close(th, jh)
    assert_params_close(tm, jm)
    jm.compile(optimizer="adagrad", learning_rate=0.05)
    tm.compile(optimizer="adagrad", learning_rate=0.05)
    for kind in ("last", "next"):
        jpre, tpre = pres(jds, tds, kind)
        got = tm.evaluate(tds, batch_size=BATCH, pre=tpre, device="cpu")
        want = jm.evaluate(jds, batch_size=BATCH, pre=jpre)
        assert "recall_at_10" in got
        assert_logs_close(got, want)
    out = tm.predict(tds, batch_size=BATCH, device="cpu")
    assert out.shape == (STEPS * BATCH, 4, 101)
    np.testing.assert_allclose(out, np.asarray(jm.predict(jds, batch_size=BATCH)),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(
        tm.predict(tds, batch_size=BATCH, pre=pres(jds, tds, "last")[1], device="cpu"),
        np.asarray(jm.predict(jds, batch_size=BATCH, pre=pres(jds, tds, "last")[0])),
        rtol=0, atol=2e-5)


def test_unfused_training_steps_feed_the_metrics_as_jax():
    """With the default top-k metrics every step takes the unfused logits of
    the B * L flattened positions; the metrics over the prediction mask."""
    jds, tds, jm, tm = build_pair()
    jm.compile(optimizer="adagrad", learning_rate=0.05)
    tm.compile(optimizer="adagrad", learning_rate=0.05)
    jpre, tpre = pres(jds, tds)
    jh = jm.fit(jds, batch_size=BATCH, shuffle=False, verbose=0, pre=jpre)
    th = tm.fit(tds, batch_size=BATCH, shuffle=False, pre=tpre, device="cpu")
    assert "ndcg_at_10" in th.history
    assert_logs_close(th.history, jh.history)
    assert_params_close(tm, jm)


def test_adam_trajectory_matches_jax_within_a_sign_flip():
    jds, tds, jm, tm = build_pair()
    kw = dict(optimizer="adam", learning_rate=1e-3, metrics=[])
    jm.compile(**kw)
    tm.compile(**kw)
    jpre, tpre = pres(jds, tds)
    jh = jm.fit(jds, batch_size=BATCH, shuffle=False, verbose=0, pre=jpre)
    th = tm.fit(tds, batch_size=BATCH, shuffle=False, pre=tpre, device="cpu")
    np.testing.assert_allclose(th.history["loss"], jh.history["loss"], rtol=1e-4)
    assert_params_close(tm, jm, rtol=0, atol=2 * 1e-3 * STEPS)


def jax_uniform(seed, step, shape):
    key = jax.random.fold_in(jax.random.key(seed), jnp.asarray(step, jnp.int32))
    return torch.from_numpy(np.array(jax.random.uniform(key, shape)))


def test_masked_lm_matches_jax_with_its_masks():
    """XLNet with ReplaceMaskedEmbeddings, trained with SequenceMaskRandom
    (JAX's draws at each step): the trajectory, and the [MASK] embedding
    moved (it receives gradient)."""
    jds, tds, jm, tm = build_pair("xlnet", masked_lm=True)
    jpre = jseq.SequenceMaskRandom(jds.schema, TARGET, masking_prob=0.3, seed=5)
    tpre = tseq.SequenceMaskRandom(tds.schema, TARGET, masking_prob=0.3, seed=5)
    calls = []

    def draw(seq):
        calls.append(None)
        return jax_uniform(5, len(calls) - 1, tuple(seq.values.shape[:2]))

    tpre.draw = draw
    mask_emb = [p for n, p in tm.named_parameters() if n.endswith("mask_embedding")]
    assert len(mask_emb) == 1
    before = mask_emb[0].detach().clone()
    jh, th = fit_both(jm, tm, jds, tds, jpre, tpre)
    assert len(calls) == STEPS
    assert_logs_close(th, jh)
    assert_params_close(tm, jm)
    assert not torch.equal(mask_emb[0].detach(), before)


def test_popularity_sampled_negatives_match_jax_with_its_ids():
    """num_sampled=24: the logQ-corrected sampled softmax over the tied
    table, the sampler given JAX's ids at each step."""
    jds, tds, jm, tm = build_pair(num_sampled=24)
    sampler = tm.contrastive_output.samplers[0]
    jsampler = jm.contrastive_output.samplers[0]
    assert isinstance(sampler, mt.outputs.PopularityBasedSampler) and sampler.max_id == 100
    calls = []

    def sample_ids(n, max_id, device):
        key = jax.random.fold_in(jax.random.key(jsampler.seed), len(calls))
        calls.append(None)
        return torch.from_numpy(np.array(jsampler._zipf_sample(key, n, max_id)))

    sampler.sample_ids = sample_ids
    ids = torch.arange(101)
    # a difference of two float32 logs near 4.6: a few of their ulps (4.8e-7)
    np.testing.assert_allclose(sampler.sampling_probs(ids, 100).numpy(),
                               np.asarray(jsampler.sampling_probs(jnp.arange(101), 100)),
                               rtol=0, atol=2e-7)
    jh, th = fit_both(jm, tm, jds, tds, *pres(jds, tds))
    assert len(calls) == STEPS
    assert_logs_close(th, jh)
    assert_params_close(tm, jm)


def test_popularity_sampler_draws_log_uniform_ids():
    s = mt.outputs.PopularityBasedSampler(max_num_samples=20000, max_id=99, seed=1)
    c = s(None)
    assert c.id.dtype == torch.int32 and int(c.id.min()) >= 0 and int(c.id.max()) <= 99
    counts = torch.bincount(c.id.long(), minlength=100).float() / 20000
    np.testing.assert_allclose(counts[:5].numpy(), s.sampling_probs(torch.arange(5), 99),
                               atol=0.01)
    assert not torch.equal(s(None).id, c.id)


@pytest.mark.parametrize("fused", [True, False])
def test_tied_head_on_sequences_matches_jax(fused):
    """The tied ContrastiveOutput on (B, L, D) queries and SequenceFeature
    targets (the prediction mask as weights, a padded row among the
    batch's rows): loss and gradients against JAX's, and the fused loss
    against the unfused logits."""
    from models_tpu.core.types import ModelContext as JContext
    from models_tpu.core.types import SequenceFeature as JSF
    from models_tpu.inputs.embedding import EmbeddingTable as JTable
    from models_tpu.outputs.contrastive import ContrastiveOutput as JOut

    rng = np.random.default_rng(2)
    Bq, L, D, C = 6, 5, 8, 40
    q = rng.normal(size=(Bq, L, D)).astype(np.float32)
    ids = rng.integers(0, C, size=(Bq, L)).astype(np.int32)
    mask = rng.random((Bq, L)) < 0.7
    row_valid = np.ones(Bq, bool)
    row_valid[-1] = False
    col = jcat("item", C - 1)
    jtable = JTable(D, col, seed=1)
    jhead = JOut(jtable)
    ttable = mt.inputs.EmbeddingTable(D, tcat("item", C - 1), device="cpu")
    with torch.no_grad():
        ttable.table.copy_(torch.from_numpy(np.asarray(jtable.table.value)))
    thead = ContrastiveOutput(ttable)

    graphdef, params, rest = nnx.split(jhead, nnx.Param, ...)

    def jloss(p, qv):
        head = nnx.merge(graphdef, p, rest)
        ctx = JContext(features={"__row_valid__": jnp.asarray(row_valid)},
                       need_logits=not fused)
        pred = head(JSF(qv, jnp.asarray(mask)), training=True, context=ctx,
                     targets={"item": JSF(jnp.asarray(ids), jnp.asarray(mask))})
        if pred.precomputed_loss is not None:
            return pred.precomputed_loss
        from models_tpu.losses import categorical_crossentropy
        from models_tpu.models.base import _merge_row_valid

        sw = _merge_row_valid(pred.sample_weight, jnp.asarray(row_valid), Bq * L)
        return categorical_crossentropy(pred.targets, pred.outputs, sw)

    jl, (jgp, jgq) = jax.value_and_grad(jloss, argnums=(0, 1))(params, jnp.asarray(q))
    (jgt,) = [v[...] for _, v in jgp.flat_state()]
    qt = torch.from_numpy(q).requires_grad_()
    ctx = ModelContext(features={"__row_valid__": torch.from_numpy(row_valid)},
                       need_logits=not fused)
    pred = thead(SequenceFeature(qt, torch.from_numpy(mask)), training=True, context=ctx,
                 targets={"item": SequenceFeature(torch.from_numpy(ids), torch.from_numpy(mask))})
    if fused:
        assert pred.precomputed_loss is not None
        loss = pred.precomputed_loss
    else:
        from models_tpu_torch.losses import categorical_crossentropy
        from models_tpu_torch.models.base import _merge_row_valid

        assert pred.outputs.shape == (Bq * L, 1 + Bq * L)
        sw = _merge_row_valid(pred.sample_weight, torch.from_numpy(row_valid), Bq * L)
        loss = categorical_crossentropy(pred.targets, pred.outputs, sw)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    scale = max(float(jnp.abs(jgt).max()), float(jnp.abs(jgq).max()))
    for got, want in ((ttable.table.grad.numpy(), np.asarray(jgt)),
                      (qt.grad.numpy(), np.asarray(jgq))):
        assert float(np.abs(got - want).max()) <= 2e-5 * scale


def test_predict_last_query_is_the_last_valid_hidden_state():
    """A scalar target takes each row's hidden state at its last valid
    input position: B queries against B in-batch candidates."""
    ttable = mt.inputs.EmbeddingTable(4, tcat("item", 9), device="cpu")
    head = ContrastiveOutput(ttable)
    q = torch.randn(3, 5, 4)
    mask = torch.tensor([[1, 1, 0, 0, 0], [1, 1, 1, 1, 1], [1, 0, 0, 0, 0]], dtype=torch.bool)
    pred = head(SequenceFeature(q, mask), targets={"item": torch.tensor([1, 2, 3])},
                context=ModelContext(testing=True))
    last = q[torch.arange(3), torch.tensor([1, 4, 0])]
    emb = ttable.table.detach()[[1, 2, 3]]
    torch.testing.assert_close(pred.outputs[:, 0], (last * emb).sum(1))
    assert pred.outputs.shape == (3, 4)
    assert head.to_dataset().num_rows == 10


def test_chunk_route_with_pre_equals_one_step_at_a_time():
    """Three steps a chunk on the packed columns, SequencePredictNext run
    inside each step of the chunk (the eager chunk on the CPU), against one
    step at a time: the same arithmetic in the same order, bit for bit."""
    _, tds, _, a = build_pair(rows=6 * BATCH)
    _, _, _, b = build_pair(rows=6 * BATCH)
    pre = tseq.SequencePredictNext(tds.schema, TARGET)
    hist = []
    for m, spe in ((a, 1), (b, 3)):
        m.compile(optimizer="adam", learning_rate=1e-3, metrics=[], steps_per_execution=spe)
        hist.append(m.fit(tds, epochs=2, batch_size=BATCH, shuffle=True, pre=pre,
                          device="cpu").history)
    assert tds._device_train_pack is not None and a._step == b._step == 12
    assert hist[0]["loss"] == hist[1]["loss"]
    for (name, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), name


def bucket_data(per_group=32, seed=21):
    """One list column of at most 8 positions (the bench's session_bucket
    schema, narrowed): ``per_group`` rows of each of the lengths 2, 3-4
    and 5-8 (buckets 2, 4 and 8), shuffled, as the bench draws them."""
    rng = np.random.default_rng(seed)
    lengths = np.concatenate([np.full(per_group, 2), rng.integers(3, 5, per_group),
                              rng.integers(5, 9, per_group)])
    rng.shuffle(lengths)
    values = rng.integers(1, 60, int(lengths.sum())).astype(np.int32)
    rows_ = np.array(np.split(values, np.cumsum(lengths)[:-1]), dtype=object)

    def schema(cat, S, T):
        return S([cat(TARGET, 60, tags=(T.ITEM, T.ITEM_ID, T.SEQUENCE), is_list=True,
                      max_seq_length=8)])

    return (JDataset({TARGET: rows_}, schema=schema(jcat, JSchema, JTags)),
            mt.Dataset({TARGET: rows_}, schema=schema(tcat, Schema, Tags)))


def test_bucketed_chunk_route_matches_jax():
    """Loader(pad="bucket") with two steps a chunk: each bucket's rows a
    group with its own pack and graphs, the groups in bucket order, each
    shuffled by its own permutation (the JAX package's seeds): the
    trajectory over two epochs against JAX's."""
    jds, tds = bucket_data()
    data = (jds, tds)
    _, _, jm, tm = build_pair(data=data)
    kw = dict(optimizer="adagrad", learning_rate=0.05, metrics=[], steps_per_execution=2)
    jm.compile(**kw)
    tm.compile(**kw)
    jpre, tpre = pres(jds, tds)
    jl = JLoader(jds, BATCH, pad="bucket", shuffle=True, drop_last=True, prefetch=0)
    tl = mt.Loader(tds, BATCH, pad="bucket", shuffle=True, drop_last=True)
    jh = jm.fit(jl, epochs=2, verbose=0, pre=jpre)
    th = tm.fit(tl, epochs=2, pre=tpre, device="cpu")
    groups = tds._device_bucket_groups
    assert [b for b, _ in groups] == [2, 4, 8]
    assert [tuple(g.packed.shape) for _, g in groups] == [(g.n_rows, 2 * b) for b, g in groups]
    steps = sum(g.n_rows // BATCH for _, g in groups)
    assert tm._step == 2 * steps == 12
    assert_logs_close(th.history, jh.history)
    assert_params_close(tm, jm)


def test_bucketed_route_falls_back_to_one_step_at_a_time():
    """Groups whose full batches hold less than 80% of the rows: the
    streaming route, one bucketed batch a step."""
    _, tds = bucket_data(per_group=12)
    tm = TSession(tds.schema, transformer=blocks("gpt2", False), embedding_dim=8, device="cpu")
    tm.compile(optimizer="adagrad", learning_rate=0.05, metrics=[], steps_per_execution=2)
    tl = mt.Loader(tds, BATCH, pad="bucket", drop_last=True)
    assert mt.Model._device_bucket_groups(tl, torch.device("cpu")) is None
    tm.fit(tl, pre=tseq.SequencePredictNext(tds.schema, TARGET), device="cpu")
    assert tm._step == 36 // BATCH


@contextlib.contextmanager
def mixed_policy():
    jax_set_policy("mixed_bfloat16")
    mt.set_dtype_policy("mixed_bfloat16")
    try:
        yield
    finally:
        jax_set_policy("float32")
        mt.set_dtype_policy("float32")


def test_mixed_bfloat16_trajectory_is_close_to_jax():
    jds, tds, jm, tm = build_pair()
    with mixed_policy():
        jh, th = fit_both(jm, tm, jds, tds, *pres(jds, tds))
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)
    assert_params_close(tm, jm, rtol=0, atol=1e-4)
