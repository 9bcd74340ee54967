"""The port's sequence transforms, sequence aggregations and bucketed loader
against the JAX package's, on the CPU.

The same seeded rows (``generate_data`` draws alike in both packages) go
through each JAX transform and its port: masks, target ids and the stashed
prediction mask must be equal, bit for bit (integer and boolean work). The
random transforms draw from a generator in the port and from a key folded
with the step in JAX: the port's ``draw`` is given JAX's uniforms. The
aggregations are held within atol 1e-6 (float32 sums in another order);
``Loader(pad="bucket")``'s batches and ``bucketed_dense_columns``' groups
must equal the JAX loader's exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from models_tpu.core import aggregation as jagg
from models_tpu.core.types import MASK_KEY as JMASK_KEY
from models_tpu.core.types import ModelContext as JContext
from models_tpu.core.types import SequenceFeature as JSF
from models_tpu.data import Loader as JLoader
from models_tpu.data import generate_data as jax_generate
from models_tpu.transforms import sequence as jseq

import models_tpu_torch as mt
from models_tpu_torch.core import aggregation as tagg
from models_tpu_torch.core.types import MASK_KEY, ModelContext, SequenceFeature, to_device_batch
from models_tpu_torch.transforms import sequence as tseq

TARGET = "item_id_seq"


def batches(rows=24, seed=3, min_len=1, max_len=None, batch=8):
    """One batch of the same seeded rows from each package's loader."""
    kw = dict(num_rows=rows, seed=seed, min_session_length=min_len, max_session_length=max_len)
    jds = jax_generate("sequence-testing", **kw)
    tds = mt.generate_data("sequence-testing", **kw)
    jx, _ = next(iter(JLoader(jds, batch)))
    tx, _ = next(iter(mt.Loader(tds, batch)))
    return jds, tds, jx, to_device_batch(tx, "cpu")


def as_np(v):
    if isinstance(v, (JSF, SequenceFeature)):
        return np.asarray(v.values), np.asarray(v.mask)
    return np.asarray(v), None


def assert_same(jv, tv, what):
    ja, jm = as_np(jv)
    ta, tm = as_np(tv)
    assert ja.shape == ta.shape, what
    if ja.dtype.kind == "f":
        np.testing.assert_array_equal(ta, ja.astype(np.float32), err_msg=what)
    else:
        np.testing.assert_array_equal(ta, ja, err_msg=what)
    if jm is not None:
        np.testing.assert_array_equal(tm, jm, err_msg=what + " mask")


def jax_uniform(seed, shape):
    """The JAX random transforms' draw at step 0."""
    key = jax.random.fold_in(jax.random.key(seed), jnp.asarray(0, jnp.int32))
    return np.array(jax.random.uniform(key, shape))


CASES = ["predict_next", "predict_last", "predict_random", "target_as_input", "mask_random",
         "mask_last", "mask_last_inference"]


def make(case, jds, tds):
    js, ts = jds.schema, tds.schema
    if case == "predict_next":
        return jseq.SequencePredictNext(js, TARGET), tseq.SequencePredictNext(ts, TARGET)
    if case == "predict_last":
        return jseq.SequencePredictLast(js, TARGET), tseq.SequencePredictLast(ts, TARGET)
    if case == "predict_random":
        return (jseq.SequencePredictRandom(js, TARGET, seed=5),
                tseq.SequencePredictRandom(ts, TARGET, seed=5))
    if case == "target_as_input":
        return jseq.SequenceTargetAsInput(js, TARGET), tseq.SequenceTargetAsInput(ts, TARGET)
    if case == "mask_random":
        return (jseq.SequenceMaskRandom(js, TARGET, masking_prob=0.3, seed=5),
                tseq.SequenceMaskRandom(ts, TARGET, masking_prob=0.3, seed=5))
    if case == "mask_last":
        return jseq.SequenceMaskLast(js, TARGET), tseq.SequenceMaskLast(ts, TARGET)
    return (jseq.SequenceMaskLastInference(js, TARGET),
            tseq.SequenceMaskLastInference(ts, TARGET))


@pytest.mark.parametrize("case", CASES)
def test_transform_matches_jax_bit_for_bit(case):
    """Every list column's mask, the target (ids and mask) and the mask left
    in the context, on rows of lengths 1..4 (a row of length 1 has no next
    item and no position before its last)."""
    jds, tds, jx, tx = batches()
    jt, tt = make(case, jds, tds)
    if case in ("predict_random", "mask_random"):
        shape = (8,) if case == "predict_random" else (8, 4)
        u = torch.from_numpy(jax_uniform(5, shape))
        tt.draw = lambda seq: u
    jctx, tctx = JContext(features=jx, step=0), ModelContext(features=tx, step=0)
    jout, jy = jt(jx, context=jctx)
    tout, ty = tt(tx, context=tctx)
    assert sorted(jout) == sorted(tout)
    for name in jout:
        assert_same(jout[name], tout[name], name)
    assert sorted(jy) == sorted(ty) == [TARGET]
    assert_same(jy[TARGET], ty[TARGET], "target")
    assert_same(jctx.targets[TARGET], tctx.targets[TARGET], "context target")
    assert (JMASK_KEY in jctx) == (MASK_KEY in tctx)
    if JMASK_KEY in jctx:
        np.testing.assert_array_equal(tctx[MASK_KEY].numpy(), np.asarray(jctx[JMASK_KEY]))


def test_the_random_transforms_draw_from_their_generator():
    """Without injected draws: two calls draw anew, and a transform seeded
    alike draws the same masks."""
    _, tds, _, tx = batches(rows=64, batch=64, min_len=4)
    a = tseq.SequenceMaskRandom(tds.schema, TARGET, masking_prob=0.5, seed=9)
    b = tseq.SequenceMaskRandom(tds.schema, TARGET, masking_prob=0.5, seed=9)
    m1, m2 = a(tx)[1][TARGET].mask, a(tx)[1][TARGET].mask
    assert not torch.equal(m1, m2)
    assert torch.equal(b(tx)[1][TARGET].mask, m1)
    assert bool((m1.sum(dim=1) >= 1).all())  # at least one position a row


def test_model_context_recovers_the_prediction_mask_from_sequence_targets():
    _, tds, _, tx = batches()
    y = tseq.SequencePredictNext(tds.schema, TARGET)(tx)[1]
    ctx = ModelContext(features=tx, targets=y)
    assert torch.equal(ctx[MASK_KEY], y[TARGET].mask)
    assert MASK_KEY not in ModelContext(features=tx, targets={TARGET: y[TARGET].values})


def test_replace_masked_embeddings_and_extract_mask():
    """The [MASK] vector lands exactly on the masked positions, in
    evaluation too; ExtractMaskFromTargets stashes a target's mask."""
    emb = torch.randn(4, 5, 6)
    mask = torch.tensor([[1, 0, 0, 1, 0]] * 4, dtype=torch.bool)
    block = tseq.ReplaceMaskedEmbeddings(6, device="cpu")
    out = block(SequenceFeature(emb), context=ModelContext({MASK_KEY: mask}))
    assert torch.equal(out.values[mask], block.mask_embedding.detach().expand(8, 6))
    assert torch.equal(out.values[~mask], emb[~mask])
    assert block(emb, context=ModelContext()) is emb
    ctx = ModelContext()
    tseq.ExtractMaskFromTargets()(emb, targets={"t": SequenceFeature(emb, mask)}, context=ctx)
    assert torch.equal(ctx[MASK_KEY], mask)


AGGREGATIONS = ["mean", "sum", "max", "min", "last"]


@pytest.mark.parametrize("combiner", AGGREGATIONS)
def test_sequence_aggregation_matches_jax(combiner):
    """The combiner on (B, L, D) values with ragged masks (an empty row
    among them), and the aggregator over a dict of a 3-D sequence and a 2-D
    context feature."""
    rng = np.random.default_rng(7)
    vals = rng.normal(size=(6, 5, 3)).astype(np.float32)
    mask = rng.random((6, 5)) < 0.6
    mask[2] = False
    mask[3] = True
    ctx2d = rng.normal(size=(6, 2)).astype(np.float32)
    jfn, tfn = jagg.SEQUENCE_COMBINERS[combiner], tagg.SEQUENCE_COMBINERS[combiner]
    got = tfn(SequenceFeature(torch.from_numpy(vals), torch.from_numpy(mask)))
    want = np.asarray(jfn(JSF(jnp.asarray(vals), jnp.asarray(mask))))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tfn(torch.from_numpy(vals)).numpy(),
                               np.asarray(jfn(jnp.asarray(vals))), atol=1e-6)
    jcls = {"mean": jagg.SequenceMean, "sum": jagg.SequenceSum, "max": jagg.SequenceMax,
            "min": jagg.SequenceMin, "last": jagg.SequenceLast}[combiner]
    tcls = getattr(tagg, jcls.__name__)
    got = tcls()({"s": SequenceFeature(torch.from_numpy(vals), torch.from_numpy(mask)),
                  "c": torch.from_numpy(ctx2d)})
    want = jcls()({"s": JSF(jnp.asarray(vals), jnp.asarray(mask)), "c": jnp.asarray(ctx2d)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("shuffle", [False, True])
def test_bucketed_loader_matches_jax(shuffle):
    """pad="bucket": every batch's list columns padded to the batch's longest
    row rounded up to a power of two (capped at 4), values and masks equal
    to the JAX loader's, the partial last batch padded and marked."""
    kw = dict(num_rows=45, seed=11, min_session_length=1, max_session_length=4)
    jds, tds = jax_generate("sequence-testing", **kw), mt.generate_data("sequence-testing", **kw)
    jl = JLoader(jds, 4, pad="bucket", shuffle=shuffle, drop_last=False, prefetch=0)
    tl = mt.Loader(tds, 4, pad="bucket", shuffle=shuffle, drop_last=False)
    widths = set()
    for (jx, _), (tx, _) in zip(jl, tl):
        assert sorted(jx) == sorted(tx)
        for name in jx:
            assert_same(jx[name], tx[name], name)
        widths.add(tx[TARGET].values.shape[1])
    assert len(widths) > 1  # the batches took more than one bucket
    assert jl._epoch == tl._epoch == 1


def test_bucketed_dense_columns_match_jax():
    """The groups by bucket: keys, row counts, and each group's columns
    (list columns padded to the group's bucket) equal to the JAX loader's."""
    kw = dict(num_rows=60, seed=12, min_session_length=1, max_session_length=4)
    jds, tds = jax_generate("sequence-testing", **kw), mt.generate_data("sequence-testing", **kw)
    jg = JLoader(jds, 8, pad="bucket").bucketed_dense_columns()
    tg = mt.Loader(tds, 8, pad="bucket").bucketed_dense_columns()
    assert [(b, n) for b, _, _, n in tg] == [(b, n) for b, _, _, n in jg]
    assert len(tg) > 1  # the bucket is that of each row's longest list
    for (_, jf, jt, _), (_, tf, tt, _) in zip(jg, tg):
        assert sorted(jf) == sorted(tf) and tt is None
        for name in jf:
            assert_same(jf[name], tf[name], name)
