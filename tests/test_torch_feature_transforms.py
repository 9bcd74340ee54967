"""The port's feature transforms against the JAX package's, on the CPU.

The encodings are counts (exact); the crossed bucket ids are integers from
uint32 arithmetic and must be JAX's bit for bit. ``StochasticSwapNoise``
draws from ``jax.random`` in the JAX package, which the port cannot
reproduce: the test computes JAX's permutation and swap mask from the same
key and feeds them to the port's ``_swap``, which must then give JAX's
output exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from models_tpu.core.types import ModelContext as JContext
from models_tpu.core.types import SequenceFeature as JSeq
from models_tpu.schema import Schema as JSchema
from models_tpu.schema import Tags as JTags
from models_tpu.schema import create_categorical_column as jcat
from models_tpu.schema import create_continuous_column as jcont
from models_tpu.transforms import features as jf
from models_tpu.transforms import noise as jnoise

from models_tpu_torch.core.types import ModelContext, SequenceFeature
from models_tpu_torch.schema import Schema, Tags
from models_tpu_torch.schema import create_categorical_column as tcat
from models_tpu_torch.schema import create_continuous_column as tcont
from models_tpu_torch.transforms import features as tf
from models_tpu_torch.transforms import noise as tnoise

B, L = 16, 5
CARDS = {"a": 7, "b": 300, "c": 12}


def schemas(list_cols=()):
    js = JSchema([jcat(n, c - 1, is_list=n in list_cols, max_seq_length=L if n in list_cols else 0)
                  for n, c in CARDS.items()] + [jcont("x")])
    ts = Schema([tcat(n, c - 1, is_list=n in list_cols, max_seq_length=L if n in list_cols else 0)
                 for n, c in CARDS.items()] + [tcont("x")])
    return js, ts


def batch(list_cols=(), seed=0, out_of_range=False):
    rng = np.random.default_rng(seed)
    jx, tx = {}, {}
    for n, c in CARDS.items():
        hi = c + 3 if out_of_range else c
        if n in list_cols:
            v = rng.integers(0, hi, (B, L)).astype(np.int32)
            v[:, 1] = v[:, 0]  # a repeated id in every row
            m = rng.random((B, L)) > 0.3
            jx[n], tx[n] = JSeq(jnp.asarray(v), jnp.asarray(m)), SequenceFeature(
                torch.from_numpy(v), torch.from_numpy(m))
        else:
            v = rng.integers(0, hi, B).astype(np.int32)
            jx[n], tx[n] = jnp.asarray(v), torch.from_numpy(v)
    x = rng.standard_normal(B).astype(np.float32)
    jx["x"], tx["x"] = jnp.asarray(x), torch.from_numpy(x)
    return jx, tx


def equal(got, want):
    got = got.values if isinstance(got, SequenceFeature) else got
    want = want.values if isinstance(want, JSeq) else want
    assert tuple(got.shape) == tuple(np.asarray(want).shape)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["one_hot", "multi_hot", "count"])
@pytest.mark.parametrize("lists", [(), ("b",)])
def test_category_encoding_matches_jax(mode, lists):
    js, ts = schemas(lists)
    jx, tx = batch(lists, out_of_range=True)
    equal(tf.CategoryEncoding(ts, output_mode=mode)(tx),
          jf.CategoryEncoding(js, output_mode=mode)(jx))
    with pytest.raises(ValueError, match="output_mode"):
        tf.CategoryEncoding(ts, output_mode="nope")


@pytest.mark.parametrize("mode", ["int", "one_hot"])
@pytest.mark.parametrize("lists", [(), ("a", "c")])
def test_hashed_cross_buckets_are_jax_bit_for_bit(mode, lists):
    js, ts = schemas(lists)
    for seed in range(3):
        jx, tx = batch(lists, seed=seed)
        for cols in (["a", "b"], ["a", "b", "c"], ["c", "b"]):
            jout = jf.HashedCross(js.select_by_name(cols), num_bins=97, output_mode=mode)(jx)
            cross = tf.HashedCross(ts.select_by_name(cols), num_bins=97, output_mode=mode)
            tout = cross(tx)
            equal(tout, jout)
            if lists:
                assert np.array_equal(tout.mask.numpy(), np.asarray(jout.mask))
            assert cross.output_name == "cross_" + "_".join(cols)
    big = np.array([0, 1, 2**31 - 1, 0x9E3779B9 & 0x7FFFFFFF], np.int32)
    jb = jf.HashedCross(js.select_by_name(["a", "b"]), num_bins=1000)(
        {"a": jnp.asarray(big), "b": jnp.asarray(big[::-1].copy())})
    tb = tf.HashedCross(ts.select_by_name(["a", "b"]), num_bins=1000)(
        {"a": torch.from_numpy(big), "b": torch.from_numpy(big[::-1].copy())})
    equal(tb, jb)


@pytest.mark.parametrize("mode", ["one_hot", "int"])
def test_hashed_cross_all_matches_jax(mode):
    js, ts = schemas()
    jx, tx = batch(seed=4)
    jc = jf.HashedCrossAll(js, num_bins=50, max_level=3, output_mode=mode,
                           ignore_combinations=[("c", "a")])
    tc = tf.HashedCrossAll(ts, num_bins=50, max_level=3, output_mode=mode,
                           ignore_combinations=[("c", "a")])
    assert len(tc.crosses) == len(jc.crosses) == 3
    equal(tc(tx), jc(jx))
    if mode == "int":
        equal(tc.buckets(tx).to(torch.int32), jc(jx))
    _, tl = schemas(("a",))
    with pytest.raises(ValueError, match="scalar columns only"):
        tf.HashedCrossAll(tl, num_bins=50, output_mode=mode)(batch(("a",))[1])


def test_prepare_features_to_target_and_expand_dims_match_jax():
    js, ts = schemas(("b",))
    values = np.arange(9, dtype=np.int32)
    offsets = np.array([0, 2, 2, 9], np.int64)
    jout = jf.PrepareFeatures(js)({"b": (values, offsets), "a": jnp.ones(3, jnp.int32)})
    tout = tf.PrepareFeatures(ts)({"b": (values, offsets), "a": torch.ones(3, dtype=torch.int32)})
    equal(tout["b"], jout["b"])
    assert np.array_equal(tout["b"].mask.numpy(), np.asarray(jout["b"].mask))
    wrapped = tf.PrepareFeatures(ts)({"b": torch.ones(2, L, dtype=torch.int32)})["b"]
    assert isinstance(wrapped, SequenceFeature) and bool(wrapped.mask.all())
    jx, tx = batch()
    jctx, tctx = JContext(features=jx), ModelContext(features=tx)
    jleft = jf.ToTarget(js, "a", JTags.CONTINUOUS)(jx, context=jctx)
    tleft = tf.ToTarget(ts, "a", Tags.CONTINUOUS)(tx, context=tctx)
    assert sorted(tleft) == sorted(jleft) == ["b", "c"]
    assert sorted(tctx.targets) == sorted(jctx.targets) == ["a", "x"]
    assert tf.ToTarget(ts, "a").transform_schema(ts)["a"].has_tag(Tags.TARGET)
    equal(tf.ExpandDims(-1)(tx)["c"], jf.ExpandDims(-1)(jx)["c"])
    equal(tf.ExpandDims(0)(tx["a"]), jf.ExpandDims(0)(jx["a"]))


def test_broadcast_to_sequence_matches_jax():
    js, ts = schemas(("b",))
    jx, tx = batch(("b",), seed=2)
    emb = np.random.default_rng(3).standard_normal((B, 4)).astype(np.float32)
    jx["e"], tx["e"] = jnp.asarray(emb), torch.from_numpy(emb)
    jb = jf.BroadcastToSequence(js.select_by_name(["x", "a"]) + JSchema([jcont("e")]),
                                js.select_by_name(["b"]))
    tb = tf.BroadcastToSequence(ts.select_by_name(["x", "a"]) + Schema([tcont("e")]),
                                ts.select_by_name(["b"]))
    jout, tout = jb(jx), tb(tx)
    for n in ("x", "e", "a"):
        equal(tout[n], jout[n])
        assert np.array_equal(tout[n].mask.numpy(), np.asarray(jout[n].mask))
    with pytest.raises(ValueError, match="no SequenceFeature"):
        tb({"x": tx["x"]})


def jax_draws(seed, step, index, shape, pad_ratio):
    """The JAX block's permutation and swap mask for one feature."""
    base = jax.random.fold_in(jax.random.key(seed), jnp.asarray(step, jnp.uint32))
    k1, k2 = jax.random.split(jax.random.fold_in(base, index))
    return (np.array(jax.random.permutation(k1, shape[0])),
            np.array(jax.random.bernoulli(k2, pad_ratio, shape)))


def test_stochastic_swap_noise_with_injected_draws():
    rng = np.random.default_rng(5)
    feats = {"z": rng.standard_normal((B, 3)).astype(np.float32),
             "a": rng.integers(0, 9, B).astype(np.int32)}
    seq_v, seq_m = rng.integers(0, 9, (B, L)).astype(np.int32), rng.random((B, L)) > 0.4
    jblock = jnoise.StochasticSwapNoise(pad_ratio=0.3, seed=7)
    jin = {k: jnp.asarray(v) for k, v in feats.items()}
    jin["s"] = JSeq(jnp.asarray(seq_v), jnp.asarray(seq_m))
    jout = jblock(jin, training=True, context=JContext(step=3))
    for i, name in enumerate(sorted(jin)):
        v = seq_v if name == "s" else feats[name]
        perm, swap = jax_draws(7, 3, i, v.shape, 0.3)
        got = tnoise._swap(torch.from_numpy(v), torch.from_numpy(perm), torch.from_numpy(swap))
        want = jout[name].values if name == "s" else jout[name]
        assert np.array_equal(got.numpy(), np.asarray(want)), name
    # the port's own draws: same shapes, a permutation, the ratio, evaluation untouched
    block = tnoise.StochasticSwapNoise(pad_ratio=0.3, seed=7)
    tin = {"z": torch.from_numpy(feats["z"]),
           "s": SequenceFeature(torch.from_numpy(seq_v), torch.from_numpy(seq_m))}
    out = block(tin, training=True, context=ModelContext(step=3))
    assert out["s"].mask is tin["s"].mask and out["z"].shape == (B, 3)
    perm, swap = block.draws(torch.zeros(4000, 2), step=1, index=0)
    assert sorted(perm.tolist()) == list(range(4000)) and 0.27 < float(swap.float().mean()) < 0.33
    assert block(tin, training=False) is tin
    again = block(tin, training=True, context=ModelContext(step=3))
    assert torch.equal(again["z"], out["z"])
