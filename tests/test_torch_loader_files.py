"""The port's Loader over parquet files, and its two repairs, against the JAX
package's on the CPU.

Both packages' loaders read the same directory (written by the JAX package)
and must yield the same batches, bit for bit (values, masks, dtypes, row
validity, targets), in the cases of ``tests/unit/test_data.py:135-250,
389-418``: several files streamed, one file of many row groups, shuffled
epochs, ``global_size=2``, each cache mode with a small
``cache_limit_bytes``, ``prefetch`` 0 and 2, ``transform``, ``pad`` max and
bucket, ``len``, the ``drop_last`` default, ``peek``, ``sample_batch``, and
``dense_columns`` / ``bucketed_dense_columns`` over files. An exception in the
producer thread reaches the caller; a consumer that stops early stops the
thread.

Repairs, each shown against JAX: the Loader's argument order and its
``drop_last=None`` default (before, ``Loader(ds, 32, True)`` set
``drop_last`` where JAX sets ``shuffle``, and ``Loader(ds, 1000,
shuffle=True)`` kept a padded tail JAX drops); ``ConcatFeatures`` of sequence
features returns a SequenceFeature (before, a tensor).

Fits: a small two-tower model fit from files (one step at a time through the
streaming loader, and k = 2 steps a chunk from ``dense_columns``) equals the
same fit from memory bit for bit, and the JAX package's fit from the same
files within rtol 1e-5 (tests/test_torch_two_tower_training.py's tolerance)
after ``load_jax_params``.
"""

import gc
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import models_tpu as mm
from models_tpu.core.aggregation import ConcatFeatures as JConcat
from models_tpu.core.types import SequenceFeature as JSeq
from models_tpu.models import TwoTowerModel as JTwoTowerModel

import models_tpu_torch as mt
from models_tpu_torch.core.aggregation import ConcatFeatures as TConcat
from models_tpu_torch.core.types import SequenceFeature as TSeq
from models_tpu_torch.data import Loader, sample_batch

ROW_VALID = "__row_valid__"


def flat(batch):
    """A (features, targets) batch as a flat dict of numpy arrays."""
    feats, targets = batch
    out = {}
    for name, v in feats.items():
        if isinstance(v, (JSeq, TSeq)):
            out[name + "/values"], out[name + "/mask"] = np.asarray(v.values), np.asarray(v.mask)
        else:
            out[name] = np.asarray(v)
    if isinstance(targets, dict):
        out.update({f"target/{k}": np.asarray(v) for k, v in targets.items()})
    elif targets is not None:
        out["target"] = np.asarray(targets)
    return out


def assert_same_batches(got, want, what):
    assert len(got) == len(want), (what, len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = flat(g), flat(w)
        assert sorted(g) == sorted(w), (what, i)
        for k in w:
            assert g[k].dtype == w[k].dtype, (what, i, k, g[k].dtype, w[k].dtype)
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{what} batch {i}: {k}")


def epochs(loader, n):
    return [b for _ in range(n) for b in loader]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """Directories the JAX package writes (its to_parquet)."""
    root = tmp_path_factory.mktemp("loader")
    music = mm.data.generate_data("music-streaming", num_rows=230, seed=1)
    testing = mm.data.generate_data("testing", num_rows=200, seed=2)
    seq = mm.data.generate_data("sequence-testing", num_rows=200, seed=3)
    return {
        "music_parts": music.to_parquet(str(root / "mp"), num_partitions=4),
        "music_groups": music.to_parquet(str(root / "mg"), row_group_size=48),
        "testing_parts": testing.to_parquet(str(root / "tp"), num_partitions=3),
        "testing_one": testing.to_parquet(str(root / "t1")),
        "seq_groups": seq.to_parquet(str(root / "sg"), row_group_size=64),
        "seq_one": seq.to_parquet(str(root / "s1")),
    }


def double_first_float(feats, targets):
    feats = dict(feats)
    name = sorted(k for k, v in feats.items()
                  if not isinstance(v, (JSeq, TSeq)) and np.asarray(v).dtype == np.float32)[0]
    feats[name] = feats[name] * 2.0
    return feats, targets


CASES = {
    "several_files": ("music_parts", dict(batch_size=32, shuffle=False, drop_last=False), 1),
    "one_file_row_groups": ("music_groups", dict(batch_size=32, shuffle=False, drop_last=False),
                            1),
    "shuffled_epochs": ("testing_parts", dict(batch_size=50, shuffle=True, seed=3), 2),
    "shuffled_row_groups": ("music_groups", dict(batch_size=32, shuffle=True, seed=7,
                                                 drop_last=False), 2),
    "global_rank_0": ("testing_parts", dict(batch_size=16, global_size=2, global_rank=0), 1),
    "global_rank_1_shuffled": ("testing_parts", dict(batch_size=16, shuffle=True,
                                                     global_size=2, global_rank=1), 2),
    "global_one_chunk": ("testing_one", dict(batch_size=16, shuffle=True, global_size=2,
                                             global_rank=1, drop_last=False), 2),
    "cache_true_small": ("music_groups", dict(batch_size=32, shuffle=True, cache=True,
                                              cache_limit_bytes=12_000), 2),
    "cache_auto_small": ("music_groups", dict(batch_size=32, shuffle=True,
                                              cache_limit_bytes=12_000), 2),
    "cache_false": ("music_groups", dict(batch_size=32, shuffle=True, cache=False), 2),
    "cache_one_chunk": ("testing_one", dict(batch_size=48, shuffle=True, cache=True), 2),
    "prefetch_0": ("music_parts", dict(batch_size=32, prefetch=0, drop_last=False), 1),
    "prefetch_2": ("music_parts", dict(batch_size=32, prefetch=2, drop_last=False), 1),
    "transform": ("testing_parts", dict(batch_size=32, transform=double_first_float), 1),
    "pad_max": ("seq_groups", dict(batch_size=32, drop_last=False), 1),
    "pad_bucket": ("seq_groups", dict(batch_size=32, pad="bucket", drop_last=False), 1),
    "pad_bucket_shuffled": ("seq_groups", dict(batch_size=32, pad="bucket", shuffle=True), 2),
    "pad_bucket_global": ("seq_one", dict(batch_size=16, pad="bucket", shuffle=True,
                                          global_size=2, global_rank=0), 2),
    "drop_last_default": ("music_parts", dict(batch_size=64, shuffle=True), 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loader_over_files_matches_jax(dirs, case):
    where, kw, n_epochs = CASES[case]
    path = dirs[where]
    got_loader = Loader(mt.Dataset(path), **kw)
    want_loader = mm.data.Loader(mm.data.Dataset.from_parquet(path), **kw)
    assert len(got_loader) == len(want_loader)
    assert got_loader.drop_last == want_loader.drop_last
    assert_same_batches(epochs(got_loader, n_epochs), epochs(want_loader, n_epochs), case)
    assert got_loader.epoch_seed() == want_loader.epoch_seed()
    assert got_loader.output_schema.to_dict() == want_loader.output_schema.to_dict()


def test_the_loader_takes_a_path_and_a_schema(dirs):
    path = dirs["music_parts"]
    schema = mt.Dataset(path).schema.excluding_by_name(["item_genres"])
    got = Loader(path, 32, schema=schema)
    want = mm.data.Loader(path, 32, schema=mm.data.Dataset(path).schema.excluding_by_name(
        ["item_genres"]))
    assert_same_batches(list(got), list(want), "path and schema")
    assert "item_genres" not in flat(got.peek())


def test_peek_and_sample_batch_match_jax(dirs):
    path = dirs["seq_groups"]
    tl, jl = Loader(path, 24, shuffle=True, seed=5), mm.data.Loader(path, 24, shuffle=True,
                                                                     seed=5)
    assert_same_batches([tl.peek()], [jl.peek()], "peek")
    got = sample_batch(mt.Dataset(path), batch_size=8, shuffle=True, to_device=False)
    want = mm.data.sample_batch(mm.data.Dataset(path), batch_size=8, shuffle=True,
                                to_device=False)
    assert_same_batches([got], [want], "sample_batch")
    feats = sample_batch(path, batch_size=8, include_targets=False, device="cpu")
    assert all(isinstance(v, (torch.Tensor, TSeq)) for v in feats.values())
    np.testing.assert_array_equal(feats[ROW_VALID].numpy(), np.ones(8, bool))
    with pytest.raises(ValueError, match="no batches"):
        Loader(path, 500, drop_last=True).peek()


def test_pad_bucket_over_several_hosts_refuses_the_streamed_route(dirs):
    for pkg, ds in ((mm.data, mm.data.Dataset(dirs["seq_groups"])),
                    (mt.data, mt.Dataset(dirs["seq_groups"]))):
        loader = pkg.Loader(ds, 16, pad="bucket", global_size=2, global_rank=0)
        with pytest.raises(ValueError, match="pad='bucket'"):
            list(loader)


def test_dense_columns_over_files_match_jax(dirs):
    for where in ("music_parts", "music_groups", "seq_groups"):
        path = dirs[where]
        tf, tt, tn = Loader(path, 32).dense_columns()
        jf, jt, jn = mm.data.Loader(path, 32).dense_columns()
        assert tn == jn == mt.Dataset(path).num_rows
        assert_same_batches([(tf, tt)], [(jf, jt)], f"dense_columns {where}")
    tg = Loader(dirs["seq_groups"], 16, pad="bucket").bucketed_dense_columns()
    jg = mm.data.Loader(dirs["seq_groups"], 16, pad="bucket").bucketed_dense_columns()
    assert [(b, n) for b, _, _, n in tg] == [(b, n) for b, _, _, n in jg]
    assert_same_batches([(f, t) for _, f, t, _ in tg], [(f, t) for _, f, t, _ in jg],
                        "bucketed_dense_columns")
    with pytest.raises(ValueError, match="transform"):
        Loader(dirs["music_parts"], 32, transform=double_first_float).dense_columns()
    with pytest.raises(ValueError, match="transform"):
        Loader(dirs["seq_groups"], 32, pad="bucket",
               transform=double_first_float).bucketed_dense_columns()


def test_the_cache_holds_what_fits(dirs):
    path = dirs["music_groups"]
    probe = Loader(path, 32, cache=False)
    one = sum(a.nbytes for a in probe._read_chunk(probe._chunk_list(), 0).values())
    small = Loader(path, 32, cache_limit_bytes=int(2.5 * one))
    list(small)
    assert len(small._chunk_list()) == 5 and sorted(small._file_cache) == [0, 1]
    assert small._cache_bytes <= 2.5 * one
    off = Loader(path, 32, cache=False)
    list(off)
    assert not off._file_cache and off._col_cache is None
    full = Loader(path, 32)
    list(full)
    assert len(full._file_cache) == 5 and full._col_cache is None  # streamed, never whole


def test_a_producer_exception_reaches_the_caller(dirs):
    calls = []

    def fails_on_the_third(feats, targets):
        calls.append(1)
        if len(calls) == 3:
            raise KeyError("third batch")
        return feats, targets

    loader = Loader(dirs["music_parts"], 32, prefetch=2, transform=fails_on_the_third)
    it = iter(loader)
    next(it), next(it)
    with pytest.raises(KeyError, match="third batch"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)


def test_a_consumer_that_stops_early_stops_the_producer(dirs):
    before = threading.active_count()
    loader = Loader(dirs["music_groups"], 8, prefetch=2)
    it = iter(loader)
    next(it)
    thread = it._thread
    del it
    gc.collect()
    thread.join(timeout=10)
    assert not thread.is_alive()
    assert threading.active_count() <= before


# ---- the two repairs --------------------------------------------------------

def test_loader_signature_and_drop_last_default_match_jax():
    """``Loader(ds, batch, shuffle, drop_last=None, seed, ...)`` with
    ``drop_last`` defaulting to ``shuffle``: ``Loader(ds, 32, True)``
    shuffles, and a shuffled loader drops its partial tail, as JAX's does."""
    jds = mm.data.generate_data("testing", num_rows=2500, seed=4)
    tds = mt.generate_data("testing", num_rows=2500, seed=4)
    t, j = Loader(tds, 1000, shuffle=True), mm.data.Loader(jds, 1000, shuffle=True)
    assert t.drop_last and j.drop_last and len(t) == len(j) == 2
    assert len(list(t)) == len(list(j)) == 2
    t, j = Loader(tds, 32, True), mm.data.Loader(jds, 32, True)
    assert (t.shuffle, t.drop_last) == (j.shuffle, j.drop_last) == (True, True)
    tb, jb = next(iter(t)), next(iter(j))
    np.testing.assert_array_equal(tb[0]["item_id"], jb[0]["item_id"])
    assert not np.array_equal(tb[0]["item_id"], np.asarray(tds.to_numpy_dict()["item_id"][:32]))
    assert not Loader(tds, 32).drop_last and not Loader(tds, 32, False, True).shuffle


def test_concat_features_keeps_the_sequence_mask_as_jax():
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((4, 5, 3)).astype(np.float32), rng.standard_normal(
        (4, 5, 2)).astype(np.float32)
    ma, mb = rng.random((4, 5)) < 0.7, rng.random((4, 5)) < 0.4
    want = JConcat()({"a": JSeq(jnp.asarray(a), jnp.asarray(ma)),
                      "b": JSeq(jnp.asarray(b), jnp.asarray(mb))})
    got = TConcat()({"b": TSeq(torch.as_tensor(b), torch.as_tensor(mb)),
                     "a": TSeq(torch.as_tensor(a), torch.as_tensor(ma))})
    assert isinstance(want, JSeq) and isinstance(got, TSeq)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    flat_out = TConcat()({"x": torch.ones(4, 2), "y": torch.zeros(4)})
    assert isinstance(flat_out, torch.Tensor) and flat_out.shape == (4, 3)


# ---- fits from files --------------------------------------------------------

def jax_flat_params(model):
    return {"/".join(str(p) for p in path): np.asarray(var[...])
            for path, var in nnx.state(model, nnx.Param).flat_state()}


@pytest.fixture(scope="module")
def fit_dir(tmp_path_factory):
    jds = mm.data.generate_data("movielens-25m", num_rows=320, seed=9)
    return jds.to_parquet(str(tmp_path_factory.mktemp("fit") / "p"), row_group_size=100,
                          num_partitions=2)


def port_fit(path, data, spe=1, epochs=2):
    jm = JTwoTowerModel(mm.data.Dataset(path).schema, query_tower=(16, 8), embedding_dim=8)
    jm.compile()
    jm.build(mm.data.Loader(mm.data.Dataset(path), 64))
    tm = mt.TwoTowerModel(mt.Dataset(path).schema, query_tower=(16, 8), embedding_dim=8,
                          device="cpu")
    mt.load_jax_params(tm, jax_flat_params(jm))
    tm.compile(optimizer="adagrad", learning_rate=0.05, metrics=[], steps_per_execution=spe)
    hist = tm.fit(data, epochs=epochs, batch_size=64, shuffle=False, device="cpu")
    return jm, tm, hist


def test_fit_from_files_equals_fit_from_memory_and_jax(fit_dir):
    files = mt.Dataset(fit_dir)
    memory = mt.Dataset(files.table(), schema=files.schema)
    assert memory.files is None
    jm, tm_files, h_files = port_fit(fit_dir, files)
    _, tm_mem, h_mem = port_fit(fit_dir, memory)
    assert h_files.history["loss"] == h_mem.history["loss"]
    for (name, p), (_, q) in zip(tm_files.named_parameters(), tm_mem.named_parameters()):
        assert torch.equal(p, q), name
    jm.compile(optimizer="adagrad", learning_rate=0.05, metrics=[])
    jh = jm.fit(mm.data.Dataset.from_parquet(fit_dir), epochs=2, batch_size=64, shuffle=False,
                verbose=0)
    np.testing.assert_allclose(h_files.history["loss"], jh.history["loss"], rtol=1e-5)
    # a path-backed loader, streamed with prefetch and no cache
    _, tm_loader, h_loader = port_fit(fit_dir, Loader(fit_dir, 64, shuffle=False,
                                                      drop_last=True, cache=False))
    assert h_loader.history["loss"] == h_mem.history["loss"]


def test_chunked_fit_from_files_equals_chunked_fit_from_memory(fit_dir):
    files = mt.Dataset(fit_dir)
    memory = mt.Dataset(files.table(), schema=files.schema)
    _, tm_files, h_files = port_fit(fit_dir, files, spe=2)
    _, tm_mem, h_mem = port_fit(fit_dir, memory, spe=2)
    assert files._device_train_pack is not None  # the chunked route ran on the files
    assert h_files.history["loss"] == h_mem.history["loss"]
    for (name, p), (_, q) in zip(tm_files.named_parameters(), tm_mem.named_parameters()):
        assert torch.equal(p, q), name


def test_batch_predict_and_evaluate_on_files(fit_dir):
    files = mt.Dataset(fit_dir)
    memory = mt.Dataset(files.table(), schema=files.schema)
    _, tm, _ = port_fit(fit_dir, files, epochs=1)
    got = tm.evaluate(files, batch_size=64, device="cpu")
    assert got == tm.evaluate(memory, batch_size=64, device="cpu")
    out = tm.batch_predict(files, batch_size=64, device="cpu")
    assert out.files is None and out.num_rows == files.num_rows
    added = sorted(set(out.column_names) - set(files.column_names))
    assert added and all(n.startswith("prediction") for n in added)
    want = tm.batch_predict(memory, batch_size=64, device="cpu").to_numpy_dict()
    for name in added:
        np.testing.assert_array_equal(out.to_numpy_dict()[name], want[name])
