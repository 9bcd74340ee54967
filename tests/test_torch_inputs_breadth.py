"""The rest of the port's inputs against the JAX package's, on the CPU:
pretrained and frozen tables, ``Embeddings``' keywords, the pretrained and
V1 input blocks, dynamic-vocabulary tables and tensor-train tables, and
``load_jax_params`` for each new kind of state.

Tolerances: lookups are copies (exact); pooled and contracted outputs and
their gradients within rtol 1e-5, atol 1e-6. A dynamic table's slots and
keys are integers and must be equal bit for bit, after training steps too
(duplicate ids and races for a slot in one batch); the parameters after
training within rtol 1e-4, atol 1e-6 (fp32 sums in another order over
three steps). ``string_id_hash`` must equal the JAX function's on every
value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import models_tpu as mm
from models_tpu.inputs import dynamic as jdyn
from models_tpu.inputs import embedding as jemb
from models_tpu.inputs import tt_embedding as jtt
from models_tpu.inputs.base import InputBlock as JInputBlock
from models_tpu.inputs.base import InputBlockV2 as JInputBlockV2
from models_tpu.core.types import ModelContext as JContext
from models_tpu.core.types import SequenceFeature as JSeq
from models_tpu.schema import Schema as JSchema
from models_tpu.schema import Tags as JTags
from models_tpu.schema import create_categorical_column as jcat
from models_tpu.schema import create_continuous_column as jcont

import models_tpu_torch as mt
from models_tpu_torch.core.types import ModelContext, SequenceFeature
from models_tpu_torch.inputs import dynamic as tdyn
from models_tpu_torch.inputs import embedding as temb
from models_tpu_torch.inputs import tt_embedding as ttt
from models_tpu_torch.schema import Schema, Tags
from models_tpu_torch.schema import create_categorical_column as tcat
from models_tpu_torch.schema import create_continuous_column as tcont

RTOL, ATOL = 1e-5, 1e-6


def jax_vars(module, kind=nnx.Variable):
    return {"/".join(str(p) for p in path): np.asarray(v[...])
            for path, v in nnx.state(module, kind).flat_state()
            if "sparse_slots" not in path}


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def schemas(cols):
    """The same columns as a JAX and a port schema: (name, card, tags, list len)."""
    js, ts = [], []
    for name, card, tags, L in cols:
        if card is None:
            js.append(jcont(name, tags=tags))
            ts.append(tcont(name, tags=tags))
        else:
            js.append(jcat(name, card, tags=tags, is_list=bool(L), max_seq_length=L))
            ts.append(tcat(name, card, tags=tags, is_list=bool(L), max_seq_length=L))
    return JSchema(js), Schema(ts)


def batch(schema_cols, B=6, seed=0):
    rng = np.random.default_rng(seed)
    jx, tx = {}, {}
    for name, card, _, L in schema_cols:
        if card is None:
            v = rng.standard_normal(B).astype(np.float32)
            jx[name], tx[name] = jnp.asarray(v), torch.from_numpy(v)
        elif L:
            v = rng.integers(0, card + 1, (B, L)).astype(np.int32)
            m = rng.random((B, L)) > 0.3
            jx[name] = JSeq(jnp.asarray(v), jnp.asarray(m))
            tx[name] = SequenceFeature(torch.from_numpy(v), torch.from_numpy(m))
        else:
            v = rng.integers(0, card + 1, B).astype(np.int32)
            jx[name], tx[name] = jnp.asarray(v), torch.from_numpy(v)
    return jx, tx


def outputs_close(tout, jout):
    assert sorted(tout) == sorted(jout)
    for k in jout:
        t, j = tout[k], jout[k]
        if isinstance(j, JSeq):
            close(t.values, j.values, msg=k)
            assert np.array_equal(t.mask.numpy(), np.asarray(j.mask))
        else:
            close(t, j, msg=k)


COLS = [("user", 40, (Tags.USER,), 0), ("item", 30, (Tags.ITEM,), 0),
        ("genres", 12, (Tags.ITEM,), 4), ("age", None, (Tags.USER,), 0)]


def test_table_weights_trainable_initializer_and_from_pretrained():
    col = tcat("movie", 9)
    rows = np.arange(10 * 4, dtype=np.float32).reshape(10, 4)
    frozen = mt.EmbeddingTable(4, col, weights=rows, trainable=False, device="cpu")
    assert "table" in dict(frozen.named_buffers()) and not list(frozen.parameters())
    assert frozen.table.shape == (16, 4) and np.array_equal(frozen.to_array(), rows)
    assert not frozen.table[10:].any()
    jt = jemb.EmbeddingTable.from_pretrained(rows, trainable=False)
    tt = mt.EmbeddingTable.from_pretrained(rows, trainable=False, device="cpu")
    assert tt.block_name == jt.block_name == "pretrained" and tt.input_dim == jt.input_dim
    assert np.array_equal(tt.to_array(), jt.to_array())
    ids = np.array([0, 9, 3, 3], np.int32)
    assert np.array_equal(tt(torch.from_numpy(ids)).numpy(), np.asarray(jt(jnp.asarray(ids))))
    with pytest.raises(ValueError, match="Pretrained weights"):
        mt.EmbeddingTable(4, tcat("x", 3), weights=rows, device="cpu")
    ones = mt.EmbeddingTable(3, col, device="cpu",
                             initializer=lambda gen, shape, device: torch.ones(shape))
    assert torch.equal(ones.table, torch.ones(16, 3)) and isinstance(ones.table, torch.nn.Parameter)


@pytest.mark.parametrize("case", ["dims-and-trainable", "fused-exclusions"])
def test_embeddings_keywords_match_jax(case):
    cols = COLS[:3] + [("shop", 20, (Tags.ITEM,), 0), ("city", 7, (Tags.USER,), 0)]
    js, ts = schemas(cols)
    pre = np.random.default_rng(1).standard_normal((31, 8)).astype(np.float32)
    if case == "dims-and-trainable":
        kw = dict(dim={"user": 16, "genres": 8}, infer_dim_multiplier=3.0,
                  trainable={"item": False}, sequence_combiner="sum", l2_reg=0.01)
    else:
        kw = dict(dim=8, fused=True, trainable={"city": False},
                  table_kwargs={"item": {"weights": pre}})
    jb = mm.Embeddings(js, seed=3, **kw)
    tb = mt.Embeddings(ts, seed=3, device="cpu", **kw)
    assert list(tb.branches) == list(jb.branches)
    for name, t in tb.branches.items():
        j = jb.branches[name]
        assert (t.dim, t.trainable) == (j.dim, j.trainable) and type(t).__name__ == type(j).__name__
    mt.load_jax_params(tb, jax_vars(jb))
    jx, tx = batch(cols)
    outputs_close(tb(tx), jb(jx))
    if case == "dims-and-trainable":
        assert not tb.branches["item"].table.requires_grad
        close(sum(m.regularization_loss() for m in tb.branches.values()),
              sum(m.regularization_loss() for m in jb.branches.values()))
    else:
        assert np.array_equal(tb.branches["item"].to_array(), pre)


def test_pretrained_and_weighted_average_blocks_match_jax():
    js, ts = schemas([("item", 20, (Tags.ITEM,), 5)])
    js = js + JSchema([jcont("vec", tags=(JTags.EMBEDDING,)),
                       jcont("w", tags=(JTags.CONTINUOUS,))])
    ts = ts + Schema([tcont("vec", tags=(Tags.EMBEDDING,)), tcont("w", tags=(Tags.CONTINUOUS,))])
    rng = np.random.default_rng(2)
    v, m = rng.standard_normal((4, 5, 3)).astype(np.float32), rng.random((4, 5)) > 0.4
    w = rng.random((4, 5)).astype(np.float32)
    jseq, tseq = JSeq(jnp.asarray(v), jnp.asarray(m)), SequenceFeature(torch.from_numpy(v),
                                                                        torch.from_numpy(m))
    jp = jemb.PretrainedEmbeddings(js, normalizer=jnp.tanh)({"vec": jseq})
    tp = temb.PretrainedEmbeddings(ts, normalizer=torch.tanh)({"vec": tseq})
    close(tp["vec"], jp["vec"])
    assert temb.PretrainedEmbeddingsBlock(ts).schema.column_names == ["vec"]
    jctx = JContext(features={"w": JSeq(jnp.asarray(w), jnp.asarray(m))})
    tctx = ModelContext(features={"w": SequenceFeature(torch.from_numpy(w), torch.from_numpy(m))})
    close(temb.AverageEmbeddingsByWeightFeature("w")({"vec": tseq}, context=tctx)["vec"],
          jemb.AverageEmbeddingsByWeightFeature("w")({"vec": jseq}, context=jctx)["vec"])
    for fn in ("EmbeddingFeatures", "SequenceEmbeddingFeatures"):
        jb = getattr(jemb, fn)(js.select_by_name(["item"]), dim=4)
        tb = getattr(temb, fn)(ts.select_by_name(["item"]), dim=4, device="cpu")
        mt.load_jax_params(tb, jax_vars(jb))
        jx, tx = batch([("item", 20, (), 5)])
        outputs_close(tb(tx), jb(jx))


@pytest.mark.parametrize("case", ["v2-branches", "v1-projection"])
def test_input_blocks_match_jax(case):
    cols = COLS
    js, ts = schemas(cols)
    if case == "v2-branches":
        jb = JInputBlockV2(js, categorical=jemb.Embeddings(js.select_by_name(["user", "item"]),
                                                           dim=4, trainable={"item": False}),
                           aggregation="concat")
        tb = mt.InputBlockV2(ts, categorical=mt.Embeddings(ts.select_by_name(["user", "item"]),
                                                           dim=4, trainable={"item": False},
                                                           device="cpu"),
                             aggregation="concat", device="cpu")
        assert tb.out_features is None
    else:
        jb = JInputBlock(js, continuous_projection=(5,), embedding_dim_default=6)
        tb = mt.InputBlock(ts, continuous_projection=(5,), embedding_dim_default=6, device="cpu")
    jx, tx = batch(cols, seed=3)
    jout = jb(jx)
    tb(tx)  # builds the projection, if any
    mt.load_jax_params(tb, jax_vars(jb))
    close(tb(tx), jout)


# ---- dynamic-vocabulary tables ---------------------------------------------

def test_mix_and_slots_are_jax_bit_for_bit():
    ids = np.concatenate([np.arange(0, 64), np.random.default_rng(0).integers(0, 2**31 - 1, 500),
                          [2**31 - 1, 0x7FEB352D]]).astype(np.int32)
    assert np.array_equal(tdyn._mix(torch.from_numpy(ids)).numpy(),
                          np.asarray(jdyn._mix(jnp.asarray(ids))).astype(np.int64))
    # lookups into a table a quarter full, then claims with races and duplicates
    jt = jdyn.DynamicEmbeddingTable(4, jcat("item", 99), capacity=40)
    tt = tdyn.DynamicEmbeddingTable(4, tcat("item", 99), capacity=40, device="cpu")
    assert tt.capacity == jt.capacity == 40
    keys = np.full(40, -1, np.int32)
    keys[np.random.default_rng(1).choice(40, 12, replace=False)] = np.arange(12) * 7919
    raw = np.concatenate([np.arange(12) * 7919, np.arange(60) * 104729, [5, 5, 5]]).astype(
        np.int32)
    for training in (False, True):
        jslots, jkeys = jt._map_ids(jnp.asarray(raw), jnp.asarray(keys), training)
        tkeys = torch.from_numpy(keys.copy())
        tslots = tt._map_ids(torch.from_numpy(raw), tkeys, training)
        assert np.array_equal(tslots.numpy(), np.asarray(jslots))
        assert np.array_equal(tkeys.numpy(), np.asarray(jkeys))


def dynamic_models(capacity, seed=4):
    cols = [("item", 10**9, (Tags.ITEM_ID,), 0), ("user", 10**9, (Tags.USER_ID,), 0)]
    js, ts = schemas(cols)
    js = js + JSchema([jcat("click", 1, tags=(JTags.TARGET, JTags.BINARY_CLASSIFICATION))])
    ts = ts + Schema([tcat("click", 1, tags=(Tags.TARGET, Tags.BINARY_CLASSIFICATION))])
    rng = np.random.default_rng(seed)
    n = 96
    # 60 distinct items in 96 rows (duplicates in a batch), 31-bit raw ids
    items = (rng.integers(0, 60, n).astype(np.int64) * 2654435761 % 2**31).astype(np.int64)
    users = mt.string_id_hash(np.array([f"user_{u}" for u in rng.integers(0, 30, n)]))
    data = {"item": items, "user": users.astype(np.int64), "click": (items % 2).astype(np.float32)}
    jds, tds = mm.Dataset(data, schema=js), mt.Dataset(data, schema=ts)
    kw = dict(dim=4, dynamic=True, dynamic_capacity={"item": capacity, "user": 32})

    def model(pkg, schema, **dev):
        emb = pkg.Embeddings(schema.categorical.excluding_by_tag(Tags.TARGET), **kw, **dev)
        body = pkg.InputBlockV2(schema, categorical=emb, **dev) >> pkg.MLPBlock([8])
        return pkg.Model(body, pkg.BinaryOutput("click"))

    jm, tm = model(mm, js), model(mt, ts, device="cpu")
    jm.build(mm.Loader(jds, 32))
    tm.build(tds, device="cpu")
    mt.load_jax_params(tm, jax_vars(jm))
    return jds, tds, jm, tm


@pytest.mark.parametrize("capacity", [80, 40])
def test_dynamic_table_training_matches_jax(capacity):
    """Three adam steps; at capacity 40 the items overflow their slots."""
    jds, tds, jm, tm = dynamic_models(capacity)
    kw = dict(optimizer="adam", learning_rate=0.05, metrics=[])
    jm.compile(**kw)
    tm.compile(**kw)
    jh = jm.fit(jds, batch_size=32, shuffle=False, verbose=0)
    th = tm.fit(tds, batch_size=32, shuffle=False, device="cpu")
    close(th.history["loss"], jh.history["loss"])
    jstate, tstate = jax_vars(jm), {}
    for name, t in list(tm.named_parameters()) + list(tm.named_buffers()):
        tstate[name.replace(".", "/")] = t.detach().numpy()
    for key, want in jstate.items():
        key_t = key[:-len("kernel")] + "weight" if key.endswith("kernel") else key
        got = tstate[key_t].T if key.endswith("kernel") else tstate[key_t]
        if key.endswith("hash_keys"):
            assert np.array_equal(got, want), key
        else:
            close(got, want, rtol=1e-4, msg=key)
    tables = [m for m in tm.modules() if isinstance(m, tdyn.DynamicEmbeddingTable)]
    jtables = [m for m in nnx.iter_graph(jm) if isinstance(m[1], jdyn.DynamicEmbeddingTable)]
    assert [t.num_allocated for t in tables] == [t[1].num_allocated for t in jtables]
    assert tables[0].num_allocated <= len(np.unique(tds.to_numpy_dict()["item"]))
    keys = [t.hash_keys.clone() for t in tables]
    tm.evaluate(tds, batch_size=32, device="cpu")
    tm.predict(tds, batch_size=32, device="cpu")
    assert all(torch.equal(k, t.hash_keys) for k, t in zip(keys, tables))


def test_dynamic_table_row_sparse_updates_the_slots():
    _, tds, _, tm = dynamic_models(80)
    tm.compile(optimizer="adam", learning_rate=0.05, embedding_optimizer="adagrad", metrics=[])
    before = {n: t.table.detach().clone() for n, t in
              ((m.block_name, m) for m in tm.modules() if isinstance(m, tdyn.DynamicEmbeddingTable))}
    tm.fit(tds, batch_size=32, shuffle=False, device="cpu")
    for m in tm.modules():
        if isinstance(m, tdyn.DynamicEmbeddingTable):
            moved = (m.table != before[m.block_name]).any(dim=1)
            owned = m.hash_keys != tdyn.EMPTY
            assert m.sparse_routed and moved.any() and not (moved & ~owned).any()


def test_string_id_hash_equals_jax_without_pandas_in_the_port():
    vals = np.array(["a", "", "héllo wörld ✓", b"raw\x00bytes", "x" * 37, "user_12", None],
                    dtype=object)
    assert np.array_equal(mt.string_id_hash(vals), jdyn.string_id_hash(vals))
    words = np.array([f"w{i}" for i in range(300)])
    assert np.array_equal(mt.string_id_hash(words), jdyn.string_id_hash(words))
    assert "pandas" not in tdyn.__dict__


# ---- tensor-train tables -----------------------------------------------------

@pytest.mark.parametrize("card,dim,ranks", [(1000, 16, 4), (777, 12, (3, 5))])
def test_tt_lookups_and_gradients_match_jax(card, dim, ranks):
    for n in (card, 31_457_706 // 10, 10_131_227):
        assert ttt._factorize3(n) == jtt._factorize3(n)
    assert ttt._factorize_dim(dim) == jtt._factorize_dim(dim)
    jt = jtt.TTEmbeddingTable(dim, jcat("item", card - 1), ranks=ranks, sequence_combiner="mean")
    tt = ttt.TTEmbeddingTable(dim, tcat("item", card - 1), ranks=ranks, sequence_combiner="mean",
                              device="cpu")
    mt.load_jax_params(tt, jax_vars(jt))
    ids = np.random.default_rng(5).integers(0, card, 64).astype(np.int32)
    close(tt(torch.from_numpy(ids)), jt(jnp.asarray(ids)))
    close(tt.embeddings[:50], jt.embeddings[:50])
    seq = ids.reshape(16, 4)
    mask = np.random.default_rng(6).random((16, 4)) > 0.3
    close(tt(SequenceFeature(torch.from_numpy(seq), torch.from_numpy(mask))),
          jt(JSeq(jnp.asarray(seq), jnp.asarray(mask))))
    w = np.random.default_rng(7).standard_normal((64, dim)).astype(np.float32)

    graphdef, state = nnx.split(jt)

    def jloss(state):
        return jnp.sum(nnx.merge(graphdef, state)(jnp.asarray(ids)) * w)

    jgrads = jax.grad(jloss)(state)
    (tt(torch.from_numpy(ids)) * torch.from_numpy(w)).sum().backward()
    for name in ("core1", "core2", "core3"):
        close(getattr(tt, name).grad, jgrads[name][...], msg=name)


def test_embeddings_makes_tt_tables_above_the_threshold():
    js, ts = schemas([("big", 5000, (), 0), ("small", 50, (), 0)])
    jb = mm.Embeddings(js, dim=8, tt_compression_threshold=1000, tt_ranks=4)
    tb = mt.Embeddings(ts, dim=8, tt_compression_threshold=1000, tt_ranks=4, device="cpu")
    assert isinstance(tb.branches["big"], ttt.TTEmbeddingTable)
    assert isinstance(tb.branches["small"], temb.EmbeddingTable)
    mt.load_jax_params(tb, jax_vars(jb))
    jx, tx = batch([("big", 4999, (), 0), ("small", 49, (), 0)])
    outputs_close(tb(tx), jb(jx))
    with pytest.warns(UserWarning, match="DENSE"):
        frozen = mt.Embeddings(ts, dim=8, tt_compression_threshold=1000, trainable=False,
                               device="cpu")
    assert isinstance(frozen.branches["big"], temb.EmbeddingTable)


def test_load_jax_params_carries_buffers_keys_cores_and_lazy_kernels():
    js, ts = schemas([("dyn", 100, (), 0), ("big", 3000, (), 0), ("frozen", 40, (), 0)])
    kw = dict(dim=4, dynamic={"dyn": True}, dynamic_capacity={"dyn": 16},
              tt_compression_threshold=2000, tt_ranks=2, trainable={"frozen": False})
    jb = mm.Embeddings(js, **kw) >> mm.MLPBlock([3])
    tb = mt.Embeddings(ts, device="cpu", **kw) >> mt.MLPBlock([3])
    jx, tx = batch([("dyn", 100, (), 0), ("big", 2999, (), 0), ("frozen", 39, (), 0)])
    jx = {k: v for k, v in jx.items()}
    dyn = jb.layers[0].branches["dyn"]
    dyn.hash_keys.value = dyn.hash_keys.value.at[3].set(77)  # a claimed slot
    agg = mm.core.aggregation.ConcatFeatures()
    jblk = mm.core.combinators.SequentialBlock([jb.layers[0], agg, jb.layers[1]])
    tblk = mt.SequentialBlock([tb.layers[0], mt.core.ConcatFeatures(), tb.layers[1]])
    jout = jblk(jx)
    tblk(tx)  # builds the lazy Dense
    state = jax_vars(jblk)
    mt.load_jax_params(tblk, state)
    close(tblk(tx), jout)
    tdyn_t = tblk.layers[0].branches["dyn"]
    assert tdyn_t.hash_keys.dtype == torch.int32 and int(tdyn_t.hash_keys[3]) == 77
    assert "layers.0.branches.frozen.table" in dict(tblk.named_buffers())
    with pytest.raises(ValueError, match="left unset"):
        mt.load_jax_params(tblk, {k: v for k, v in state.items() if "core2" not in k})
