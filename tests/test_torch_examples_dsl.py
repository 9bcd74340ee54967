"""The bodies of ``examples/11_custom_architecture.py``,
``15_pretrained_embeddings_finetuning.py`` and
``17_dynamic_vocab_streaming_ids.py`` on the port's names (on the CPU),
against the same bodies on the JAX package's, at the examples' shapes with
fewer rows.

- 11 (the block DSL, widths built at the build pass): both built on the
  same data, the JAX parameters carried over; two epochs of adam with
  validation, shuffled: every epoch's loss and validation loss within rtol
  1e-4 (fp32 sums in another order over four steps).
- 15 (a pretrained ``movieId`` table, frozen, then fine-tuned): the frozen
  table bit-unchanged after the first day, moved after the second, in both
  packages; the losses within rtol 1e-4. The example's MovieLens-100k comes
  from ``get_movielens``; here both sides take ``generate_data
  ("movielens-100k")`` (the schema's layout).
- 17 (dynamic-vocabulary tables over raw 31-bit ids and hashed strings):
  the hash keys bit-equal to JAX's after each day, more than 250 item rows
  allocated after the second, day-2 AUC above 0.9 and within 1e-4 of JAX's.
"""

import jax
import numpy as np
import pytest
from flax import nnx

import models_tpu as mm
import models_tpu.losses as jlosses
from models_tpu.core.block import iter_blocks as jiter_blocks
from models_tpu.inputs.dynamic import DynamicEmbeddingTable as JDynamic
from models_tpu.inputs.dynamic import string_id_hash as jhash

import models_tpu_torch as mt
from models_tpu_torch.core.combinators import ParallelBlock


def jax_state(model):
    return {"/".join(str(p) for p in path): np.asarray(v[...])
            for path, v in nnx.state(model, nnx.Variable).flat_state()
            if "sparse_slots" not in path}


@pytest.fixture
def jax_bce(monkeypatch):
    """The JAX binary heads train with ``softplus(x) - x y`` (the gradient at
    a zero logit, as ``tests/test_torch_ranking_models.py`` explains)."""
    def bce(labels, logits, sample_weight=None):
        labels = labels.reshape(logits.shape).astype(logits.dtype)
        return jlosses._weighted_mean(jax.nn.softplus(logits) - logits * labels, sample_weight)

    monkeypatch.setitem(jlosses.loss_registry._store, "binary_crossentropy", bce)


def close_logs(got, want, keys):
    for key in keys:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6, err_msg=key)


def test_example_11_custom_architecture(jax_bce):
    def body(pkg, blocks, parallel, dev):
        train = pkg.generate_data("e-commerce", num_rows=512)
        valid = pkg.generate_data("e-commerce", num_rows=256)
        schema = train.schema
        inputs = pkg.InputBlockV2(schema, **dev)
        interaction = parallel({"cross": blocks.CrossBlock(depth=2),
                                "deep": blocks.MLPBlock([64, 32])}, aggregation="concat")
        model = pkg.Model(inputs >> interaction >> blocks.MLPBlock([32]),
                          pkg.OutputBlock(schema), schema=schema)
        model.compile(optimizer="adam", learning_rate=1e-3)
        return model, train, valid

    jm, jtrain, jvalid = body(mm, mm.blocks, mm.core.combinators.ParallelBlock, {})
    tm, train, valid = body(mt, mt.blocks, ParallelBlock, dict(device="cpu"))
    assert tm.unbuilt_layers()
    jm.build(jtrain)
    tm.build(train, device="cpu")
    mt.load_jax_params(tm, jax_state(jm))
    jh = jm.fit(jtrain, epochs=2, batch_size=256, validation_data=jvalid, verbose=0)
    th = tm.fit(train, epochs=2, batch_size=256, validation_data=valid, verbose=0, device="cpu")
    close_logs(th.history, jh.history, ["loss", "val_loss", "loss/click/BinaryOutput"])
    close_logs(tm.evaluate(valid, batch_size=256, return_dict=True, device="cpu"),
               jm.evaluate(jvalid, batch_size=256, return_dict=True), ["loss"])


def test_example_15_pretrained_frozen_then_fine_tuned(jax_bce):
    def body(pkg, dev):
        train = pkg.generate_data("movielens-100k", num_rows=2048, seed=5)
        valid = pkg.generate_data("movielens-100k", num_rows=512, seed=6)
        schema = train.schema.excluding_by_name(["rating", "title"])
        card = int(schema["movieId"].cardinality)
        pre = (np.random.default_rng(7).normal(size=(card, 16)) / 4.0).astype(np.float32)
        inputs = pkg.InputBlockV2(schema, dim=16, table_kwargs={"movieId": {"weights": pre}},
                                  **dev)
        model = pkg.Model(inputs >> pkg.blocks.MLPBlock([64, 32]), pkg.OutputBlock(schema),
                          schema=schema)
        model.compile(optimizer="adagrad", learning_rate=0.05)
        day1, day2 = train.split([0.5, 0.5], seed=11)
        return model, inputs, day1, day2, valid, pre, card

    jm, jin, jday1, jday2, jvalid, pre, card = body(mm, {})
    tm, tin, day1, day2, valid, tpre, _ = body(mt, dict(device="cpu"))
    jm.build(jday1)
    tm.build(day1, device="cpu")
    mt.load_jax_params(tm, jax_state(jm))
    table, jtable = tin["categorical"]["movieId"], jin["categorical"]["movieId"]
    for model in (jm, tm):
        model.freeze_blocks("movieId")
    jh = jm.fit(jday1, epochs=2, batch_size=1024, verbose=0)
    th = tm.fit(day1, epochs=2, batch_size=1024, verbose=0, device="cpu")
    close_logs(th.history, jh.history, ["loss"])
    assert np.array_equal(table.to_array(), tpre)
    assert np.array_equal(np.asarray(jtable.table.value)[:card], pre)
    for model in (jm, tm):
        model.unfreeze_all_frozen_blocks()
    jh = jm.fit(jday2, epochs=2, batch_size=1024, verbose=0)
    th = tm.fit(day2, epochs=2, batch_size=1024, verbose=0, device="cpu")
    close_logs(th.history, jh.history, ["loss"])
    after = table.to_array()
    assert not np.array_equal(after, tpre)
    np.testing.assert_allclose(after, np.asarray(jtable.table.value)[:card], rtol=1e-4,
                               atol=1e-6)
    close_logs(tm.evaluate(valid, batch_size=1024, return_dict=True, device="cpu"),
               jm.evaluate(jvalid, batch_size=1024, return_dict=True),
               ["loss", "rating_binary/auc"])


def test_example_17_dynamic_vocabulary(jax_bce):
    rng = np.random.default_rng(7)

    def make_day(item_lo, item_hi, n=4096):
        raw_items = rng.integers(item_lo, item_hi, n).astype(np.int64) * 2654435761 % (2**31)
        users = np.array([f"user_{u}" for u in rng.integers(0, 500, n)])
        return raw_items, users, (raw_items % 2).astype(np.float32)

    days = [make_day(0, 200), make_day(200, 300)]

    def body(pkg, dev):
        schema = pkg.Schema([
            pkg.schema.create_categorical_column("item", 1_000_000_000,
                                                 tags=(pkg.Tags.ITEM_ID,)),
            pkg.schema.create_categorical_column("user", 1_000_000_000,
                                                 tags=(pkg.Tags.USER_ID,)),
            pkg.schema.create_categorical_column(
                "click", 1, tags=(pkg.Tags.TARGET, pkg.Tags.BINARY_CLASSIFICATION)),
        ])
        hash_fn = mt.string_id_hash if pkg is mt else jhash
        data = [pkg.Dataset({"item": items, "user": hash_fn(users).astype(np.int64),
                             "click": clicks}, schema=schema) for items, users, clicks in days]
        emb = pkg.Embeddings(schema.categorical.excluding_by_tag(pkg.Tags.TARGET), dim=16,
                             dynamic=True, dynamic_capacity={"item": 2048, "user": 1024}, **dev)
        model = pkg.Model(
            pkg.SequentialBlock([pkg.InputBlockV2(schema, categorical=emb, **dev),
                                 pkg.blocks.MLPBlock([32])]),
            pkg.BinaryOutput("click"))
        model.compile(optimizer="adam", learning_rate=0.05, metrics=["auc"])
        return model, data

    jm, jdata = body(mm, {})
    tm, data = body(mt, dict(device="cpu"))
    jm.build(jdata[0])
    tm.build(data[0], device="cpu")
    mt.load_jax_params(tm, jax_state(jm))
    jdyn = [b for b in jiter_blocks(jm) if isinstance(b, JDynamic)]
    tdyn = [b for b in tm.modules() if isinstance(b, mt.DynamicEmbeddingTable)]
    assert [t.block_name for t in tdyn] == [t.block_name for t in jdyn] == ["item", "user"]
    for day, (jd, td) in enumerate(zip(jdata, data)):
        jh = jm.fit(jd, batch_size=512, epochs=4, verbose=0)
        th = tm.fit(td, batch_size=512, epochs=4, device="cpu")
        close_logs(th.history, jh.history, ["loss"])
        for j, t in zip(jdyn, tdyn):
            assert np.array_equal(t.hash_keys.numpy(), np.asarray(j.hash_keys.value)), t.block_name
    assert tdyn[0].num_allocated > 250
    res = tm.evaluate(data[1], batch_size=512, return_dict=True, device="cpu")
    jres = jm.evaluate(jdata[1], batch_size=512, return_dict=True)
    assert res["auc"] > 0.9
    np.testing.assert_allclose(res["auc"], jres["auc"], atol=1e-4)
