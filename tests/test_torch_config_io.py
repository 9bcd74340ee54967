"""Saving and loading the port's models (``models_tpu_torch/utils/io.py``,
``core/config.py``) on the CPU.

- Each model of the zoo (the two-tower model, the DLRM, DCN-v2, the MMOE,
  the session transformer, Wide&Deep, a matrix factorization on bf16
  tables trained row-sparsely, and a model of the block DSL whose widths
  build at its build pass, ``examples/11``), trained a step where it
  trains, then saved and loaded with ``device="cpu"``: predictions bit for
  bit equal to the model's before saving, the state the same names,
  dtypes and bits (bf16 tables and row-sparse slots exact), and a config,
  not a pickle.
- A weight-tied table (the session model's item table, in its input block
  and its head) is one module after the load.
- ``.merlin/input_schema.json`` and ``output_schema.json`` are byte-equal to
  the JAX package's for the same schema.
- JAX parity: the JAX model's parameters carried into the port's
  (``load_jax_params``), both saved and loaded by their own package,
  predict within rtol 1e-5, atol 1e-6; ``summary``'s total equals JAX's.
- The pickle format, the config's replay of ``device`` (never the saved
  one), lambdas as pickled leaves, and a model whose config cannot be
  written.
"""

import os
import re

import numpy as np
import pytest
import torch
from flax import nnx

import models_tpu as mm
from models_tpu.core.combinators import ParallelBlock as JParallel

import models_tpu_torch as mt
from models_tpu_torch.core.config import ConfigError, from_config, to_config
from models_tpu_torch.core.combinators import ParallelBlock
from models_tpu_torch.transformer import GPT2Block
from models_tpu_torch.utils.io import model_state

CPU = dict(device="cpu")
BATCH = 32


def jax_state(model):
    return {"/".join(str(p) for p in path): np.asarray(v[...])
            for path, v in nnx.state(model, nnx.Variable).flat_state()
            if "sparse_slots" not in path}


def dsl_model(pkg, parallel, schema, dev):
    body = (pkg.InputBlockV2(schema, **dev)
            >> parallel({"cross": pkg.CrossBlock(depth=2), "deep": pkg.MLPBlock([16, 8])},
                        aggregation="concat")
            >> pkg.MLPBlock([8]))
    return pkg.Model(body, pkg.OutputBlock(schema), schema=schema)


def session_model(schema):
    return mt.SessionBasedTransformerModel(
        schema, transformer=GPT2Block(d_model=16, n_head=2, n_layer=1, dropout=0.0, **CPU),
        embedding_dim=16, **CPU)


# name -> (dataset, model maker, compile kwargs or None for no training)
ZOO = {
    "two_tower": ("e-commerce", lambda s: mt.TwoTowerModel(s, query_tower=(8, 4), **CPU),
                  dict(optimizer="adagrad", learning_rate=0.05, metrics=[])),
    "dlrm": ("criteo-small", lambda s: mt.DLRMModel(s, embedding_dim=8, bottom_block=(16,),
                                                    top_block=(8,), **CPU),
             dict(optimizer="adagrad", learning_rate=0.05)),
    "dcn_v2": ("e-commerce", lambda s: mt.DCNModel(s, depth=2, deep_block=(8,),
                                                   embedding_dim=8, **CPU),
               dict(optimizer="adam", learning_rate=1e-3)),
    "mmoe": ("e-commerce", lambda s: mt.MMOEModel(s, expert_block=(8,), num_experts=2,
                                                  embedding_dim=8, **CPU),
             dict(optimizer="adam", learning_rate=1e-3)),
    "session": ("sequence-testing", session_model, None),
    "wide_and_deep": ("criteo-small", lambda s: mt.WideAndDeepModel(s, embedding_dim=8,
                                                                    deep_block=(8,), **CPU),
                      dict(optimizer="adagrad", learning_rate=0.05)),
    "mf_bf16_row_sparse": ("movielens-25m",
                           lambda s: mt.MatrixFactorizationModel(s, dim=8,
                                                                 table_dtype=torch.bfloat16,
                                                                 **CPU),
                           dict(optimizer="adagrad", embedding_optimizer="adagrad",
                                metrics=[])),
    "dsl": ("e-commerce", lambda s: dsl_model(mt, ParallelBlock, s, CPU),
            dict(optimizer="adam", learning_rate=1e-3)),
}


def same_predictions(a, b):
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
    return np.array_equal(a, b)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_saved_and_loaded_models_predict_bit_for_bit(name, tmp_path):
    data, make, compile_kw = ZOO[name]
    ds = mt.generate_data(data, num_rows=96, seed=3)
    model = make(ds.schema)
    if compile_kw is not None:
        model.compile(**compile_kw)
        model.fit(ds, batch_size=BATCH, shuffle=False, **CPU)
    before = model.predict(ds, batch_size=BATCH, **CPU)
    model.save(str(tmp_path))
    assert os.path.exists(tmp_path / "config.json") and not os.path.exists(tmp_path / "model.pt")
    loaded = mt.load_model(str(tmp_path), **CPU)
    assert type(loaded) is type(model)
    assert not loaded.unbuilt_layers()
    assert same_predictions(loaded.predict(ds, batch_size=BATCH, **CPU), before)
    want, got = model_state(model), model_state(loaded)
    assert list(got) == list(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype and torch.equal(got[key], value), key
    if name == "mf_bf16_row_sparse":
        slots = [k for k in got if ".sparse_slots." in k]
        assert len(slots) == 2
        tables = [t for t in loaded.modules() if isinstance(t, mt.EmbeddingTable)]
        assert {t.table.dtype for t in tables} == {torch.bfloat16}


@pytest.mark.parametrize("dtype,method", [(torch.int8, "auto"), (torch.bfloat16, "streaming")])
def test_a_top_k_encoder_saves_its_index_and_top_k_layer(dtype, method, tmp_path):
    ds = mt.generate_data("movielens-25m", num_rows=128, seed=4)
    mf = mt.MatrixFactorizationModel(ds.schema, dim=8, **CPU)
    enc = mt.TopKEncoder(mf.query_encoder, candidates=mf.candidate_embeddings(**CPU), k=5,
                         topk_layer=mt.BruteForce(5, method=method), candidate_dtype=dtype,
                         item_id_name=mf.item_id_name, **CPU)
    before = enc.predict(ds, batch_size=BATCH, **CPU)
    enc.save(str(tmp_path))
    assert os.path.getsize(tmp_path / "config.json") < 20_000  # the index is state, not config
    loaded = mt.load_model(str(tmp_path), **CPU)
    layer = loaded.blocks[-1].topk_layer
    assert layer.method == method and layer.candidates.dtype == dtype
    assert layer.n_valid == enc.blocks[-1].topk_layer.n_valid == 56_681
    assert same_predictions(loaded.predict(ds, batch_size=BATCH, **CPU), before)


def test_a_weight_tied_table_is_one_module_after_load(tmp_path):
    ds = mt.generate_data("sequence-testing", num_rows=32, seed=1)
    model = session_model(ds.schema)
    head = model.contrastive_output.table
    assert any(m is head for m in model.blocks[0].modules())
    model.save(str(tmp_path))
    loaded = mt.load_model(str(tmp_path), **CPU)
    tables = {id(m) for m in loaded.modules() if isinstance(m, mt.EmbeddingTable)}
    assert len(tables) == len({id(m) for m in model.modules()
                               if isinstance(m, mt.EmbeddingTable)})
    assert any(m is loaded.contrastive_output.table for m in loaded.blocks[0].modules())
    with np.load(tmp_path / "state.npz") as z:  # the tied table stored once
        assert sorted(z.files) == sorted(model_state(model))
    assert len(model_state(model)) < len(model.state_dict())


@pytest.mark.parametrize("trainable", [True, False])
def test_a_pretrained_table_keeps_its_rows_in_state_only(trainable, tmp_path):
    """The pretrained rows a table was made from are its state (a parameter,
    or a buffer when frozen): its recorded arguments drop them, so the
    config carries no copy and the host keeps none; the loaded model
    predicts bit for bit and holds the rows."""
    from models_tpu_torch.core.config import init_args_of

    ds = mt.generate_data("e-commerce", num_rows=64, seed=2)
    card = ds.schema["item_id"].int_domain.max + 1
    rows = np.random.default_rng(6).standard_normal((card, 4)).astype(np.float32)
    inputs = mt.InputBlockV2(ds.schema, dim=4, table_kwargs={"item_id": {"weights": rows}},
                             trainable={"item_id": trainable}, **CPU)
    model = mt.Model(inputs >> mt.MLPBlock([4]), mt.OutputBlock(ds.schema), schema=ds.schema)
    table = next(m for m in model.modules()
                 if isinstance(m, mt.EmbeddingTable) and "item_id" in m.features)
    assert init_args_of(table)[1]["weights"] is None
    _, arrays = to_config(model)
    assert all(np.asarray(a).size < rows.size for a in arrays.values())
    before = model.predict(ds, batch_size=BATCH, **CPU)
    model.save(str(tmp_path))
    loaded = mt.load_model(str(tmp_path), **CPU)
    assert same_predictions(loaded.predict(ds, batch_size=BATCH, **CPU), before)
    got = next(m for m in loaded.modules()
               if isinstance(m, mt.EmbeddingTable) and "item_id" in m.features)
    assert isinstance(got.table, torch.nn.Parameter) == trainable
    assert np.array_equal(got.to_array(), rows)
    pre = mt.EmbeddingTable.from_pretrained(rows, trainable=trainable, **CPU)
    assert init_args_of(pre)[1]["weights"] is None and np.array_equal(pre.to_array(), rows)


@pytest.mark.parametrize("data", ["e-commerce", "criteo-small", "movielens-25m"])
def test_schema_sidecars_are_byte_equal_to_the_jax_packages(data, tmp_path):
    ts = mt.generate_data(data, num_rows=8).schema
    js = mm.generate_data(data, num_rows=8).schema
    ts.save(str(tmp_path / "t.json"))
    js.save(str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    assert mt.Schema.load(str(tmp_path / "t.json")).to_dict() == js.to_dict()
    model = mt.Model(mt.InputBlockV2(ts, dim=4, **CPU) >> mt.MLPBlock([4]),
                     mt.OutputBlock(ts), schema=ts)
    model.build(mt.generate_data(data, num_rows=8), **CPU)
    model.save(str(tmp_path / "port"))
    for side, sch in (("input_schema.json", js), ("output_schema.json", js.targets)):
        assert (tmp_path / "port" / ".merlin" / side).read_bytes() == sch.to_json().encode()


def jax_pair(name):
    """(JAX model, port model, JAX data, port data), the port's parameters
    the JAX model's."""
    if name == "dlrm":
        jds, tds = (mm.generate_data("criteo-small", num_rows=96, seed=5),
                    mt.generate_data("criteo-small", num_rows=96, seed=5))
        jm = mm.DLRMModel(jds.schema, embedding_dim=8, bottom_block=(16,), top_block=(8,))
        tm = mt.DLRMModel(tds.schema, embedding_dim=8, bottom_block=(16,), top_block=(8,), **CPU)
    elif name == "dcn_v2":
        jds, tds = (mm.generate_data("e-commerce", num_rows=96, seed=5),
                    mt.generate_data("e-commerce", num_rows=96, seed=5))
        jm = mm.DCNModel(jds.schema, depth=2, deep_block=(8,), embedding_dim=8)
        tm = mt.DCNModel(tds.schema, depth=2, deep_block=(8,), embedding_dim=8, **CPU)
    elif name == "mmoe":
        jds, tds = (mm.generate_data("e-commerce", num_rows=96, seed=5),
                    mt.generate_data("e-commerce", num_rows=96, seed=5))
        jm = mm.MMOEModel(jds.schema, expert_block=(8,), num_experts=2, embedding_dim=8)
        tm = mt.MMOEModel(tds.schema, expert_block=(8,), num_experts=2, embedding_dim=8, **CPU)
    else:  # the block DSL of examples/11
        jds, tds = (mm.generate_data("e-commerce", num_rows=96, seed=5),
                    mt.generate_data("e-commerce", num_rows=96, seed=5))
        jm = dsl_model(mm, JParallel, jds.schema, {})
        tm = dsl_model(mt, ParallelBlock, tds.schema, CPU)
    jm.build(mm.Loader(jds, BATCH))
    tm.build(tds, **CPU)
    mt.load_jax_params(tm, jax_state(jm))
    return jm, tm, jds, tds


def close(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    else:
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


def total_params(text: str) -> int:
    return int(re.search(r"Total params: ([\d,]+)", text).group(1).replace(",", ""))


@pytest.mark.parametrize("name", ["dlrm", "dcn_v2", "mmoe", "dsl"])
def test_saved_and_loaded_models_predict_as_the_jax_packages(name, tmp_path):
    jm, tm, jds, tds = jax_pair(name)
    assert total_params(tm.summary(print_fn=None)) == total_params(jm.summary(print_fn=None))
    jm.save(str(tmp_path / "jax"))
    tm.save(str(tmp_path / "port"))
    jl = mm.load_model(str(tmp_path / "jax"))
    tl = mt.load_model(str(tmp_path / "port"), **CPU)
    close(tl.predict(tds, batch_size=BATCH, **CPU), jl.predict(jds, batch_size=BATCH))
    for side in os.listdir(tmp_path / "jax" / ".merlin"):
        assert ((tmp_path / "port" / ".merlin" / side).read_bytes()
                == (tmp_path / "jax" / ".merlin" / side).read_bytes())


def test_the_pickle_format_sets_the_engine_aside(tmp_path):
    ds = mt.generate_data("e-commerce", num_rows=64, seed=2)
    model = mt.DLRMModel(ds.schema, embedding_dim=8, bottom_block=(8,), top_block=(8,), **CPU)
    model.compile(optimizer="adagrad", learning_rate=0.05)
    model.fit(ds, batch_size=BATCH, **CPU)
    before = model.predict(ds, batch_size=BATCH, **CPU)
    model.save(str(tmp_path), format="pickle")
    assert sorted(os.listdir(tmp_path)) == [".merlin", "model.pt"]
    assert model._optimizer is not None and model._compiled  # put back
    loaded = mt.load_model(str(tmp_path), **CPU)
    assert not loaded._compiled and getattr(loaded, "_optimizer", None) is None
    assert same_predictions(loaded.predict(ds, batch_size=BATCH, **CPU), before)
    model.save(str(tmp_path))  # the config format takes the directory's place
    assert sorted(os.listdir(tmp_path)) == [".merlin", "config.json", "state.npz"]


def double(x):
    return x * 2.0


def test_the_config_replays_its_own_device_and_pickles_functions():
    ds = mt.generate_data("e-commerce", num_rows=16, seed=2)
    body = mt.InputBlockV2(ds.schema, dim=4, **CPU) >> mt.MLPBlock([4]) >> mt.Lambda(double)
    model = mt.Model(body, mt.OutputBlock(ds.schema), schema=ds.schema)
    tree, arrays = to_config(model)
    text = repr(tree)
    assert "'device': 'cpu'" in text  # recorded as given, replaced at the replay
    assert "__pickle__" in text
    replayed = from_config(tree, arrays, device="cpu")
    assert {p.device.type for p in replayed.parameters()} == {"cpu"}
    x, _ = next(iter(mt.Loader(ds, 16)))
    xb = mt.core.types.to_device_batch(x, "cpu")
    replayed.build(ds, **CPU)
    model.build(ds, **CPU)
    replayed.load_state_dict(model.state_dict())
    assert torch.equal(replayed(xb).outputs if hasattr(replayed(xb), "outputs") else
                       replayed(xb)["click/BinaryOutput"].outputs,
                       model(xb).outputs if hasattr(model(xb), "outputs") else
                       model(xb)["click/BinaryOutput"].outputs)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            from_config(tree, arrays, device="cuda")


def test_a_model_the_config_cannot_express_saves_as_a_pickle(tmp_path):
    ds = mt.generate_data("e-commerce", num_rows=32, seed=2)
    # a plain nn.Module passed to a constructor has no recorded arguments
    model = mt.Model(mt.InputBlockV2(ds.schema, dim=4, **CPU) >> mt.MLPBlock([4], **CPU),
                     torch.nn.Identity(), mt.OutputBlock(ds.schema, in_features=4, **CPU),
                     schema=ds.schema)
    before = model.predict(ds, batch_size=BATCH, **CPU)
    with pytest.raises(ConfigError, match="Identity"):
        model.save(str(tmp_path), format="config")
    assert not os.path.exists(tmp_path / "config.json")
    with pytest.warns(UserWarning, match="pickled module"):
        model.save(str(tmp_path))
    assert os.path.exists(tmp_path / "model.pt")
    loaded = mt.load_model(str(tmp_path), **CPU)
    assert same_predictions(loaded.predict(ds, batch_size=BATCH, **CPU), before)
