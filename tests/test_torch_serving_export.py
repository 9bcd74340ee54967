"""Serving export (``models_tpu_torch/utils/io.py::export_serving``) on the
CPU, against the JAX package's ``export_serving`` / ``load_serving``.

The artifacts: the DLRM of ``examples/08`` (on criteo-small), the
matrix factorization's top-k encoder over its tied table (56,681 rows) with
bf16 and int8 indexes (``examples/08``), and a two-tower top-k encoder over
a catalog of 5,729 encoded items, once by the automatic route (binned: the
K5 op in the program) and once with the streaming route forced (the K6
op). Both packages draw the same rows from one seed; the JAX model's
parameters are carried over with ``load_jax_params``.

A fresh Python process loads every artifact with ``load_serving`` and serves
the first batch: it constructs no block (the config module records no
constructor call) and reports the ``models_tpu_torch::`` operators of each
program. Its outputs equal the port's ``predict`` on the same rows bit for
bit, and the JAX artifact's: probabilities within rtol 1e-5, atol 1e-6;
top-k scores within 1e-5, ids equal outside near-ties of 1e-5, and the
int8 index's ids equal (its scoring is exact int32 in both packages).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import models_tpu as mm
from models_tpu.core.types import to_device_batch as jax_batch

import models_tpu_torch as mt
from models_tpu_torch.core.types import flatten_features
from models_tpu_torch.ops.topk import ids_agree

ROOT = Path(__file__).resolve().parents[1]
CPU = dict(device="cpu")


def jax_params(model):
    return {"/".join(str(p) for p in path): np.asarray(var[...])
            for path, var in nnx.state(model, nnx.Variable).flat_state()
            if "sparse_slots" not in path}


def first_batch(pkg, ds, batch):
    x, _ = pkg.Loader(ds, batch, shuffle=False, drop_last=True).peek() if pkg is mm else \
        next(iter(mt.Loader(ds, batch)))
    return {k: v for k, v in x.items() if k != "__row_valid__"}


def host(out):
    if isinstance(out, dict):
        return {k: np.asarray(v) for k, v in out.items()}
    return np.asarray(out)


def cases(root: Path):
    """name -> (artifact dir, port predict on the first batch, JAX serving
    output on it, flat features)."""
    out = {}

    # examples/08's DLRM, on criteo-small (continuous columns for its bottom MLP)
    jds = mm.generate_data("criteo-small", num_rows=256, seed=8)
    tds = mt.generate_data("criteo-small", num_rows=256, seed=8)
    jm = mm.DLRMModel(jds.schema, embedding_dim=16, bottom_block=(32, 16), top_block=(32,))
    tm = mt.DLRMModel(tds.schema, embedding_dim=16, bottom_block=(32, 16), top_block=(32,), **CPU)
    jm.build(mm.Loader(jds, 64))
    mt.load_jax_params(tm, jax_params(jm))
    jm.compile()
    out["dlrm"] = export_pair(root / "dlrm", jm, tm, jds, tds, 64)

    # examples/08: the matrix factorization, bf16 and int8 indexes
    jds = mm.generate_data("movielens-25m", num_rows=256, seed=3)
    tds = mt.generate_data("movielens-25m", num_rows=256, seed=3)
    jm = mm.MatrixFactorizationModel(jds.schema, dim=16)
    tm = mt.MatrixFactorizationModel(tds.schema, dim=16, **CPU)
    jm.build(mm.Loader(jds, 64))
    mt.load_jax_params(tm, jax_params(jm))
    for tag, jdt, tdt in (("mf_bf16", jnp.bfloat16, torch.bfloat16),
                          ("mf_int8", jnp.int8, torch.int8)):
        jenc = jm.to_top_k_encoder(k=10, candidate_dtype=jdt)
        jenc.compile()
        tenc = tm.to_top_k_encoder(k=10, candidate_dtype=tdt, **CPU)
        out[tag] = export_pair(root / tag, jenc, tenc, jds, tds, 128)

    # a two-tower encoder over more than 4096 items: binned, and streaming forced
    jds = mm.generate_data("movielens-25m", num_rows=8000, seed=11)
    tds = mt.generate_data("movielens-25m", num_rows=8000, seed=11)
    jm = mm.TwoTowerModel(jds.schema, query_tower=(16, 8), embedding_dim=8)
    tm = mt.TwoTowerModel(tds.schema, query_tower=(16, 8), embedding_dim=8, **CPU)
    jm.build(mm.Loader(jds, 64))
    mt.load_jax_params(tm, jax_params(jm))
    jenc = jm.to_top_k_encoder(jds, k=10)
    jenc.compile()
    tenc = tm.to_top_k_encoder(tds, k=10, **CPU)
    assert tenc.blocks[-1].topk_layer.n_valid > 4096
    out["two_tower_binned"] = export_pair(root / "two_tower_binned", jenc, tenc, jds, tds, 128)
    streaming = mt.TopKEncoder(tm.query_encoder, candidates=tm.candidate_embeddings(tds, **CPU),
                               k=10, topk_layer=mt.BruteForce(10, method="streaming"),
                               item_id_name=tm.item_id_name, **CPU)
    out["two_tower_streaming"] = (str(root / "two_tower_streaming"),) + export_pair(
        root / "two_tower_streaming", None, streaming, jds, tds, 128)[1:2] + (
        out["two_tower_binned"][2], out["two_tower_binned"][3])
    return out


def export_pair(path: Path, jm, tm, jds, tds, batch):
    x = first_batch(mt, tds, batch)
    tm.export_serving(str(path), data=tds, batch_size=batch, **CPU)
    want = host(tm.predict(tds.take(batch), batch_size=batch, **CPU))
    jout = None
    if jm is not None:
        jm.export_serving(str(path / "jax"), data=jds, batch_size=batch)
        jout = host(mm.load_serving(str(path / "jax"))(jax_batch(first_batch(mm, jds, batch))))
    flat = {k: np.asarray(v) for k, v in flatten_features(x).items()}
    np.savez(path / "request.npz", **flat)
    return str(path), want, jout, flat


SERVE = """
import json, sys
import numpy as np
import models_tpu_torch as mt
from models_tpu_torch.core import config
out = {}
for path in sys.argv[1:]:
    model = mt.load_serving(path, device="cpu")
    with np.load(path + "/request.npz") as z:
        got = model({k: z[k] for k in z.files})
    got = got if isinstance(got, dict) else {"": got}
    np.savez(path + "/served.npz", **{k: v.numpy() for k, v in got.items()})
    ops = sorted({str(n.target) for n in model.program.graph.nodes
                  if n.op == "call_function" and "models_tpu_torch" in str(n.target)})
    out[path] = ops
print(json.dumps({"ops": out, "constructed": len(config._INIT_ARGS)}))
"""


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    arts = cases(tmp_path_factory.mktemp("serving"))
    res = subprocess.run([sys.executable, "-c", SERVE] + [a[0] for a in arts.values()],
                         cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert res.returncode == 0, res.stderr[-3000:]
    report = json.loads(res.stdout.strip().splitlines()[-1])
    got = {}
    for name, (path, _, _, _) in arts.items():
        with np.load(Path(path) / "served.npz") as z:
            got[name] = {k: z[k] for k in z.files}
    return arts, got, report


def test_a_fresh_process_serves_every_artifact_without_building_a_model(served):
    arts, got, report = served
    assert report["constructed"] == 0
    assert set(report["ops"]) == {a[0] for a in arts.values()}
    for name, (path, *_rest) in arts.items():
        assert (Path(path) / "serving_cpu.pt2").exists()
        spec = json.loads((Path(path) / "serving_spec.json").read_text())
        assert spec["platforms"] == ["cpu"] and set(spec) >= {"features", "batch_size"}
        assert (Path(path) / ".merlin" / "input_schema.json").exists()


@pytest.mark.parametrize("name,ops", [
    ("dlrm", []), ("mf_bf16", ["models_tpu_torch.binned_rescore.default"]),
    ("mf_int8", ["models_tpu_torch.binned_rescore.default"]),
    ("two_tower_binned", ["models_tpu_torch.binned_rescore.default"]),
    ("two_tower_streaming", ["models_tpu_torch.streaming_topk.default"])])
def test_the_top_k_programs_hold_the_kernels_as_operators(served, name, ops):
    arts, _, report = served
    assert report["ops"][arts[name][0]] == ops


@pytest.mark.parametrize("name", ["dlrm", "mf_bf16", "mf_int8", "two_tower_binned",
                                  "two_tower_streaming"])
def test_served_outputs_equal_predict_and_the_jax_artifact(served, name):
    arts, got, _ = served
    _, want, jout, flat = arts[name]
    out = got[name]
    if name == "dlrm":
        assert np.array_equal(out[""], want)
        np.testing.assert_allclose(out[""], jout, rtol=1e-5, atol=1e-6)
        assert spec_features(arts[name][0]) == {k: list(v.shape) for k, v in flat.items()}
        return
    assert np.array_equal(out["scores"], want["scores"])
    assert np.array_equal(out["ids"], want["ids"])
    np.testing.assert_allclose(out["scores"], jout["scores"], rtol=0, atol=1e-5)
    if name == "mf_int8":
        assert np.array_equal(out["ids"], jout["ids"])
    else:
        assert ids_agree(out["scores"], out["ids"], jout["scores"], jout["ids"], 1e-5)


def spec_features(path):
    spec = json.loads((Path(path) / "serving_spec.json").read_text())
    return {k: v["shape"] for k, v in spec["features"].items()}


def test_list_features_flatten_to_values_and_mask(served):
    arts, _, _ = served
    feats = spec_features(arts["two_tower_binned"][0])
    assert "genres__values" in feats and "genres__mask" in feats and "genres" not in feats


def test_the_serving_model_takes_sequence_features_and_checks_the_request(served):
    arts, got, _ = served
    path, _, _, flat = arts["two_tower_binned"]
    model = mt.load_serving(path, **CPU)
    x = mt.core.types.unflatten_features({k: torch.as_tensor(v) for k, v in flat.items()})
    assert isinstance(x["genres"], mt.SequenceFeature)
    out = model(x)
    assert np.array_equal(out["ids"].numpy(), got["two_tower_binned"]["ids"])
    with pytest.raises(KeyError, match="missing"):
        model({k: v for k, v in flat.items() if k != "userId"})
    with pytest.raises(ValueError, match="the program takes"):  # a batch of another size
        model({k: v[:64] for k, v in flat.items()})
    with pytest.raises(ValueError, match="the program takes"):
        model({**flat, "userId": flat["userId"].astype(np.int64)})


def test_a_dynamic_vocabulary_table_exports_its_serving_lookup(tmp_path):
    """Serving lookups claim no slot (``training=False``): the program holds
    the table's keys and maps ids as ``predict`` does."""
    ds = mt.generate_data("e-commerce", num_rows=96, seed=2)
    inputs = mt.InputBlockV2(ds.schema, dim=4, dynamic={"item_id": True}, **CPU)
    model = mt.Model(inputs >> mt.MLPBlock([4]), mt.OutputBlock(ds.schema), schema=ds.schema)
    model.compile(optimizer="adagrad", learning_rate=0.05)
    model.fit(ds, batch_size=32, **CPU)
    keys = [m.hash_keys.clone() for m in model.modules() if hasattr(m, "hash_keys")]
    assert keys
    model.export_serving(str(tmp_path), data=ds, batch_size=32, **CPU)
    x = first_batch(mt, ds, 32)
    out = mt.load_serving(str(tmp_path), **CPU)(x)
    want = model.predict(ds.take(32), batch_size=32, **CPU)
    for head, value in want.items():
        assert np.array_equal(out[head].numpy(), value), head
    assert all(torch.equal(k, m.hash_keys) for k, m in
               zip(keys, [m for m in model.modules() if hasattr(m, "hash_keys")]))


class _CapturedGraph:
    """Stands for a captured ``torch.cuda.CUDAGraph``, which neither a deep
    copy nor a pickle takes."""

    def __deepcopy__(self, memo):
        raise TypeError("a captured graph cannot be copied")

    def __reduce__(self):
        raise TypeError("a captured graph cannot be pickled")


def test_a_trained_model_exports_and_its_cpu_copy_leaves_the_engine(tmp_path):
    """After a fit with default platforms, with a captured graph in the
    engine: the export serves ``predict``'s outputs, and the copy the CPU
    program is traced on (``cpu_copy``) holds the weights, on the host and
    apart from the model's, but no optimizer, slot or graph; the model keeps
    its engine."""
    from models_tpu_torch.utils.io import ENGINE_ATTRS, cpu_copy

    ds = mt.generate_data("criteo-small", num_rows=128, seed=5)
    model = mt.DLRMModel(ds.schema, embedding_dim=8, bottom_block=(16, 8), top_block=(8,), **CPU)
    model.compile(optimizer="adam", learning_rate=1e-3, steps_per_execution=2)
    model.fit(ds, batch_size=32, shuffle=False, **CPU)
    graph = _CapturedGraph()
    model._group_graphs[0] = graph
    opt = model._optimizer
    model.export_serving(str(tmp_path), data=ds, batch_size=32, **CPU)
    out = mt.load_serving(str(tmp_path), **CPU)(first_batch(mt, ds, 32))
    assert np.array_equal(out.numpy(), model.predict(ds.take(32), batch_size=32, **CPU))

    copied = cpu_copy(model)
    assert not set(ENGINE_ATTRS) & set(copied.__dict__) and not copied._compiled
    assert model._group_graphs[0] is graph and model._optimizer is opt and model._compiled
    want, got = dict(model.named_parameters()), dict(copied.named_parameters())
    assert sorted(got) == sorted(want)
    for name, p in got.items():
        assert p.device.type == "cpu" and p.requires_grad == want[name].requires_grad
        assert torch.equal(p, want[name]) and p.data_ptr() != want[name].data_ptr(), name
    assert np.array_equal(copied.predict(ds, batch_size=32, **CPU),
                          model.predict(ds, batch_size=32, **CPU))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_the_kernel_wrappers_and_their_operators_agree(dtype):
    """An eager call of K5's and K6's wrappers takes their bodies directly;
    a traced one, the operator: both give the same bits."""
    from models_tpu_torch.ops import topk as T

    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((24, 16)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((256, 16)).astype(np.float32))
    ids = torch.arange(256, dtype=torch.int32)
    scale = None
    if dtype == torch.int8:
        c, scale = torch.clamp(c * 40, -127, 127).round().to(torch.int8), torch.full((256,), 0.02)
    else:
        c = c.to(dtype)
    qr = T.quantize_queries(q)[0] if dtype == torch.int8 else q
    idx = torch.from_numpy(rng.integers(0, 4, (24, 2)).astype(np.int32))
    ops = torch.ops.models_tpu_torch
    assert torch.equal(T.binned_rescore(qr, c, idx, 64), ops.binned_rescore(qr, c, idx, 64))
    got = T.streaming_topk(q, c, 7, ids=ids, n_valid=250, scale=scale)
    want = ops.streaming_topk(q, c, 7, ids, 250, scale)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
