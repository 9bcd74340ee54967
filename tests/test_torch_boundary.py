"""The port's boundaries: it imports nothing of JAX or of the JAX package, and
its entry points refuse to run on the CPU unless asked to."""

import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import models_tpu_torch as mt
from models_tpu_torch.ops import topk as ttopk
from models_tpu_torch.utils.checkpoint import CheckpointManager

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pyarrow", "pandas", "models_tpu")


def test_import_loads_no_jax_and_nothing_of_the_jax_package():
    code = (
        "import sys, models_tpu_torch, models_tpu_torch.ops.topk\n"
        "import models_tpu_torch.ops.embedding_lookup, models_tpu_torch.metrics\n"
        "import models_tpu_torch.models.ranking, models_tpu_torch.models.benchmark\n"
        "import models_tpu_torch.blocks.dlrm, models_tpu_torch.blocks.cross\n"
        "import models_tpu_torch.blocks.interaction, models_tpu_torch.outputs.base\n"
        "import models_tpu_torch.inputs.continuous, models_tpu_torch.losses\n"
        "import models_tpu_torch.transformer, models_tpu_torch.transforms.sequence\n"
        "import models_tpu_torch.models.session, models_tpu_torch.outputs.sampling\n"
        "import models_tpu_torch.outputs.queue, models_tpu_torch.outputs.contrastive\n"
        "import models_tpu_torch.models.retrieval, models_tpu_torch.blocks.retrieval\n"
        "import models_tpu_torch.transforms.bias, models_tpu_torch.transforms.regularization\n"
        "import models_tpu_torch.metrics.evaluation, models_tpu_torch.core.encoder\n"
        "import models_tpu_torch.outputs.topk\n"
        "import models_tpu_torch.blocks.experts, models_tpu_torch.models.multi_task\n"
        "import models_tpu_torch.outputs.tasks, models_tpu_torch.transforms.negative_sampling\n"
        "import models_tpu_torch.utils.callbacks\n"
        "import models_tpu_torch.core.block, models_tpu_torch.core.combinators\n"
        "import models_tpu_torch.core.aggregation, models_tpu_torch.registry\n"
        "import models_tpu_torch.inputs.embedding, models_tpu_torch.inputs.base\n"
        "import models_tpu_torch.inputs.dynamic, models_tpu_torch.inputs.tt_embedding\n"
        "import models_tpu_torch.transforms.features, models_tpu_torch.transforms.noise\n"
        "import models_tpu_torch.data.dataset, models_tpu_torch.schema\n"
        "import models_tpu_torch.core.config, models_tpu_torch.utils.io\n"
        "import models_tpu_torch.utils.checkpoint, models_tpu_torch.utils.misc\n"
        "import models_tpu_torch.parallel, models_tpu_torch.parallel.launch\n"
        "import models_tpu_torch.parallel.collectives, models_tpu_torch.parallel.mesh\n"
        "import models_tpu_torch.parallel.distributed\n"
        "import models_tpu_torch.data.workflow, models_tpu_torch.data.datasets\n"
        "import models_tpu_torch.data.parquet, models_tpu_torch.data.native\n"
        "import models_tpu_torch.data.loader\n"
        "models_tpu_torch.string_id_hash(['a', b'b', None])\n"
        "print('\\n'.join(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=120).stdout.split()
    assert "models_tpu_torch" in out
    # "models_tpu_torch" shares the prefix "models_tpu": compare whole top-level names
    loaded = {name.split(".")[0] for name in out}
    assert not loaded & set(FORBIDDEN), sorted(loaded & set(FORBIDDEN))


def test_importing_the_kernels_builds_nothing_and_loads_no_triton():
    code = (
        "import subprocess, sys\n"
        "started = []\n"
        "popen = subprocess.Popen.__init__\n"
        "def spy(self, *a, **k):\n"
        "    started.append(a)\n"
        "    popen(self, *a, **k)\n"
        "subprocess.Popen.__init__ = spy\n"
        "import models_tpu_torch.ops.flash_ce, models_tpu_torch.ops.contrastive\n"
        "import models_tpu_torch.ops.embedding_lookup, models_tpu_torch.ops.topk\n"
        "import torch\n"
        "from models_tpu_torch.ops import kernels\n"
        "ops = torch.ops.models_tpu_torch\n"
        "assert ops.binned_rescore.default and ops.streaming_topk.default\n"
        "print(len(started), len(kernels._libs))\n"
        "print('\\n'.join(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=120).stdout.split("\n")
    assert out[0] == "0 0"  # no process started (no nvcc), no library loaded
    loaded = {name.split(".")[0] for name in out[1:]}
    assert "models_tpu_torch" in loaded
    assert not loaded & (set(FORBIDDEN) | {"triton"}), sorted(loaded & set(FORBIDDEN))


@pytest.mark.parametrize("script", ["chip_smoke", "ab_kernels"])
def test_the_card_scripts_load_no_jax_and_nothing_of_the_jax_package(script):
    """The scripts that run the port on the card, imported as modules (their
    work runs only under ``__main__``), and the port's modules their phases
    import, load nothing of JAX."""
    code = (
        f"import sys, {script}\n"
        "import models_tpu_torch.ops.scatter, models_tpu_torch.ops.topk\n"
        "import models_tpu_torch.outputs.topk, models_tpu_torch.core.types\n"
        "print('\\n'.join(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=120).stdout.split()
    loaded = {name.split(".")[0] for name in out}
    assert script in loaded and "torch" in loaded
    assert not loaded & set(FORBIDDEN), sorted(loaded & set(FORBIDDEN))


@pytest.mark.parametrize("module", ["torch_mesh_workers", "torch_mesh_breadth_workers"])
def test_the_mesh_tests_rank_workers_load_no_jax(module):
    """The rank workers of the mesh tests run the port alone: importing one,
    and running the data plane it reads (the synthesized getter), loads
    nothing of JAX, pandas or pyarrow."""
    code = (
        f"import sys, {module}\n"
        "import models_tpu_torch as mt\n"
        "train, valid = mt.data.datasets.get_movielens(variant='ml-25m', num_rows=40)\n"
        "assert isinstance(train, mt.Dataset) and train.num_rows == 32\n"
        "print('\\n'.join(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT / "tests", capture_output=True,
                         text=True, check=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)}).stdout.split()
    loaded = {name.split(".")[0] for name in out}
    assert module in loaded and "models_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN), sorted(loaded & set(FORBIDDEN))


def test_the_data_plane_from_files_loads_no_jax_pandas_or_pyarrow(tmp_path):
    """Writing and reading parquet, a Loader streaming files, a raw getter
    (Tenrec's csv) and ``sample_batch(device="cpu")``, in a process of their
    own, load no module of FORBIDDEN."""
    code = (
        "import sys\n"
        "import models_tpu_torch as mt\n"
        f"root = {str(tmp_path)!r}\n"
        "ds = mt.generate_data('sequence-testing', num_rows=300, seed=0)\n"
        "path = ds.to_parquet(root + '/p', row_group_size=70, num_partitions=2)\n"
        "back = mt.Dataset(path)\n"
        "assert back.num_rows == 300 and back.to_numpy_dict().keys() == ds.to_numpy_dict().keys()\n"
        "batches = list(mt.Loader(path, 32, shuffle=True, prefetch=2))\n"
        "assert len(batches) == 9\n"
        "feats, targets = mt.sample_batch(path, batch_size=8, device='cpu')\n"
        "open(root + '/QK-video.csv', 'w').write('user_id,item_id,click\\n1,2,0\\n3,4,1\\n')\n"
        "train, valid = mt.data.datasets.get_tenrec(root)\n"
        "assert train.num_rows + valid.num_rows == 2\n"
        "print('\\n'.join(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=300).stdout.split()
    loaded = {name.split(".")[0] for name in out}
    assert "models_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN), sorted(loaded & set(FORBIDDEN))


def _model():
    ds = mt.generate_data("e-commerce", num_rows=40, seed=0)
    return ds, mt.TwoTowerModel(ds.schema, query_tower=(8, 4), device="cpu")


def _encoder():
    ds, m = _model()
    return ds, m.to_top_k_encoder(ds, k=3, batch_size=16, device="cpu")


def _cpu_model():
    ds = mt.generate_data("e-commerce", num_rows=40, seed=0)
    return ds, mt.TwoTowerModel(ds.schema, query_tower=(8, 4), device="cpu")


def _saved() -> str:
    path = tempfile.mkdtemp()
    _cpu_model()[1].save(path)
    return path


def _exported() -> str:
    ds, m = _cpu_model()
    path = tempfile.mkdtemp()
    m.to_top_k_encoder(ds, k=3, batch_size=16, device="cpu").export_serving(
        path, data=ds, batch_size=16, device="cpu")
    return path


def _restore_training():
    ds, m = _cpu_model()
    m.compile(optimizer="adagrad", metrics=[])
    path = tempfile.mkdtemp()
    CheckpointManager(path).save(0, m, opt_state={}, global_step=0)
    return CheckpointManager(path).restore_training(m, data=ds)


Q, C = np.ones((2, 4), np.float32), np.ones((100, 4), np.float32)
ENTRY_POINTS = {
    "TwoTowerModel": lambda: mt.TwoTowerModel(_model()[0].schema, query_tower=(8, 4)),
    "DLRMModel": lambda: mt.DLRMModel(mt.generate_data("criteo-small", num_rows=8).schema,
                                      embedding_dim=8),
    "NCFModel": lambda: mt.NCFModel(_model()[0].schema, embedding_dim=8),
    "SessionBasedTransformerModel": lambda: mt.SessionBasedTransformerModel(
        mt.generate_data("sequence-testing", num_rows=8).schema, embedding_dim=8),
    "MatrixFactorizationModel": lambda: mt.MatrixFactorizationModel(
        mt.generate_data("e-commerce", num_rows=8).schema, dim=8),
    "YoutubeDNNRetrievalModel": lambda: mt.YoutubeDNNRetrievalModel(
        mt.generate_data("e-commerce", num_rows=8).schema, num_sampled=4),
    "MatrixFactorizationBlock": lambda: mt.blocks.MatrixFactorizationBlock(
        mt.generate_data("e-commerce", num_rows=8).schema, dim=8),
    "TwoTowerBlock": lambda: mt.blocks.TwoTowerBlock(
        mt.generate_data("e-commerce", num_rows=8).schema, (8, 4)),
    "MMOEModel": lambda: mt.MMOEModel(_model()[0].schema, embedding_dim=8),
    "PLEModel": lambda: mt.PLEModel(_model()[0].schema, embedding_dim=8),
    "PredictionTasks": lambda: mt.PredictionTasks(_model()[0].schema, in_features=8),
    "NextItemPredictionTask": lambda: mt.NextItemPredictionTask(
        _model()[0].schema, weight_tying=False, in_features=8),
    "WideAndDeepModel": lambda: mt.WideAndDeepModel(
        mt.generate_data("criteo-small", num_rows=8).schema, enable_wide_crosses=False),
    "DynamicEmbeddingTable": lambda: mt.DynamicEmbeddingTable(
        8, mt.create_categorical_column("item", 99)),
    "TTEmbeddingTable": lambda: mt.TTEmbeddingTable(8, mt.create_categorical_column("item", 999)),
    "EmbeddingTable": lambda: mt.EmbeddingTable(8, mt.create_categorical_column("item", 99)),
    "EmbeddingTable.from_pretrained": lambda: mt.EmbeddingTable.from_pretrained(
        np.ones((10, 4), np.float32)),
    "Embeddings": lambda: mt.Embeddings(_model()[0].schema, dim=4),
    "Embeddings(dynamic=)": lambda: mt.Embeddings(_model()[0].schema, dim=4,
                                                  dynamic={"item_id": True}),
    "EmbeddingFeatures": lambda: mt.EmbeddingFeatures(_model()[0].schema, dim=4),
    "SequenceEmbeddingFeatures": lambda: mt.SequenceEmbeddingFeatures(
        mt.generate_data("sequence-testing", num_rows=8).schema, dim=4),
    "InputBlockV2": lambda: mt.InputBlockV2(_model()[0].schema, dim=4),
    "InputBlock": lambda: mt.InputBlock(_model()[0].schema, embedding_dim_default=4),
    "Model.build": lambda: mt.Model(
        mt.InputBlockV2(_model()[0].schema, dim=4, device="cpu") >> mt.MLPBlock([4]),
        mt.OutputBlock(_model()[0].schema)).build(_model()[0]),
    "to_top_k_encoder": lambda: _model()[1].to_top_k_encoder(_model()[0], k=3),
    "candidate_embeddings": lambda: _model()[1].candidate_embeddings(_model()[0]),
    "predict": lambda: _encoder()[1].predict(_encoder()[0], batch_size=16),
    "fit": lambda: _model()[1].compile(optimizer="adagrad", metrics=[]).fit(
        _model()[0], batch_size=16),
    "BruteForce.index": lambda: mt.BruteForce(k=3).index(C),
    "topk_scores": lambda: ttopk.topk_scores(Q, C, 3),
    "binned_topk": lambda: ttopk.binned_topk(Q, C, 3),
    "blockwise_topk": lambda: ttopk.blockwise_topk(Q, C, 3),
    "load_model": lambda: mt.load_model(_saved()),
    "BaseModel.load": lambda: mt.BaseModel.load(_saved()),
    "load_serving": lambda: mt.load_serving(_exported()),
    "CheckpointManager.restore_training": _restore_training,
    "export_serving": lambda: _cpu_model()[1].export_serving(
        tempfile.mkdtemp(), data=_cpu_model()[0], batch_size=16),
    "parallel.initialize": lambda: mt.parallel.initialize(
        init_method="file://" + tempfile.mktemp(), world_size=1, rank=0),
    "make_mesh": lambda: mt.make_mesh({"data": 1, "model": 1}),
    "sample_batch": lambda: mt.sample_batch(_model()[0], batch_size=8),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_without_device_raise_on_a_host_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()


def test_the_same_entry_points_run_when_asked_for_the_cpu():
    ds, enc = _encoder()
    out = enc.predict(ds, batch_size=16, device="cpu")
    assert out["ids"].shape == (40, 3)
    s, i = ttopk.topk_scores(Q, C, 3, device="cpu")
    assert s.shape == (2, 3) and i.dtype == torch.int32


def test_the_mesh_runs_on_the_cpu_only_over_gloo():
    """On the CPU ``initialize`` needs ``backend="gloo"`` beside
    ``device="cpu"`` (NCCL runs on the card only), and refuses before it
    joins anything; ``make_mesh(device="cpu")`` with no process group is a
    mesh of one rank."""
    init = "file://" + tempfile.mktemp()
    with pytest.raises(ValueError, match="gloo"):
        mt.parallel.initialize(init_method=init, world_size=1, rank=0, device="cpu")
    with pytest.raises(ValueError, match="nccl"):
        mt.parallel.initialize(init_method=init, world_size=1, rank=0, device="cpu",
                               backend="nccl")
    assert not torch.distributed.is_initialized()
    mesh = mt.make_mesh({"data": 1, "model": 1}, device="cpu")
    assert (mesh.world, mesh.coords, mesh.group("model").size) == (1, (0, 0), 1)
