"""The port's boundaries: it imports nothing of JAX or of the JAX package, and
its entry points refuse to run on the CPU unless asked to."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import models_tpu_torch as mt
from models_tpu_torch.ops import topk as ttopk

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pyarrow", "models_tpu")


def test_import_loads_no_jax_and_nothing_of_the_jax_package():
    code = (
        "import sys, models_tpu_torch, models_tpu_torch.ops.topk\n"
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
        "from models_tpu_torch.ops import kernels\n"
        "print(len(started), len(kernels._libs))\n"
        "print('\\n'.join(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=120).stdout.split("\n")
    assert out[0] == "0 0"  # no process started (no nvcc), no library loaded
    loaded = {name.split(".")[0] for name in out[1:]}
    assert "models_tpu_torch" in loaded
    assert not loaded & (set(FORBIDDEN) | {"triton"}), sorted(loaded & set(FORBIDDEN))


def _model():
    ds = mt.generate_data("e-commerce", num_rows=40, seed=0)
    return ds, mt.TwoTowerModel(ds.schema, query_tower=(8, 4), device="cpu")


def _encoder():
    ds, m = _model()
    return ds, m.to_top_k_encoder(ds, k=3, batch_size=16, device="cpu")


Q, C = np.ones((2, 4), np.float32), np.ones((100, 4), np.float32)
ENTRY_POINTS = {
    "TwoTowerModel": lambda: mt.TwoTowerModel(_model()[0].schema, query_tower=(8, 4)),
    "to_top_k_encoder": lambda: _model()[1].to_top_k_encoder(_model()[0], k=3),
    "candidate_embeddings": lambda: _model()[1].candidate_embeddings(_model()[0]),
    "predict": lambda: _encoder()[1].predict(_encoder()[0], batch_size=16),
    "fit": lambda: _model()[1].compile(optimizer="adagrad", metrics=[]).fit(
        _model()[0], batch_size=16),
    "BruteForce.index": lambda: mt.BruteForce(k=3).index(C),
    "topk_scores": lambda: ttopk.topk_scores(Q, C, 3),
    "binned_topk": lambda: ttopk.binned_topk(Q, C, 3),
    "blockwise_topk": lambda: ttopk.blockwise_topk(Q, C, 3),
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
