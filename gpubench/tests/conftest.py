"""Shared pieces of the benchmark's tests: cells cut to a size the CPU runs
in seconds (the program's model on the CPU, the same code paths), and the
``card`` marker for tests that need a CUDA card (they skip without one)."""

import copy
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench import harness  # noqa: E402

SMALL_MAX_ID = 1000  # the criteo-small schema's domains
BIG_SEED = 2 ** 31 + 12345


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# a CPU run's numbers are rounding's, near 0; a mean metric's gap is in queries
SMALL_LIMITS = {"metric_gap": 0.05}


def small_cell(name: str, limits: float = 1e-3) -> harness.Cell:
    """Cell ``name`` at a CPU size: batch 64, a few batches; a DLRM's tables
    cut to at most 1001 rows."""
    cell = harness.find_cell(name)
    cfg, tr = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    if cfg["kind"] == "dlrm":
        for col in cfg["columns"]:
            if "max_id" in col:
                col["max_id"] = min(col["max_id"], SMALL_MAX_ID)
    cfg["batch_size"] = 64
    if tr["entry"] == "train":
        tr.update(rows=256, steps_per_execution=2, warm_fits=1)
    else:
        tr.update(queries=512, batch_size=128, warm_calls=1, index_batch=4096, check_rows=64)
    spec = dict(cell.spec, limits={k: SMALL_LIMITS.get(k, limits) for k in cell.spec["limits"]})
    return harness.Cell(name, spec, cfg, tr)


def run_small(cell: harness.Cell, seed: int = BIG_SEED, seconds: float = 0.3):
    """The cell's entry on the CPU, every step of a run but the card's
    checks and the trace; returns its Outcome."""
    run = harness.RunContext(cell, seed, seconds, False, time.time())
    run.device = "cpu"
    return cell.entry().run(run)
