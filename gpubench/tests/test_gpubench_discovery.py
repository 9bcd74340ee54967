"""The harness finds a cell, a configuration and a metric by name, so a new
one is new files and entries alone."""

import json
import shutil

import pytest

from conftest import ROOT
from gpubench import harness


@pytest.fixture
def bench_copy(tmp_path, monkeypatch):
    """A copy of the benchmark's files, with the harness looking there."""
    dest = tmp_path / "gpubench"
    shutil.copytree(ROOT / "gpubench", dest, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    monkeypatch.setattr(harness, "HERE", dest)
    return dest


def test_a_cell_added_as_a_file_is_found(bench_copy):
    spec = json.loads((bench_copy / "workloads" / "tt_train.json").read_text())
    spec["traffic"] = "fit_1m_spe8"
    (bench_copy / "workloads" / "tt_train_spe8.json").write_text(json.dumps(spec))
    tr = json.loads((bench_copy / "traffic" / "fit_1m_spe16.json").read_text())
    tr.update(steps_per_execution=8)
    (bench_copy / "traffic" / "fit_1m_spe8.json").write_text(json.dumps(tr))
    cell = harness.find_cell("tt_train_spe8")
    assert cell.traffic["steps_per_execution"] == 8
    assert cell.config["name"] == "two_tower_ml25m"
    assert cell.entry().__name__ == "gpubench.entries.train"
    with pytest.raises(FileNotFoundError):
        harness.find_cell("no_such_cell")


def test_a_metric_added_as_a_file_is_found(bench_copy):
    (bench_copy / "metrics" / "busy_s.train.py").write_text(
        "def read(r):\n    return r.trace.busy_s\n")

    class Trace:
        busy_s = 1.5

    module = harness.metric_module("busy_s.train")
    assert module.read(harness.Reading(Trace(), {}, {}, {})) == 1.5


def test_a_configuration_added_as_a_file_is_found(bench_copy):
    cfg = json.loads((bench_copy / "configs" / "dlrm_criteo_tb.json").read_text())
    cfg["name"] = "dlrm_criteo_small"
    (bench_copy / "configs" / "dlrm_criteo_small.json").write_text(json.dumps(cfg))
    spec = json.loads((bench_copy / "workloads" / "dlrm_train.json").read_text())
    spec["config"] = "dlrm_criteo_small"
    (bench_copy / "workloads" / "dlrm_small_train.json").write_text(json.dumps(spec))
    cell = harness.find_cell("dlrm_small_train")
    assert cell.config["name"] == "dlrm_criteo_small"
    assert cell.module("reference").__name__ == "gpubench.kinds.dlrm.reference"
