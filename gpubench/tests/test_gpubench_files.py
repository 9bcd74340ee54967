"""BENCHMARK.json and every file of the benchmark parse, keep to the
contract's names, units and limits, and agree with each other."""

import json
import re

import pytest

from conftest import ROOT
from gpubench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
HERE = ROOT / "gpubench"
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"]
    assert BENCH["command"][1] == "gpubench/run.py" and len(BENCH["command"]) <= 32
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_text():
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[section]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((section in ("end_to_end", "per_layer"), entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            texts = [entry[k] for k in ("why", "layer") if k in entry]
            if section == "configs":
                texts.append(entry["source"])
            for text in texts:
                assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(names) == len(set(names))
    assert len({n for m, n in names if m}) == len([n for m, n in names if m])


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert e2e["setup_s"]["bound"] <= 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_cell_file_agrees(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    found = harness.find_cell(cell)
    assert found.spec["config"] == entry["config"]
    assert found.spec["traffic"] == entry["traffic"]
    assert found.spec["chips"] == entry["chips"] == 1
    assert len(entry["why"]) <= 200
    e2e = [m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])]
    assert sorted(found.spec["end_to_end"]) == sorted(e2e)
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = [m["name"] for m in BENCH["per_layer"] if cell in m.get("workloads", [cell])]
    assert sorted(found.spec["per_layer"]) == sorted(layers) and layers
    assert found.traffic["entry"] in ("train", "corpus_evaluate")
    assert (HERE / "entries" / f"{found.traffic['entry']}.py").is_file()


@pytest.mark.parametrize("metric", METRICS)
def test_per_layer_metric(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    module = harness.metric_module(metric)
    assert callable(module.read)
    for cell in m["workloads"]:
        assert m["moves"] in harness.find_cell(cell).spec["end_to_end"]
    layers = {x["layer"] for x in BENCH["per_layer"]}
    assert m["layer"] in layers


def test_configs():
    files = set()
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("gpubench/")
        files.add(c["file"])
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["precision"] == "float32" and cfg["tf32"] is False
        assert (HERE / "kinds" / cfg["kind"] / "reference.py").is_file()
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    assert len(files) == len(BENCH["configs"])


def test_every_file_named_from_name_characters():
    for path in HERE.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
