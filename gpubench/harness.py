"""The benchmark's driver: a cell found by name, its entry run, the result
line printed.

A cell is ``workloads/<name>.json``: its ``config`` (``configs/<config>.json``,
whose ``kind`` names ``kinds/<kind>/``: the program's model built to it, and
its plain reference), its ``traffic`` (``traffic/<traffic>.json``, whose
``entry`` names ``entries/<entry>.py``), the end-to-end and per-layer
metrics it reports (a per-layer metric is ``metrics/<name>.py``) and the
limits of the numbers its check compares. Nothing here names a cell, a
configuration or a metric: a new one is new files.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "models_tpu")


def process_start() -> float:
    """This process's start on the ``time.time`` clock (Linux's
    ``/proc/self/stat``), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_module(name: str) -> ModuleType:
    return load_module(HERE / "metrics" / f"{name}.py",
                       "gpubench_metric_" + name.replace(".", "_").replace("-", "_"))


@dataclass
class Cell:
    name: str
    spec: dict
    config: dict
    traffic: dict

    @property
    def kind(self) -> str:
        return self.config["kind"]

    def module(self, part: str) -> ModuleType:
        """``kinds/<kind>/<part>.py`` (``program``, ``reference``, ``work``)."""
        return importlib.import_module(f"gpubench.kinds.{self.kind}.{part}")

    def entry(self) -> ModuleType:
        return importlib.import_module(f"gpubench.entries.{self.traffic['entry']}")


def find_cell(name: str) -> Cell:
    path = HERE / "workloads" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no cell {name!r}: {path.relative_to(HERE.parent)} is missing")
    spec = load_json(path)
    config = load_json(HERE / "configs" / f"{spec['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{spec['traffic']}.json")
    return Cell(name, spec, config, traffic)


@dataclass
class Outcome:
    """What an entry hands back: its end-to-end values, its counts, the
    numbers its check compared ((value, limit) by name) and, traced, what
    the per-layer metrics read."""
    metrics: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, tuple]
    memory_peak_bytes: int
    trace: Optional[object] = None
    work: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)


def peaks(device_name: str) -> dict:
    table = load_json(HERE / "peaks.json")
    for key, row in table.items():
        if key in device_name:
            return row
    raise KeyError(f"no peaks for {device_name!r} in peaks.json")


class Reading:
    """What a per-layer metric's ``read(r)`` is given: the traced window
    (``r.trace``: ``kernel_s``, ``busy_s``, ``window_s``), the work the
    traced calls did by count (``r.work``), the program's counters
    (``r.counters``) and the card's peaks (``r.peaks``)."""

    def __init__(self, trace, work, counters, peak_table):
        self.trace, self.work, self.counters, self.peaks = trace, work, counters, peak_table


def correct_of(checks: Dict[str, tuple]) -> bool:
    """Every number at or under its limit (a missing limit or number fails)."""
    return bool(checks) and all(
        v is not None and lim is not None and math.isfinite(v) and v <= lim
        for v, lim in checks.values())


def forbidden_modules() -> List[str]:
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def unit_of(name: str) -> str:
    for section in ("end_to_end", "per_layer"):
        for m in load_json(HERE.parent / "BENCHMARK.json")[section]:
            if m["name"] == name:
                return m["unit"]
    raise KeyError(name)


def result_line(cell: Cell, outcome: Outcome, trace: bool, device: dict) -> dict:
    if trace:
        reading = Reading(outcome.trace, outcome.work, outcome.counters, peaks(device["kind"]))
        values = {}
        for name in cell.spec["per_layer"]:
            v = metric_module(name).read(reading)
            if v is not None:
                values[name] = v
        device = dict(device, busy_s=outcome.trace.busy_s, window_s=outcome.trace.window_s)
    else:
        values = {name: outcome.metrics[name] for name in cell.spec["end_to_end"]}
    line = {
        "correct": correct_of(outcome.checks),
        "attempted": outcome.attempted,
        "failed": outcome.failed,
        "metrics": {n: {"value": v, "unit": unit_of(n)} for n, v in values.items()},
        "device": device,
    }
    if trace:
        line["breakdown"] = {"device_ops": outcome.trace.top_ops(),
                             "idle_gaps": outcome.trace.idle_gaps()}
    line["checks"] = {n: {"value": v, "limit": lim} for n, (v, lim) in outcome.checks.items()}
    return line


class RunContext:
    """One run of a cell: its seed, window, tracing, the process's start,
    the harness's spans and the card."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, t_start: float):
        from .tracing import Spans

        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.t_start = t_start
        self.spans = Spans()
        self.device = "cuda"

    def since_start(self) -> float:
        return time.time() - self.t_start

    @property
    def limits(self) -> Dict[str, Optional[float]]:
        return self.cell.spec.get("limits", {})


def import_program() -> ModuleType:
    """``models_tpu_torch`` from this checkout, never an installed copy."""
    import models_tpu_torch

    where = Path(models_tpu_torch.__file__).resolve()
    if HERE.parent not in where.parents:
        raise ImportError(f"models_tpu_torch was found at {where}, outside this checkout")
    return models_tpu_torch
