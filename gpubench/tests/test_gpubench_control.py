"""Each cell's control (``gpubench/control.py``: the plain reference put in
the program's place and run in TF32) comes out not correct under the cell's
limits, at the cell's own size. Needs a CUDA card (TF32 exists only there);
skips without one."""

import json

import pytest

from conftest import BIG_SEED, ROOT
from gpubench import harness

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, card):
    c = harness.find_cell(cell)
    limits = c.spec["limits"]
    assert limits and all(v is not None for v in limits.values()), limits
    gaps = c.entry().control(c, BIG_SEED, card)
    checks = {n: (v, limits[n]) for n, v in gaps.items()}
    assert not harness.correct_of(checks), checks
