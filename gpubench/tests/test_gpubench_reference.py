"""The plain references agree with models_tpu_torch at CPU sizes: the same
weights give the same towers, losses and Adagrad steps."""

import numpy as np
import pytest
import torch

from conftest import BIG_SEED, run_small, small_cell
from gpubench import traffic, weights
from gpubench.kinds.two_tower import program as tt_program, reference as tt_reference

CELLS = ["tt_train", "dlrm_train", "tt_corpus_eval"]


def test_weights_repeat_in_place():
    a = weights.make((50, 8), ("uniform", 0.05), BIG_SEED, 3, "cpu")
    b = torch.zeros(60, 8)
    weights.fill_(b[5:55], ("uniform", 0.05), BIG_SEED, 3)
    assert torch.equal(a, b[5:55])
    assert a.abs().max() <= 0.05
    g = weights.make((4, 6), ("glorot_uniform",), 1, 0, "cpu")
    assert g.abs().max() <= (6 / 10) ** 0.5


def test_two_tower_towers_equal_the_programs():
    import models_tpu_torch as mt
    from models_tpu_torch.core.types import to_device_batch

    cfg = small_cell("tt_train").config
    data = traffic.draw_columns(cfg["columns"], 64, np.random.default_rng(5), 0.75)
    model = tt_program.build(cfg, "cpu")
    ds = tt_program.dataset(cfg, data)
    leaves = tt_program.leaves(model, cfg)
    params = tt_reference.make_params(cfg, 9, "cpu")
    with torch.no_grad():
        for name, p in params.items():
            leaves[name].value().copy_(p)
        x, _ = next(iter(mt.Loader(ds, 64)))
        towers = model.blocks[0](to_device_batch(x, "cpu"))
        batch = tt_reference.batch(cfg, data, np.arange(64), "cpu")
        torch.testing.assert_close(towers["query"], tt_reference.tower(cfg, "query", params, batch),
                                   rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(towers["candidate"],
                                   tt_reference.tower(cfg, "item", params, batch),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_agrees_with_the_reference(cell):
    """Every number a run compares is near 0 for the program on the CPU."""
    out = run_small(small_cell(cell))
    assert out.failed == 0 and out.attempted > 0
    for name, (value, _) in out.checks.items():
        assert value <= (1e-3 if name == "metric_gap" else 1e-5), (name, value)
