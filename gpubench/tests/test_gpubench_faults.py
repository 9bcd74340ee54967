"""A run with its timed path broken underneath comes out not correct: the
harness's look for a card is skipped, everything else of a run is driven
(on the CPU, at a small size), once for each fault the cell can have. One
card: no exchange between chips to leave out."""

import pytest
import torch

from conftest import run_small, small_cell
from gpubench import harness

TRAIN = ["tt_train", "dlrm_train"]
RETRIEVAL = ["tt_corpus_eval"]


def _half(v):
    if torch.is_tensor(v):
        return v[: v.shape[0] // 2]
    if isinstance(v, dict):
        return {k: _half(x) for k, x in v.items()}
    if hasattr(v, "values") and hasattr(v, "mask"):
        return type(v)(v.values[: v.values.shape[0] // 2], v.mask[: v.mask.shape[0] // 2])
    return v


def state_unchanged(monkeypatch):
    """The optimizer's step leaves every parameter as it found it (its
    update is nought)."""
    from models_tpu_torch.blocks import optimizer

    monkeypatch.setattr(optimizer.Adagrad, "_direction",
                        lambda self, params, grads: [torch.zeros_like(g) for g in grads])


def half_batch(monkeypatch):
    """Each step trains on half its batch, the mean taken over the rest."""
    from models_tpu_torch.models.base import Model

    inner = Model.train_step

    def step(self, x, y, *args, **kwargs):
        return inner(self, _half(x), _half(y), *args, **kwargs)

    monkeypatch.setattr(Model, "train_step", step)


def _after_first_chunk(monkeypatch, broken):
    """Every chunk after a fit's first (on the card, the graph's replays)
    runs ``broken(inner, self, *args)`` in place of the program's own."""
    from models_tpu_torch.models.base import Model

    inner = Model._run_chunk
    calls = []

    def run_chunk(self, *args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            return inner(self, *args, **kwargs)
        return broken(inner, self, *args, **kwargs)

    monkeypatch.setattr(Model, "_run_chunk", run_chunk)


def replays_without_update(monkeypatch):
    """The chunks after the first leave every parameter as they found it."""
    from models_tpu_torch.blocks import optimizer

    def broken(inner, self, *args, **kwargs):
        with monkeypatch.context() as m:
            m.setattr(optimizer.Adagrad, "_direction",
                      lambda opt, params, grads: [torch.zeros_like(g) for g in grads])
            return inner(self, *args, **kwargs)

    _after_first_chunk(monkeypatch, broken)


def replays_with_stale_ids(monkeypatch):
    """The chunks after the second train the second chunk's rows again: on
    the card, the captured chunk's ids left in the graph's index buffer."""
    first = []

    def broken(inner, self, source, spec, idx, *args, **kwargs):
        if not first:
            first.append(idx.clone())
        return inner(self, source, spec, first[0][: idx.shape[0]], *args, **kwargs)

    _after_first_chunk(monkeypatch, broken)


def answer_altered(monkeypatch):
    """The first query of each top-k call gets its ids in another order."""
    from models_tpu_torch.outputs import topk

    inner = topk.topk_scores

    def altered(*args, **kwargs):
        scores, ids = inner(*args, **kwargs)
        ids = ids.clone()
        ids[0] = ids[0].roll(1)
        return scores, ids

    monkeypatch.setattr(topk, "topk_scores", altered)


def scores_altered(monkeypatch):
    """Every answer keeps its ids and their order, its scores a thousandth
    off: no metric moves."""
    from models_tpu_torch.outputs import topk

    inner = topk.topk_scores

    def altered(*args, **kwargs):
        scores, ids = inner(*args, **kwargs)
        return scores * 1.001, ids

    monkeypatch.setattr(topk, "topk_scores", altered)


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", [state_unchanged, half_batch, replays_without_update,
                                   replays_with_stale_ids])
def test_training_fault_is_caught(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = run_small(small_cell(cell))
    assert not harness.correct_of(out.checks), out.checks


@pytest.mark.parametrize("cell", RETRIEVAL)
@pytest.mark.parametrize("fault", [answer_altered, scores_altered])
def test_altered_answer_is_caught(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = run_small(small_cell(cell))
    assert not harness.correct_of(out.checks), out.checks


@pytest.mark.parametrize("cell", TRAIN + RETRIEVAL)
def test_sound_run_is_correct(cell):
    assert harness.correct_of(run_small(small_cell(cell)).checks)
