"""Training: ``Model.fit(epochs=1)`` over the cell's rows, back to back.

Set-up draws the rows and the weights from the seed, builds the program's
model to the configuration, fills its parameters with the weights, compiles
it (the configuration's optimizer and rate, no metrics, the traffic's
``steps_per_execution``) and fits it ``warm_fits`` times: the first fit
packs the rows on the card, runs its first chunk eagerly and captures the
chunk's CUDA graph on the second; every later chunk, and every chunk of a
later fit, replays it. The same model and optimizer state go on to the
window.

The window is whole ``fit`` calls, each ending in its logs' fetch; its
``train_examples_per_s`` is every example trained in it over its wall time.

What the check compares is read from the fits themselves: set-up's, from
the seed's weights, and the window's first, all the same call. Every fit
reports its mean loss and, through a callback, the loss of each chunk's
last step (a replay's, after the first chunk); while the first fit runs
its first ``check_steps`` steps eagerly, the benchmark reads each step's
loss and each leaf's gradient as the optimizer gets it at the first step;
at the end of set-up, each leaf's change from the seed's weights. After the
window the program is freed and the plain reference follows the same steps
from the seed's weights.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from .. import compare, traffic as traffic_mod, weights
from ..harness import Cell, Outcome, RunContext, import_program
from ..reference import precision
from ..tracing import trace_calls
from . import memory_peak, release, reset_peak, sync, timed_calls

CHANGE_BLOCK = 1 << 20  # rows of a leaf's change taken at a time


class StepObserver:
    """Reads the first ``steps`` training steps of ``model`` as they happen
    (each step's loss; each leaf's gradient at the first), by wrapping its
    ``train_step`` for those steps only (the wrapper is gone before any
    chunk is captured)."""

    def __init__(self, model, leaves, steps: int):
        self.model, self.leaves, self.steps, self.done = model, leaves, steps, 0
        self.losses, self.grad_norms = [], {}
        self._inner = model.train_step
        model.train_step = self._step

    def _step(self, *args, **kwargs):
        logs = self._inner(*args, **kwargs)
        self.done += 1
        with torch.no_grad():
            self.losses.append(logs["loss"].detach().clone())
            if self.done == 1:
                self.grad_norms = {n: _norm(leaf.grad()) for n, leaf in self.leaves.items()}
            if self.done == self.steps:
                del self.model.train_step  # the class's method from here on
        return logs

    def readings(self) -> dict:
        if self.done < self.steps:
            raise RuntimeError(f"the fit ran {self.done} steps, fewer than the "
                               f"{self.steps} checked")
        return {"losses": {i: float(v) for i, v in enumerate(self.losses)},
                "grad_norms": {n: float(v) for n, v in self.grad_norms.items()}}


class ChunkLosses:
    """A ``fit`` callback: the loss of each chunk's last step, as the fit
    hands it over (a tensor on the card, read after the fit)."""

    def __init__(self):
        self.got = []

    def on_batch_end(self, step, logs):
        self.got.append((int(step), logs["loss"]))

    def take(self) -> list:
        got, self.got = self.got, []
        return got


def _norm(t) -> torch.Tensor:
    if t is None:
        return torch.zeros((), dtype=torch.float64)
    return torch.linalg.vector_norm(t, dtype=torch.float64)


@torch.no_grad()
def change_norms(leaves, specs, seed: int) -> dict:
    """Each leaf's change from the seed's weights, in blocks of rows."""
    out = {}
    for i, (n, shape, init) in enumerate(specs):
        value = leaves[n].value()
        start = weights.make(shape, init, seed, i, value.device)
        sq = torch.zeros((), dtype=torch.float64, device=value.device)
        for lo in range(0, shape[0], CHANGE_BLOCK):
            sq += _norm(value[lo:lo + CHANGE_BLOCK] - start[lo:lo + CHANGE_BLOCK]) ** 2
        out[n] = float(sq.sqrt())
        del start
    return out


def draw(cfg: dict, tr: dict, seed: int) -> dict:
    return traffic_mod.draw_columns(cfg["columns"], tr["rows"], np.random.default_rng(seed),
                                    tr["id_skew"])


def checked_fits(tr: dict) -> int:
    """The fits the check follows: set-up's and the window's first."""
    return tr["warm_fits"] + 1


def steps_read(tr: dict, batch_size: int) -> list:
    """The steps whose loss a run reads (0-based, counted over the checked
    fits): the first ``check_steps`` and the last of each chunk."""
    spf, spe = tr["rows"] // batch_size, tr["steps_per_execution"]
    ends = sorted({min(lo + spe, spf) - 1 for lo in range(0, spf, spe)})
    steps = set(range(tr["check_steps"]))
    steps.update(j * spf + e for j in range(checked_fits(tr)) for e in ends)
    return sorted(steps)


def follow(cell: Cell, data: dict, seed: int, device, half: bool = False) -> dict:
    """The plain reference over the checked fits (every fit trains the
    rows in the same order); ``half``: each step on the first half of its
    batch."""
    cfg, tr = cell.config, cell.traffic
    B = cfg["batch_size"]
    spf = tr["rows"] // B
    fits = checked_fits(tr)
    order = np.tile(traffic_mod.fit_order(tr["rows"], tr["shuffle"])[:spf * B], fits)
    if half:
        order = order.reshape(-1, B)[:, :B // 2].reshape(-1)
        B //= 2
    return cell.module("reference").follow(cfg, data, order, B, fits * spf,
                                           tr["warm_fits"] * spf, seed, torch.device(device))


def run(run: RunContext) -> Outcome:
    mt = import_program()
    cell, cfg, tr = run.cell, run.cell.config, run.cell.traffic
    program, reference, work = cell.module("program"), cell.module("reference"), cell.module("work")
    dev = torch.device(run.device)
    B, rows = cfg["batch_size"], tr["rows"]
    steps_per_fit = rows // B
    reset_peak(dev)

    data = draw(cfg, tr, run.seed)
    ds = program.dataset(cfg, data)
    model = program.build(cfg, dev)
    model.build(mt.Loader(ds, B, drop_last=True), device=dev)
    specs = reference.leaf_specs(cfg)
    leaves = program.leaves(model, cfg)
    with torch.no_grad():
        for i, (name, _, init) in enumerate(specs):
            weights.fill_(leaves[name].value(), init, run.seed, i)
    model.compile(optimizer=cfg["optimizer"], learning_rate=cfg["learning_rate"], metrics=[],
                  steps_per_execution=tr["steps_per_execution"])

    chunk_losses = ChunkLosses()
    fits = []  # (mean loss, [(step, chunk's last loss)]) of each fit

    def fit():
        with run.spans.span("fit"):
            history = model.fit(ds, epochs=1, batch_size=B, shuffle=tr["shuffle"], verbose=0,
                                device=dev, callbacks=[chunk_losses])
        loss = history.history["loss"][-1]
        fits.append((loss, chunk_losses.take()))
        if not math.isfinite(loss):
            raise FloatingPointError(f"the fit's mean loss is {loss}")

    observer = StepObserver(model, leaves, tr["check_steps"])
    for _ in range(tr["warm_fits"]):
        fit()
    readings = observer.readings()
    del observer
    readings["change_norms"] = change_norms(leaves, specs, run.seed)
    counters = {"graph_capture_s": sum(s["capture_s"]
                                       for s in model._chunk_graphs.stats.values())}
    setup_s = run.since_start()

    window_s, calls, failed_fits = timed_calls(fit, run.seconds)
    attempted = len(calls) * steps_per_fit
    metrics = {"train_examples_per_s": attempted * B / window_s, "setup_s": setup_s}
    checked = fits[:checked_fits(tr)]
    del fits[checked_fits(tr):]

    trace, traced_work = None, {}
    if run.trace:
        n = tr["trace_calls"]
        trace = trace_calls(fit, n, run.spans)
        order = traffic_mod.fit_order(rows, tr["shuffle"])
        step_rows = [order[i * B:(i + 1) * B] for i in range(steps_per_fit)]
        traced_work = {
            "model_flops": n * steps_per_fit * work.train_flops(cfg, B),
            "optimizer_bytes": n * sum(work.optimizer_bytes(cfg, data, r) for r in step_rows),
        }
        if hasattr(work, "loss_flops"):
            traced_work["loss_flops"] = n * steps_per_fit * work.loss_flops(cfg, B)
            traced_work["loss_bytes"] = n * steps_per_fit * work.loss_bytes(cfg, B)
    sync(dev)
    peak = memory_peak(dev)

    readings["fit_losses"] = [loss for loss, _ in checked]
    for j, (_, ends) in enumerate(checked):
        readings["losses"].update((j * steps_per_fit + s, float(v)) for s, v in ends)
    del model, ds, leaves, fits, checked
    release(dev)
    ref = follow(cell, data, run.seed, dev)
    look = {}
    gaps = compare.training_gaps(readings, ref, steps_per_fit, look)
    print(f"train: {len(readings['losses'])} steps' losses and "
          f"{len(readings['fit_losses'])} fits' means read; worst leaves {look}", file=sys.stderr)
    checks = {name: (value, run.limits.get(name)) for name, value in gaps.items()}
    checks["failed_steps"] = (float(failed_fits * steps_per_fit), 0.0)
    return Outcome(metrics, attempted, failed_fits * steps_per_fit, checks, peak, trace,
                   traced_work, counters)


CONTROLS = ("tf32", "half_batch")


def control(cell: Cell, seed: int, device, kind: str = "tf32") -> dict:
    """The control: the plain reference put in the program's place over the
    checked fits, read at the steps a run reads, and held to the float32
    reference's by the run's own gaps. ``tf32``: run in TF32;
    ``half_batch``: a fault, each step on the first half of its batch, the
    mean over that half."""
    if kind not in CONTROLS:
        raise ValueError(f"no control {kind!r} for a training cell")
    cfg, tr = cell.config, cell.traffic
    B = cfg["batch_size"]
    data = draw(cfg, tr, seed)
    with precision(kind == "tf32"):
        low = follow(cell, data, seed, device, half=kind == "half_batch")
    release(device)
    with precision(False):
        ref = follow(cell, data, seed, device)
    spf = tr["rows"] // B
    look = {}
    gaps = compare.training_gaps(compare.observed(low, steps_read(tr, B), spf), ref, spf, look)
    print(f"control: worst leaves {look}", file=sys.stderr)
    return gaps
