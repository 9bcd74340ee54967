"""Training callbacks (``models_tpu/utils/callbacks.py``).

``Model.fit`` calls ``set_model``, ``on_epoch_begin``, ``on_batch_end``,
``on_epoch_end`` and ``on_train_end`` where a callback has them. With
``compile(steps_per_execution=k)`` ``on_batch_end`` comes once a chunk,
with the chunk's last step's logs. A batch's logs are tensors on the
device: reading one copies it to the host, so the callbacks here read the
epoch's logs (host floats) and count batches.
"""

from __future__ import annotations

import math
import time
from typing import Optional


class Callback:
    model = None

    def set_model(self, model):
        self.model = model

    def on_epoch_begin(self, epoch):
        pass

    def on_batch_end(self, step, logs):
        pass

    def on_epoch_end(self, epoch, logs):
        pass


class ExamplesPerSecondCallback(Callback):
    """Examples a second over every ``every_n_steps`` calls of
    ``on_batch_end`` (host clock, without a synchronise: the rate at which
    steps are queued, which the device's rate bounds once its queue fills),
    appended to ``history`` and passed to ``log_fn``. Under
    ``steps_per_execution=k`` a call is a chunk: give ``batch_size`` as
    ``k * batch``."""

    def __init__(self, batch_size: int, every_n_steps: int = 100, log_fn=print):
        self.batch_size = batch_size
        self.every_n_steps = every_n_steps
        self.log_fn = log_fn
        self._t0 = None
        self._count = 0
        self.history = []

    def on_epoch_begin(self, epoch):
        self._t0 = time.perf_counter()
        self._count = 0

    def on_batch_end(self, step, logs):
        self._count += 1
        if self._count % self.every_n_steps == 0:
            dt = time.perf_counter() - self._t0
            eps = self.every_n_steps * self.batch_size / max(dt, 1e-9)
            self.history.append(eps)
            self.log_fn(f"examples/sec (last {self.every_n_steps} steps): {eps:,.0f}")
            self._t0 = time.perf_counter()


class WandbLogger(Callback):
    """Each epoch's logs to Weights & Biases (``models_tpu/utils/callbacks.py``).
    Without the ``wandb`` package it does nothing."""

    def __init__(self, project: str = "models-tpu", run_name: Optional[str] = None, config=None):
        try:
            import wandb
        except ImportError:
            wandb = None
        self._wandb = wandb
        self.project = project
        self.run_name = run_name
        self.config = config or {}
        self._run = None

    def set_model(self, model):
        super().set_model(model)
        if self._wandb is not None and self._run is None:
            self._run = self._wandb.init(project=self.project, name=self.run_name,
                                         config=self.config)

    def on_epoch_end(self, epoch, logs):
        if self._run is not None:
            self._wandb.log(dict(logs), step=epoch)

    def finish(self):
        if self._run is not None:
            self._run.finish()


class ProfilerCallback(Callback):
    """A ``torch.profiler`` trace of the ``num_steps`` calls of
    ``on_batch_end`` from the ``start_step``-th on (counted from 1 over the
    fit), written to ``log_dir`` as a Chrome trace (``trace.json``, CPU and,
    on the card, CUDA activity). ``trace_path`` names the file once it is
    written. Under ``steps_per_execution=k`` a call is a chunk."""

    def __init__(self, log_dir: str, start_step: int = 5, num_steps: int = 5):
        self.log_dir = log_dir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self.trace_path: Optional[str] = None
        self._prof = None
        self._calls = 0

    def _stop(self):
        import os

        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        self.trace_path = os.path.join(self.log_dir, "trace.json")
        self._prof.export_chrome_trace(self.trace_path)
        self._prof = None

    def on_batch_end(self, step, logs):
        import torch

        self._calls += 1
        if self._calls + 1 == self.start_step and self._prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
        elif self._calls + 1 == self.stop_step and self._prof is not None:
            self._stop()

    def on_train_end(self, logs=None):
        if self._prof is not None:
            self._stop()


class EarlyStopping(Callback):
    """Stop when the epoch's ``monitor`` stops improving by more than
    ``min_delta`` for ``patience`` epochs (``mode`` ``"min"`` or ``"max"``)."""

    def __init__(self, monitor: str = "loss", patience: int = 3, mode: str = "min",
                 min_delta: float = 0.0):
        self.monitor = monitor
        self.patience = patience
        self.mode = mode
        self.min_delta = min_delta
        self.best = None
        self.wait = 0

    def on_epoch_end(self, epoch, logs):
        value = logs.get(self.monitor)
        if value is None:
            return
        improved = (self.best is None
                    or (self.mode == "min" and value < self.best - self.min_delta)
                    or (self.mode == "max" and value > self.best + self.min_delta))
        if improved:
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience and self.model is not None:
                self.model.stop_training = True


class CSVLogger(Callback):
    """Each epoch's logs as a row of ``filename`` (``epoch`` first, the
    keys sorted). New keys in a later epoch (``val_*`` with
    ``validation_freq`` > 1) widen the header and rewrite this run's rows;
    appended to a file that had rows, the first epoch's columns stay."""

    def __init__(self, filename: str, separator: str = ",", append: bool = False):
        self.filename = filename
        self.sep = separator
        self.append = append
        self._keys = None
        self._file = None
        self._rows = []
        self._fixed_header = False

    def _write_row(self, epoch, logs):
        row = [str(epoch)] + [f"{logs[k]:.6g}" if k in logs else "" for k in self._keys]
        self._file.write(self.sep.join(row) + "\n")

    def _write_header(self):
        self._file.write(self.sep.join(["epoch"] + self._keys) + "\n")

    def on_epoch_end(self, epoch, logs):
        logs = dict(logs or {})
        self._rows.append((epoch, logs))
        if self._file is None:
            self._file = open(self.filename, "a" if self.append else "w")
            self._keys = sorted(logs)
            self._fixed_header = self.append and self._file.tell() > 0
            if not self._fixed_header:
                self._write_header()
        elif not self._fixed_header and not set(logs) <= set(self._keys):
            self._keys = sorted(set(self._keys) | set(logs))
            self._file.close()
            self._file = open(self.filename, "w")
            self._write_header()
            for e, lg in self._rows[:-1]:
                self._write_row(e, lg)
        self._write_row(epoch, logs)
        self._file.flush()

    def on_train_end(self, logs=None):
        if self._file is not None:
            self._file.close()
            self._file = None


class TerminateOnNaN(Callback):
    """Stop after an epoch whose loss is not finite (checked at the epoch's
    end, where the logs are on the host)."""

    def on_epoch_end(self, epoch, logs):
        loss = (logs or {}).get("loss")
        if loss is not None and not math.isfinite(float(loss)):
            print(f"epoch {epoch}: non-finite loss {loss}; terminating training")
            if self.model is not None:
                self.model.stop_training = True
