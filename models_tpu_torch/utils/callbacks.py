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
