"""Spans and counters of the program's own host work.

A span names a stretch of host time inside ``fit``, ``evaluate`` and the
layers under them (the chunk loop, the graph route, the pack uploads, the
kernels' build); a counter counts an event there (a graph replayed or
captured, bytes uploaded, a fetch). Both stay in this process's memory.

- ``span(name)``: a context manager. While tracing is on it records
  ``models_tpu_torch.<name>`` with its own id, its parent's id (the
  innermost recorded span open on this thread) and its root's id (the
  outermost one: every span of one ``fit`` or ``evaluate`` shares it), and
  its start and end by ``time.perf_counter_ns``. Off, it returns one shared
  no-op context after a flag check.
- ``count(name, n=1)``: adds ``n`` to a counter. Counters are always on;
  while tracing is on a root span keeps the counters' changes over its call.
- ``snapshot()``: the recorded spans, each with its self time (its duration
  less the part its children cover), and the counters. ``reset()`` clears
  both.

Tracing is on while a ``torch.profiler`` session records, or from
``enable()`` until ``disable()``. While a profiler records, each span is also
a ``torch.profiler.record_function`` range of the same name, so the spans
sit in the profiler's events (and in a Chrome trace it exports) on the clock
of the device's events. The profiler's recording flag is read at each span,
so a profiler started inside a call (``ProfilerCallback`` starts one at a
chunk's end) records the spans that open after it; a span opened before
then is not recorded, and the first recorded span under it is a root.

Every name starts with ``models_tpu_torch.``: a span of the program never
takes the name of one a caller records around it (a benchmark's ``fit``).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from typing import Callable, Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

PREFIX = "models_tpu_torch."


_NO_SPAN = contextlib.nullcontext()


class _Span:
    __slots__ = ("recorder", "name", "id", "parent", "root", "start_ns", "end_ns",
                 "counters", "_range", "_before")

    def __init__(self, recorder: "Recorder", name: str):
        self.recorder, self.name = recorder, name
        self.counters: Optional[Dict[str, int]] = None
        self._range = None

    def __enter__(self):
        rec = self.recorder
        stack = rec._stack()
        parent = stack[-1] if stack else None
        self.id = next(rec._ids)
        self.parent = parent.id if parent is not None else None
        self.root = parent.root if parent is not None else self.id
        if parent is None:
            self._before = rec._counts()
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        rec = self.recorder
        rec._stack().pop()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        if self.parent is None:
            before = self._before
            self.counters = {k: v - before.get(k, 0) for k, v in rec._counts().items()
                             if v != before.get(k, 0)}
            self._before = None
        rec._done.append(self)
        return False


class Recorder:
    """The spans and counters of one process (module-level: ``RECORDER``)."""

    def __init__(self):
        self.enabled = False
        self.counters: Dict[str, int] = {}
        self._done: List[_Span] = []
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()  # counters may be bumped from any thread

    def _stack(self) -> List[_Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str):
        # the profiler's own flag for fast checks in Python, set while it records
        if not (self.enabled or _autograd_profiler._is_profiler_enabled):
            return _NO_SPAN
        return _Span(self, PREFIX + name)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def _counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.counters)

    def snapshot(self) -> dict:
        """``{"spans": [...], "counters": {...}}``: each finished span as a
        dict (``name``, ``id``, ``parent``, ``root``, ``start_ns``,
        ``end_ns``, ``self_ns``; a root also ``counters``, their changes over
        its call), in the order the spans ended."""
        done = list(self._done)
        covered: Dict[int, int] = {}
        for s in done:
            if s.parent is not None:
                covered[s.parent] = covered.get(s.parent, 0) + s.end_ns - s.start_ns
        spans = []
        for s in done:
            row = {"name": s.name, "id": s.id, "parent": s.parent, "root": s.root,
                   "start_ns": s.start_ns, "end_ns": s.end_ns,
                   "self_ns": s.end_ns - s.start_ns - covered.get(s.id, 0)}
            if s.counters is not None:
                row["counters"] = dict(s.counters)
            spans.append(row)
        return {"spans": spans, "counters": self._counts()}

    def reset(self) -> None:
        self._done.clear()
        with self._lock:
            self.counters.clear()


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
snapshot = RECORDER.snapshot
reset = RECORDER.reset


def enable() -> None:
    """Record spans with no profiler running, until :func:`disable`."""
    RECORDER.enabled = True


def disable() -> None:
    RECORDER.enabled = False


def traced(name: str) -> Callable:
    """A decorator: every call of the function is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap
