"""The benchmark's spans and its reading of a profiler trace.

Spans: the harness's own, around each call into the program (``fit``,
``evaluate``), kept in memory; under the profiler each is also a
``record_function`` range.

A traced window is a few calls run under ``torch.profiler`` (CPU and CUDA
activity) after one warm-up call, delimited on the device's timeline by two
``torch.cuda._sleep`` kernels (nothing the program runs launches one) behind
a few float64 fillers, which take the place of events the profiler may drop
at a window's start (as ``chip_smoke.py``'s ``traced_window`` does). From
its device events (kernels, copies and sets; no annotation ranges, whose
time would count twice): the union of their busy intervals, each kernel's
device time by name, and the idle gaps named by the harness span the host
was in when each began.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

MARKER = "spin_kernel"  # torch.cuda._sleep's kernel
FILLERS = 32
TOP = 10


class Spans:
    """Host spans (name, start, end) by ``time.perf_counter``."""

    def __init__(self):
        self.done: List[Tuple[str, float, float]] = []
        self.profiling = False

    @contextlib.contextmanager
    def span(self, name: str):
        t = time.perf_counter()
        ctx = torch.profiler.record_function(name) if self.profiling else contextlib.nullcontext()
        with ctx:
            yield
        self.done.append((name, t, time.perf_counter()))


class Trace:
    """A traced window's device events: ``(name, start_us, end_us)`` and the
    host spans ``(name, start_us, end_us)`` on the profiler's clock."""

    def __init__(self, events: List[Tuple[str, float, float]],
                 spans: List[Tuple[str, float, float]], window: Tuple[float, float]):
        self.events, self.spans, self.window = events, spans, window
        self.window_s = (window[1] - window[0]) / 1e6
        self.intervals = _union([(s, e) for _, s, e in events])
        self.busy_s = sum(e - s for s, e in self.intervals) / 1e6

    def kernel_s(self, match: Callable[[str], bool]) -> Optional[float]:
        """The device seconds of the events whose name ``match`` accepts,
        or None where there is none."""
        times = [e - s for n, s, e in self.events if match(n)]
        return sum(times) / 1e6 if times else None

    def top_ops(self) -> List[list]:
        by_name: Dict[str, float] = {}
        for n, s, e in self.events:
            by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
        return [[n[:160], v] for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> List[list]:
        """The device's idle time in the window, by the innermost harness
        span the host was in when each gap began ("harness" outside all)."""
        edges = [self.window[0]] + [x for iv in self.intervals for x in iv] + [self.window[1]]
        by_span: Dict[str, float] = {}
        for i in range(0, len(edges), 2):
            start, end = edges[i], edges[i + 1]
            if end <= start:
                continue
            inside = [(s, n) for n, s, e in self.spans if s <= start < e]
            name = max(inside)[1] if inside else "harness"
            by_span[name] = by_span.get(name, 0.0) + (end - start) / 1e6
        return [[n, v] for n, v in sorted(by_span.items(), key=lambda kv: -kv[1])[:TOP]]


def _union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _is_device(e) -> bool:
    from torch.autograd import DeviceType

    return e.device_type == DeviceType.CUDA and not (
        getattr(e, "is_user_annotation", False) or e.name.startswith("Optimizer."))


def trace_calls(call: Callable[[], None], n: int, spans: Spans) -> Trace:
    """``call()`` once as the profiler's warm-up, then ``n`` times traced;
    each call ends in a synchronise. Returns the traced window."""
    from torch.profiler import ProfilerActivity, profile, schedule

    filler = torch.zeros(1, device="cuda", dtype=torch.float64)
    events = []
    spans.profiling = True
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: events.extend(p.events())) as prof:
            call()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(FILLERS):
                filler.add_(1.0)
            torch.cuda._sleep(1)
            for _ in range(n):
                call()
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
            prof.step()
    finally:
        spans.profiling = False
    names = {name for name, _, _ in spans.done}
    dev = [(e.name, e.time_range.start, e.time_range.end) for e in events if _is_device(e)]
    marks = sorted((s, e) for n, s, e in dev if MARKER in n)
    host = [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.name in names and not _is_device(e)]
    if len(marks) == 2:
        window = (marks[0][1], marks[1][0])
    elif host:  # a marker lost: the window of the traced calls' spans
        window = (min(s for _, s, _ in host), max(e for _, _, e in host))
    else:
        raise RuntimeError("the trace holds neither window marker nor a harness span")
    inside = [(n, max(s, window[0]), min(e, window[1])) for n, s, e in dev
              if MARKER not in n and e > window[0] and s < window[1]]
    return Trace(inside, host, window)
