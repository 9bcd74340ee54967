"""The device's idle time in a traced window, split by the span the host was
in at each instant of it.

A traced window (``tracing.py::trace_calls``) holds the device's events and
the harness's spans (``fit``, ``evaluate``). The program records spans of
its own (``models_tpu_torch/utils/trace.py``): under a profiler each is a
host event named ``models_tpu_torch.<name>`` in the same trace, on the clock
of the device's events, nested inside the harness's span. :func:`split`
charges each instant of each idle interval of the device to the innermost
span open on the host then: a program span, else a harness span, else
``harness``. (``Trace.idle_gaps()`` names a whole gap by the harness span
in which it began.)

The per-layer metrics ``host_idle_share.train`` / ``.eval`` and
``graph_replay_share.train`` / ``.eval`` (``metrics/``) read the program's
spans as ``trace.program_spans`` and return None where there are none.

As a command, it runs one cell as ``run.py`` does and prints the same
result line, with ``--trace 1`` also a ``program`` object: the traced
window's idle split, its program spans by name (count and seconds), the
idle seconds inside each graph replay, those four metrics and the
program's counters. ``--record 1`` turns the program's
recorder on for the whole run (``enable()``, no profiler): with ``--trace
0`` its end-to-end metrics are those of a run with the spans on.

    python3 gpubench/idle_split.py --workload tt_train --seed 11 --seconds 51 --trace 1
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

PREFIX = "models_tpu_torch."
FETCH = PREFIX + "fetch"  # a wait on the card for the host's copy, not host work
REPLAY = PREFIX + "graph.replay"
Span = Tuple[str, float, float]  # (name, start_us, end_us) on the profiler's clock


def program_spans(events) -> List[Span]:
    """The program's spans among a profiler's events: host ranges named
    under ``models_tpu_torch.``."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.name.startswith(PREFIX) and e.device_type == DeviceType.CPU]


def under(spans: Sequence[Span], root: str) -> List[Span]:
    """The spans that lie inside a span named ``root`` (those included)."""
    roots = [(s, e) for n, s, e in spans if n == root]
    return [x for x in spans if any(s <= x[1] and x[2] <= e for s, e in roots)]


def _idle(trace) -> List[Tuple[float, float]]:
    lo, hi = trace.window
    out, at = [], lo
    for s, e in trace.intervals:
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def _innermost(spans: Sequence[Span], lo: float, hi: float) -> List[Tuple[float, float, str]]:
    """The window cut where any span starts or ends, each piece named by the
    innermost span open over it (the latest start; a program span before a
    harness span over the same interval), ``harness`` where none is."""
    inside = sorted((max(s, lo), min(e, hi), n) for n, s, e in spans if e > lo and s < hi)
    cuts = sorted({lo, hi} | {x for s, e, _ in inside for x in (s, e)})
    pieces, active, j = [], [], 0
    for a, b in zip(cuts, cuts[1:]):
        while j < len(inside) and inside[j][0] <= a:
            active.append(inside[j])
            j += 1
        active = [x for x in active if x[1] > a]
        if active:
            s, e, n = max(active, key=lambda x: (x[0], -x[1], x[2].startswith(PREFIX)))
            pieces.append((a, b, n))
        else:
            pieces.append((a, b, "harness"))
    return pieces


def split(trace, program: Iterable[Span] = ()) -> Dict[str, float]:
    """Seconds of the device's idle time in ``trace``'s window by the
    innermost span the host was in: the program's spans (``program``) nest
    inside the harness's (``trace.spans``); time outside all is
    ``harness``."""
    lo, hi = trace.window
    pieces = _innermost(list(trace.spans) + list(program), lo, hi)
    out: Dict[str, float] = {}
    i = 0
    for s, e in _idle(trace):
        while i < len(pieces) and pieces[i][1] <= s:
            i += 1
        k = i
        while k < len(pieces) and pieces[k][0] < e:
            a, b, n = pieces[k]
            overlap = min(b, e) - max(a, s)
            if overlap > 0:
                out[n] = out.get(n, 0.0) + overlap / 1e6
            k += 1
    return out


def host_idle_share(trace, program: Sequence[Span], root: str):
    """The share (%) of the window in which the device was idle while the
    host was in a program span inside the program's ``root`` span (``fit``
    or ``evaluate``), ``fetch`` left out; None without such spans."""
    mine = under(program, PREFIX + root)
    if not mine or trace.window_s <= 0:
        return None
    by_span = split(trace, mine)
    idle = sum(v for n, v in by_span.items() if n.startswith(PREFIX) and n != FETCH)
    return 100.0 * idle / trace.window_s


def replay_share(program: Sequence[Span], chunk: str):
    """The share (%) of the program's ``chunk`` spans (a traced window's:
    those of the traced calls) that ran as a graph replay (hold a
    ``graph.replay`` span); None without chunks."""
    chunks = [(s, e) for n, s, e in program if n == PREFIX + chunk]
    if not chunks:
        return None
    replays = [(s, e) for n, s, e in program if n == REPLAY]
    hit = sum(any(s <= rs and re <= e for rs, re in replays) for s, e in chunks)
    return 100.0 * hit / len(chunks)


def _by_name(trace, program: Sequence[Span]) -> Dict[str, list]:
    lo, hi = trace.window
    out: Dict[str, list] = {}
    for n, s, e in program:
        if e > lo and s < hi:
            row = out.setdefault(n, [0, 0.0])
            row[0] += 1
            row[1] += (min(e, hi) - max(s, lo)) / 1e6
    return out


def idle_in(trace, program: Sequence[Span], name: str) -> List[float]:
    """The device's idle seconds inside each span named ``name``, in order."""
    idle = _idle(trace)
    return [sum(max(0.0, min(e, ie) - max(s, i_s)) for i_s, ie in idle) / 1e6
            for n, s, e in sorted(program, key=lambda x: x[1]) if n == name]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--record", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from gpubench import harness, run as run_py  # run_py: the caches under build/

    import torch

    cell = harness.find_cell(args.workload)
    if not torch.cuda.is_available():
        print("idle_split: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = bool(cell.config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cell.config["tf32"])
    from models_tpu_torch.utils import trace as program_trace

    if args.record:
        program_trace.enable()
    kept = []
    profile = torch.profiler.profile

    class Keeping(profile):
        """The profiler, its events kept for the program's spans."""

        def events(self):
            got = super().events()
            kept.append(got)
            return got

    torch.profiler.profile = Keeping
    try:
        run = harness.RunContext(cell, args.seed, args.seconds, bool(args.trace),
                                 run_py.T_START)
        outcome = cell.entry().run(run)
    finally:
        torch.profiler.profile = profile
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
              "memory_peak_bytes": outcome.memory_peak_bytes}
    line = harness.result_line(cell, outcome, run.trace, device)
    if run.trace:
        tr = outcome.trace
        tr.program_spans = program_spans(kept[-1]) if kept else []
        side = "train" if "train_examples_per_s" in cell.spec["end_to_end"] else "eval"
        reading = harness.Reading(tr, outcome.work, outcome.counters,
                                  harness.peaks(device["kind"]))
        line["program"] = {
            "idle_split": sorted(split(tr, tr.program_spans).items(), key=lambda kv: -kv[1]),
            "spans": _by_name(tr, tr.program_spans),
            "idle_in_replays": idle_in(tr, tr.program_spans, REPLAY),
            "metrics": {name: harness.metric_module(name).read(reading)
                        for name in (f"host_idle_share.{side}", f"graph_replay_share.{side}")},
            "counters": program_trace.snapshot()["counters"],
        }
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    root = str(Path(__file__).resolve().parent.parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    sys.exit(main())
