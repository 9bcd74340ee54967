"""The idle split (``idle_split.py``) and the metrics that read it, on a
hand-built trace: each instant of an idle interval goes to the innermost
span the host was in, the program's spans inside the harness's; a trace
read with the program's spans gives every existing reading unchanged."""

from types import SimpleNamespace

import pytest

from conftest import ROOT  # noqa: F401  (puts the checkout on the path)
from gpubench import harness, idle_split
from gpubench.tracing import Trace

P = idle_split.PREFIX
WINDOW = (0.0, 100.0)  # microseconds
EVENTS = [("k1", 0.0, 10.0), ("k2", 20.0, 30.0), ("k1", 50.0, 91.0), ("k3", 93.0, 97.0)]
HARNESS = [("fit", 5.0, 95.0)]
PROGRAM = [(P + "fit", 6.0, 90.0), (P + "fit.prepare", 6.0, 8.0),
           (P + "fit.chunk", 8.0, 25.0), (P + "graph.replay", 9.0, 12.0),
           (P + "fit.chunk", 26.0, 29.0),
           (P + "fit.finish", 35.0, 60.0), (P + "fetch", 40.0, 49.0)]
# idle: [10, 20) [30, 50) [91, 93) [97, 100), by hand:
HAND = {P + "graph.replay": 2.0, P + "fit.chunk": 8.0, P + "fit": 5.0,
        P + "fit.finish": 6.0, P + "fetch": 9.0, "fit": 2.0, "harness": 3.0}


def trace() -> Trace:
    return Trace(list(EVENTS), list(HARNESS), WINDOW)


def readings(t: Trace) -> tuple:
    return t.busy_s, t.window_s, t.idle_gaps(), t.top_ops(), t.kernel_s(lambda n: n == "k1")


def test_split_by_hand():
    got = idle_split.split(trace(), PROGRAM)
    assert got == pytest.approx({n: v / 1e6 for n, v in HAND.items()})
    assert sum(got.values()) == pytest.approx(trace().window_s - trace().busy_s)


def test_split_without_program_spans_is_by_harness_span():
    got = idle_split.split(trace())
    assert got == pytest.approx({"fit": 32e-6, "harness": 3e-6})


def test_program_spans_leave_every_reading_unchanged():
    plain, spanned = trace(), trace()
    spanned.program_spans = list(PROGRAM)
    idle_split.split(spanned, spanned.program_spans)
    assert readings(spanned) == readings(plain)


def metric(name: str, t):
    return harness.metric_module(name).read(harness.Reading(t, {}, {}, {}))


def test_metrics_read_the_split():
    t = trace()
    t.program_spans = list(PROGRAM)
    host = metric("host_idle_share.train", t)
    assert host == pytest.approx(100.0 * (2 + 8 + 5 + 6) / 100)  # fetch and harness left out
    assert host <= metric("device_idle_share.train", t)
    assert metric("graph_replay_share.train", t) == pytest.approx(50.0)  # one of two chunks
    assert metric("host_idle_share.eval", t) is None  # no evaluate span
    assert metric("graph_replay_share.eval", t) is None


def test_metrics_read_nothing_without_program_spans():
    for name in ("host_idle_share.train", "host_idle_share.eval",
                 "graph_replay_share.train", "graph_replay_share.eval"):
        assert metric(name, trace()) is None
        assert metric(name, None) is None


def test_idle_inside_each_span():
    got = idle_split.idle_in(trace(), PROGRAM, P + "fit.chunk")
    assert got == pytest.approx([10e-6, 0.0])  # [10, 20) in the first chunk, none in the second


def test_program_spans_are_host_events_under_the_prefix():
    from torch.autograd import DeviceType

    def event(name, device_type, s, e):
        return SimpleNamespace(name=name, device_type=device_type,
                               time_range=SimpleNamespace(start=s, end=e))

    events = [event(P + "fit.chunk", DeviceType.CPU, 1.0, 2.0),
              event(P + "fit.chunk", DeviceType.CUDA, 1.5, 2.5),  # its device annotation
              event("fit", DeviceType.CPU, 0.0, 3.0),
              event("grad_rows", DeviceType.CUDA, 1.2, 1.4)]
    assert idle_split.program_spans(events) == [(P + "fit.chunk", 1.0, 2.0)]
