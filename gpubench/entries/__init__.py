"""The entry drivers (``<entry>.py``, named by a traffic file's ``entry``):
each builds its cell's program from the seed in set-up, times its window,
traces a few calls where asked, and checks what the timed path produced
against the plain reference; each also offers its check's ``control``.
What they share is here."""

from __future__ import annotations

import gc
import sys
import time
from typing import Callable, List

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def memory_peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def release(device) -> None:
    """Free what the program held, before the reference runs."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def timed_calls(call: Callable[[], object], seconds: float) -> tuple:
    """Whole calls back to back until ``seconds`` have passed (each call
    ends on the host: a fetch, a synchronise, numpy). Returns (the window's
    wall seconds, each call's (start, end) on the ``perf_counter`` clock,
    the calls that raised)."""
    spans: List[tuple] = []
    failed = 0
    t0 = time.perf_counter()
    while True:
        start = time.perf_counter()
        try:
            call()
        except Exception as err:  # a failed call is counted, and fails the run
            failed += 1
            print(f"gpubench: a call in the window failed: {err!r}", file=sys.stderr, flush=True)
        end = time.perf_counter()
        spans.append((start, end))
        if end - t0 >= seconds:
            return end - t0, spans, failed
