"""Small utilities (``models_tpu/utils/misc.py``)."""

from __future__ import annotations

import time
from contextlib import contextmanager


@contextmanager
def Timing(label: str = "", log_fn=print):
    """Time the block on the host clock: yields a dict whose ``seconds`` is
    set on exit, and passes ``"<label>: <seconds>s"`` to ``log_fn`` where a
    label is given. Work queued on the card is not waited for: synchronise
    inside the block to time it."""
    t0 = time.perf_counter()
    result = {"seconds": None}
    try:
        yield result
    finally:
        result["seconds"] = time.perf_counter() - t0
        if label:
            log_fn(f"{label}: {result['seconds']:.3f}s")
