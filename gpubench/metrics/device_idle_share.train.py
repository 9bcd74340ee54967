"""device_idle_share.train: the share of the traced window in which no
kernel, copy or set ran on the card (the union of their intervals,
``gpubench/tracing.py``)."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
