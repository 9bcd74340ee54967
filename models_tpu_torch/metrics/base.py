"""Metric protocol (``models_tpu/metrics/base.py``): streaming metrics with an
explicit state.

A metric owns a small dictionary of tensors, its ``state``: ``init_state``
makes it on a device, ``update`` returns the next one from a batch's outputs
and targets without reading anything back to the host, and ``result`` gives
the final value as a tensor. The engine copies every result of an epoch to
the host at once. AUC, LogLoss and the other metrics of the JAX module wait
for the ranking slice (ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import Optional, Union

from ..registry import metric_registry


class Metric:
    name: str = "metric"

    def __init__(self, name: Optional[str] = None):
        if name:
            self.name = name

    def init_state(self, device=None):
        raise NotImplementedError

    def update(self, state, outputs, targets, sample_weight=None):
        raise NotImplementedError

    def result(self, state):
        raise NotImplementedError

    @staticmethod
    def parse(m: Union[str, "Metric"]) -> "Metric":
        if isinstance(m, Metric):
            return m
        return metric_registry.parse(m)
