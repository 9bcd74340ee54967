"""The protocol every model of the port satisfies (``models_tpu/api.py``):
the engine's models, the torch side-backend's, and the host engines of
``xgb.py`` and ``baselines.py`` all have ``fit / evaluate / predict /
save``."""

from __future__ import annotations

from typing import Any, Dict, Protocol, runtime_checkable


@runtime_checkable
class MerlinModel(Protocol):
    def fit(self, dataset, **kwargs) -> Any: ...

    def evaluate(self, dataset, **kwargs) -> Dict[str, float]: ...

    def predict(self, dataset, **kwargs) -> Any: ...

    def save(self, path: str) -> Any: ...
