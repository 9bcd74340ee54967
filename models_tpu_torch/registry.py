"""String -> object registries (``models_tpu/registry.py``): the metric
registry, so that ``compile(metrics=["recall_at", ...])`` resolves names.
The block, loss, sampler, aggregation and top-k registries of the JAX
package have no user in the port yet."""

from __future__ import annotations

from typing import Any, Callable, Dict, Union


class Registry:
    """A name -> class or function registry."""

    def __init__(self, name: str):
        self.name = name
        self._store: Dict[str, Any] = {}

    def register(self, name: str) -> Callable:
        def deco(obj):
            self._store[name] = obj
            return obj

        return deco

    def __getitem__(self, name: str) -> Any:
        if name not in self._store:
            raise KeyError(
                f"{name!r} not registered in registry {self.name!r}. "
                f"Available: {sorted(self._store)}"
            )
        return self._store[name]

    def parse(self, value: Union[str, Any], **kwargs) -> Any:
        """Resolve a string to a constructed instance; pass through non-strings.
        A registered class is instantiated with ``**kwargs``; a registered
        function or object is returned as it is."""
        if isinstance(value, str):
            obj = self[value]
            if isinstance(obj, type):
                return obj(**kwargs)
            return obj
        return value


metric_registry = Registry("metrics")
