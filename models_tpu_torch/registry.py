"""String -> object registries (``models_tpu/registry.py``): losses,
metrics, samplers, aggregations, blocks and top-k layers referred to by
short snake-case names (``"concat"``, ``"no-op"``, ``"recall_at"``, ...).
``TabularAggregation.parse`` and the blocks' string arguments resolve
through them."""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Union


def camelcase_to_snakecase(name: str) -> str:
    s1 = re.sub(r"(.)([A-Z][a-z]+)", r"\1_\2", name)
    return re.sub(r"([a-z0-9])([A-Z])", r"\1_\2", s1).lower()


def default_name(obj: Any) -> str:
    name = obj.__name__ if hasattr(obj, "__name__") else type(obj).__name__
    return camelcase_to_snakecase(name)


class Registry:
    """A name -> class or function registry, with several names for one
    entry and parsing of a name into an instance."""

    _registries: Dict[str, "Registry"] = {}

    def __init__(self, name: str):
        self.name = name
        self._store: Dict[str, Any] = {}

    @classmethod
    def class_registry(cls, name: str) -> "Registry":
        if name not in cls._registries:
            cls._registries[name] = cls(name)
        return cls._registries[name]

    def register(self, name: Optional[str] = None) -> Callable:
        def deco(obj):
            self._store[name or default_name(obj)] = obj
            return obj

        return deco

    def register_with_multiple_names(self, *names: str) -> Callable:
        def deco(obj):
            for key in list(names) or [default_name(obj)]:
                self._store[key] = obj
            return obj

        return deco

    def __contains__(self, name: str) -> bool:
        return name in self._store

    def __getitem__(self, name: str) -> Any:
        if name not in self._store:
            raise KeyError(
                f"{name!r} not registered in registry {self.name!r}. "
                f"Available: {sorted(self._store)}"
            )
        return self._store[name]

    def get(self, name: str, default=None) -> Any:
        return self._store.get(name, default)

    def keys(self) -> List[str]:
        return sorted(self._store)

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


block_registry = Registry.class_registry("blocks")
loss_registry = Registry.class_registry("losses")
metric_registry = Registry.class_registry("metrics")
sampler_registry = Registry.class_registry("samplers")
aggregation_registry = Registry.class_registry("aggregations")
topk_registry = Registry.class_registry("topk_layers")
