"""Name -> factory registries (a copy of `fedml_tpu/core/registry.py`).

Models, datasets and federated optimizers are looked up by the names the
configuration uses, so user code can register its own without forking
the package.
"""
from __future__ import annotations

from typing import Callable, Dict, Generic, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, T] = {}

    def register(self, name: str) -> Callable[[T], T]:
        def deco(obj: T) -> T:
            key = name.lower()
            if key in self._items:
                raise KeyError(f"{self.kind} {name!r} already registered")
            self._items[key] = obj
            return obj

        return deco

    def get(self, name: str) -> T:
        key = name.lower()
        if key not in self._items:
            raise KeyError(
                f"unknown {self.kind} {name!r}; available: {sorted(self._items)}"
            )
        return self._items[key]

    def __contains__(self, name: str) -> bool:
        return name.lower() in self._items

    def names(self) -> list[str]:
        return sorted(self._items)


MODELS: Registry = Registry("model")
DATASETS: Registry = Registry("dataset")
ALGORITHMS: Registry = Registry("federated_optimizer")
