"""String -> factory registries (the port's copy of
`paddle_tpu/core/registry.py`): the analog of the reference's
``ClassRegistrar`` (paddle/utils/ClassRegistrar.h), backing the evaluator
registry (gserver/evaluators/Evaluator.h:32) among others.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional, Tuple


class Registry:
    """A named string→factory map with decorator-style registration."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Any] = {}

    def register(self, *names: str) -> Callable[[Any], Any]:
        def deco(obj: Any) -> Any:
            for name in names:
                if name in self._entries:
                    raise KeyError(f"{self.kind} {name!r} already registered")
                self._entries[name] = obj
            return obj

        return deco

    def get(self, name: str) -> Any:
        try:
            return self._entries[name]
        except KeyError:
            known = ", ".join(sorted(self._entries))
            raise KeyError(f"unknown {self.kind} {name!r}; known: {known}") from None

    def maybe_get(self, name: str) -> Optional[Any]:
        return self._entries.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def items(self) -> Iterator[Tuple[str, Any]]:
        return iter(self._entries.items())

    def names(self):
        return sorted(self._entries)


LAYERS = Registry("layer")
ACTIVATIONS = Registry("activation")
EVALUATORS = Registry("evaluator")
DATA_PROVIDERS = Registry("data provider")
OPTIMIZERS = Registry("optimizer")
LR_SCHEDULES = Registry("learning-rate schedule")
