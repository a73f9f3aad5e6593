"""Training events (counterpart of `paddle_tpu/trainer/events.py`).

`EndIteration.cost` is lazy: the trainer hands it the cost tensor, and the
host waits for the card only when a handler reads `.cost`."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict


@dataclasses.dataclass
class BeginPass:
    pass_id: int


@dataclasses.dataclass
class EndPass:
    pass_id: int
    metrics: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class BeginIteration:
    pass_id: int
    batch_id: int


class EndIteration:
    """End of one training step. Reading `.cost` synchronises with the
    device (once; the float is cached)."""

    __slots__ = ("pass_id", "batch_id", "_cost")

    def __init__(self, pass_id: int, batch_id: int, cost: Any):
        self.pass_id = pass_id
        self.batch_id = batch_id
        self._cost = cost

    @property
    def cost(self) -> float:
        if not isinstance(self._cost, float):
            self._cost = float(self._cost)
        return self._cost

    def __repr__(self) -> str:
        return f"EndIteration(pass_id={self.pass_id}, batch_id={self.batch_id}, cost=<lazy>)"
