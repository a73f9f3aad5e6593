"""Training events (counterpart of `paddle_tpu/trainer/events.py`).

`EndIteration.cost` and `.metrics` are lazy: the trainer hands them the
device tensors (the step's cost, and the values of the trainer's
`extra_outputs`), and the host waits for the card only when a handler reads
them. `EndPass.metrics` carries `avg_cost`, `batches` (steps whose update
landed), `pass_seconds`, `divergence_events` (steps the divergence guard
reverted this pass) and, with a test reader, `test_cost`."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch


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
    """End of one dispatch: one step, or the K-step window of
    `train(steps_per_dispatch=K)`, with batch_id its last batch and cost
    its last step's cost. Reading `.cost` or `.metrics` synchronises with
    the device (once; the values are cached). With a divergence policy and
    guard_check_every > 1, a poisoned step's event is delivered and its
    `.cost` reads NaN/Inf (the host learns of the divergence at the next
    guard poll); with guard_check_every=1 such a step fires no event."""

    __slots__ = ("pass_id", "batch_id", "_cost", "_metrics", "_metrics_np")

    def __init__(self, pass_id: int, batch_id: int, cost: Any,
                 metrics: Optional[Dict[str, Any]] = None):
        self.pass_id = pass_id
        self.batch_id = batch_id
        self._cost = cost
        self._metrics = metrics or {}
        self._metrics_np: Optional[Dict[str, np.ndarray]] = None

    @property
    def cost(self) -> float:
        if not isinstance(self._cost, float):
            self._cost = float(self._cost)
        return self._cost

    @property
    def raw_metrics(self) -> Dict[str, Any]:
        """The extra outputs' values as the trainer handed them (device
        tensors on the card), without a sync."""
        return self._metrics

    @property
    def metrics(self) -> Dict[str, np.ndarray]:
        """The extra outputs' values as host arrays."""
        if self._metrics_np is None:
            self._metrics_np = {
                k: v.detach().float().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v) for k, v in self._metrics.items()}
        return self._metrics_np

    def __repr__(self) -> str:
        return f"EndIteration(pass_id={self.pass_id}, batch_id={self.batch_id}, cost=<lazy>)"
