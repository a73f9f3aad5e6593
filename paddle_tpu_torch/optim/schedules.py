"""Learning-rate schedules (counterpart of `paddle_tpu/optim/schedules.py`):
the constant schedule that `build(lr)` gives by default. A schedule maps the
number of samples processed so far to the lr; the other v1 schedules are
not ported yet (ROADMAP.md)."""

from __future__ import annotations

from typing import Callable

Schedule = Callable[[int], float]


def build(learning_rate: float) -> Schedule:
    """lr(samples_processed) of the constant schedule."""
    return lambda samples: learning_rate
