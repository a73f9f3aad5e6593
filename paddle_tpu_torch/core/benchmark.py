"""Shared step-timing harness (counterpart of `paddle_tpu/core/benchmark.py`).

The execution barrier is a VALUE fetch (`float(cost)`, a `.item()` of the
last step's cost), on the CUDA device too: it forces the whole dependent
chain of steps, where a stream synchronize would also wait for work that is
not the step's. The port's trainer updates its state in place, so a step
callable for these timers is `lambda state, batch: (state,
trainer.step(batch), {})` (`multi`: `lambda state, batches: (state,
trainer.multi_step(batches))`)."""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Tuple

import numpy as np


def time_train_steps(
    step: Callable,
    state: Any,
    batch: Dict[str, Any],
    steps: int = 10,
    warmup: int = 2,
) -> Tuple[float, Any]:
    """Returns (seconds_per_step, final_state). `step(state, batch)` must
    return (new_state, cost_scalar, extras)."""
    for _ in range(max(warmup, 1)):
        state, cost, _ = step(state, batch)
    cost_v = float(cost)  # barrier: forces the build, capture and warm-up chain
    assert np.isfinite(cost_v), f"non-finite cost during warmup: {cost_v}"

    t0 = time.perf_counter()
    for _ in range(steps):
        state, cost, _ = step(state, batch)
    final = float(cost)  # barrier: forces the timed chain
    dt = time.perf_counter() - t0
    assert np.isfinite(final), f"non-finite cost during timing: {final}"
    return dt / steps, state


def time_multi_steps(
    multi: Callable,
    state: Any,
    batches: Dict[str, Any],
    k: int,
    dispatches: int = 4,
    warmup: int = 1,
) -> Tuple[float, Any]:
    """Times a K-step dispatch (`SGDTrainer.multi_step`): each dispatch
    runs `k` train steps. `multi(state, batches)` returns (new_state,
    costs). Returns (seconds_per_step, final_state); the barrier is a value
    fetch of the dispatch's last cost."""
    for _ in range(max(warmup, 1)):
        state, costs = multi(state, batches)
    warm = float(_last(costs))
    assert np.isfinite(warm), f"non-finite cost during warmup: {warm}"

    t0 = time.perf_counter()
    for _ in range(dispatches):
        state, costs = multi(state, batches)
    final = float(_last(costs))
    dt = time.perf_counter() - t0
    assert np.isfinite(final), f"non-finite cost during timing: {final}"
    return dt / (dispatches * k), state


def _last(costs: Any) -> Any:
    """The last of a dispatch's costs (a scalar stands for itself)."""
    if hasattr(costs, "dim") and costs.dim() == 0:
        return costs
    return costs[-1]
