"""Timers, runtime counters and profiler hooks (the port's copy of
`paddle_tpu/core/stats.py`).

- `Stat` / `StatSet` / `GLOBAL_STATS`, `timer` and `TimerOnce`: the
  reference's utils/Stat.h timers, off unless PADDLE_TPU_TIMER is set (or
  `enable_timers()`): a disabled timer costs one truth test.
- `EventCounter` groups registered by name for the metrics exporter
  (`FT_EVENTS`, `DATA_EVENTS`), unconditional: failure telemetry must not
  hide behind a switch.
- The shape-signature counter (`RecompileStats` + `batch_signature`) behind
  the serving session's one-decode-signature gate.
- `tensor_bytes` (resident bytes of tensors on one card) and
  `device_memory_stats` (`torch.cuda.memory_stats`).
- `profiler_start` / `profiler_stop` / `profile_region`: idempotent
  wrappers over `torch.profiler` (the JAX package's wrap jax.profiler).
  There is no compilation cache to listen to."""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from typing import Any, Dict, Iterable, Iterator, Optional

import numpy as np

class Stat:
    """Accumulates wall time and call count for one named timer (Stat.h:114)."""

    __slots__ = ("name", "total", "count", "max")

    def __init__(self, name: str):
        self.name = name
        self.total = 0.0
        self.count = 0
        self.max = 0.0

    def add(self, seconds: float) -> None:
        self.total += seconds
        self.count += 1
        if seconds > self.max:
            self.max = seconds

    def __repr__(self):
        avg = self.total / max(self.count, 1)
        return (
            f"{self.name}: total={self.total * 1e3:.2f}ms count={self.count} "
            f"avg={avg * 1e3:.3f}ms max={self.max * 1e3:.3f}ms"
        )


class StatSet:
    """Registry of Stats (Stat.h:63 StatSet)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stats: Dict[str, Stat] = {}
        self.enabled = os.environ.get("PADDLE_TPU_TIMER", "").lower() not in (
            "", "0", "false", "off",
        )

    def get(self, name: str) -> Stat:
        with self._lock:
            s = self._stats.get(name)
            if s is None:
                s = self._stats[name] = Stat(name)
            return s

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()

    def report(self) -> str:
        # total descending, then name, with a percent-of-total column, so
        # equal totals print in one order on every run
        with self._lock:
            stats = sorted(self._stats.values(), key=lambda s: (-s.total, s.name))
        grand = sum(s.total for s in stats)
        lines = ["======= StatSet: [GlobalStatInfo] status ======"]
        lines += [
            f"  {s!r} ({100.0 * s.total / grand if grand else 0.0:5.1f}%)"
            for s in stats
        ]
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                n: {"total_ms": s.total * 1e3, "count": s.count, "max_ms": s.max * 1e3}
                for n, s in self._stats.items()
            }


GLOBAL_STATS = StatSet()


def enable_timers(on: bool = True) -> None:
    GLOBAL_STATS.enabled = on


@contextlib.contextmanager
def timer(name: str) -> Iterator[None]:
    """REGISTER_TIMER_INFO analog: `with timer("forwardBackward"): ...`."""
    if not GLOBAL_STATS.enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        GLOBAL_STATS.get(name).add(time.perf_counter() - t0)


class TimerOnce:
    """Stat.h:189 TimerOnce: the manual start/stop form."""

    def __init__(self, name: str):
        self.name = name
        self._t0: Optional[float] = None

    def start(self) -> "TimerOnce":
        self._t0 = time.perf_counter()
        return self

    def stop(self) -> None:
        if self._t0 is not None and GLOBAL_STATS.enabled:
            GLOBAL_STATS.get(self.name).add(time.perf_counter() - self._t0)
        self._t0 = None


# every NAMED EventCounter registers here so the observability plane
# (obs/metrics.py) can absorb them behind one read interface without
# touching their hot-path increment cost
EVENT_COUNTERS: Dict[str, "EventCounter"] = {}


class EventCounter:
    """Thread-safe named counters for rare-but-load-bearing runtime events.
    Unconditional: failure telemetry must not hide behind a switch.

    A `name` registers the counter group in EVENT_COUNTERS for the metrics
    exporter; anonymous counters stay private."""

    def __init__(self, name: Optional[str] = None):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self.name = name
        if name:
            EVENT_COUNTERS[name] = self

    def incr(self, name: str, n: int = 1) -> int:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n
            return self._counts[name]

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def as_dict(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()


# fault-tolerance events: RPC client reconnects and endpoint failovers,
# lease evictions, resize epochs, standby takeovers
FT_EVENTS = EventCounter("ft")

# data-path events that are normal but worth counting
DATA_EVENTS = EventCounter("data")


def tensor_bytes(tensors: Iterable) -> int:
    """Bytes the given tensors hold on their device (one card: no shards)."""
    return sum(int(t.numel()) * t.element_size() for t in tensors)


def device_memory_stats(device: Any = None) -> Dict[str, int]:
    """`torch.cuda.memory_stats` of the card (bytes in use, peaks, ...),
    numeric entries only; {} without a card."""
    import torch

    if not torch.cuda.is_available():
        return {}
    try:
        raw = torch.cuda.memory_stats(device)
    except RuntimeError:
        return {}
    return {k: int(v) for k, v in raw.items() if isinstance(v, (int, float))}


# -- shape-signature telemetry -------------------------------------------------
#
# The JAX engine compiles one executable per input signature, so a second
# decode signature is a recompile. The port runs eagerly, but the same gate
# keeps the decode step at one fixed shape — the precondition for capturing
# it as one CUDA graph later.


def batch_signature(batch) -> tuple:
    """Hashable shape/dtype signature of a dict of arrays or tensors."""
    return tuple(
        sorted(
            (k, tuple(np.shape(v)), str(getattr(v, "dtype", type(v).__name__)))
            for k, v in batch.items()
        )
    )


class RecompileStats:
    """Counts distinct input signatures; warns once at `warn_threshold`."""

    def __init__(self, warn_threshold: int = 0):
        self._lock = threading.Lock()
        self._all: set = set()
        self._warned = False
        self.warn_threshold = warn_threshold or int(
            os.environ.get("PADDLE_TPU_SHAPE_WARN", "8")
        )

    def record(self, signature: tuple) -> bool:
        """Record one signature; True when it was not seen before."""
        with self._lock:
            new = signature not in self._all
            self._all.add(signature)
            n = len(self._all)
            should_warn = new and not self._warned and n == self.warn_threshold
            if should_warn:
                self._warned = True
        if should_warn:
            logging.getLogger("paddle_tpu_torch.stats").warning(
                "%d distinct input shapes; a fixed-shape step is expected to "
                "see one", n,
            )
        return new

    def total_signatures(self) -> int:
        with self._lock:
            return len(self._all)


# -- the device profiler (hl_profiler_start/end -> torch.profiler) -------------
#
# Idempotent on purpose: a second start while a trace runs, or a stop
# without a start, must degrade to a warning, not kill training.

_profiler: Optional[Any] = None
_profiler_dir: Optional[str] = None


def profiler_start(logdir: str) -> None:
    """Start a torch.profiler trace (CPU activity, and CUDA's where a card
    is present) that `profiler_stop` writes under `logdir` as a Chrome
    trace. A second start while one is active warns and does nothing."""
    global _profiler, _profiler_dir
    import torch

    if _profiler is not None:
        logging.getLogger("paddle_tpu_torch.stats").warning(
            "profiler_start: a trace is already active; ignoring the second "
            "start (stop the first with profiler_stop())")
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _profiler, _profiler_dir = prof, logdir


def profiler_stop() -> Optional[Any]:
    """Stop the active trace and write it to `<logdir>/trace.json`;
    returns the profiler (for its events), or None when none was active."""
    global _profiler, _profiler_dir
    prof, logdir = _profiler, _profiler_dir
    if prof is None:
        return None
    _profiler, _profiler_dir = None, None
    prof.__exit__(None, None, None)
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    return prof


@contextlib.contextmanager
def profile_region(name: str) -> Iterator[None]:
    """Named range inside a profiler capture."""
    import torch

    with torch.profiler.record_function(name):
        yield
