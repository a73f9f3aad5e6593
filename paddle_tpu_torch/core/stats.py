"""Runtime counters the serving engine keeps.

The port's slice of `paddle_tpu/core/stats.py`: the unconditional event
counters (`EventCounter`, registered by name for the metrics exporter), the
shape-signature counter (`RecompileStats` + `batch_signature`) behind the
session's one-decode-signature gate, and a byte count of resident tensors.
The JAX package's timers, compile-cache listener and jax.profiler hooks wait
for the training slices."""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, Iterable, Optional

import numpy as np

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


# fault-tolerance events: RPC client reconnects and endpoint failovers,
# tenant-lease evictions
FT_EVENTS = EventCounter("ft")


def tensor_bytes(tensors: Iterable) -> int:
    """Bytes the given tensors hold on their device (one card: no shards)."""
    return sum(int(t.numel()) * t.element_size() for t in tensors)


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
