"""Metrics registry: counters, gauges and histograms behind one read path.

The port's slice of `paddle_tpu/obs/metrics.py`: the registry primitives,
the collector that absorbs the named `core.stats.EventCounter` groups and
the tracer's span counts, the serving failure-path counters the scheduler,
KV cache and session increment, and the flat/Prometheus read paths. Metric
names are the JAX package's, so one dashboard reads either engine. The
fleet, router and autoscaler counters wait for the slice that ports them."""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Iterable, List, Mapping, NamedTuple, Optional, Tuple

__all__ = [
    "Counter",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "Sample",
    "observe_deadline_miss",
    "observe_engine_restart",
    "observe_pages_recycled",
    "observe_prefix_cow",
    "observe_prefix_evictions",
    "observe_prefix_hit",
    "observe_shed",
    "snapshot",
    "to_prometheus_text",
]


class Sample(NamedTuple):
    name: str
    mtype: str  # counter | gauge | histogram-derived
    value: float
    labels: Tuple[Tuple[str, str], ...] = ()


def _labels(kw: Mapping[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in kw.items()))


class Counter:
    """Monotonic counter; one value per label set."""

    mtype = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._lock = threading.Lock()
        self._vals: Dict[tuple, float] = {}

    def inc(self, n: float = 1.0, **labels: Any) -> None:
        key = _labels(labels)
        with self._lock:
            self._vals[key] = self._vals.get(key, 0.0) + n

    def value(self, **labels: Any) -> float:
        with self._lock:
            return self._vals.get(_labels(labels), 0.0)

    def samples(self) -> Iterable[Sample]:
        with self._lock:
            items = list(self._vals.items())
        for key, v in items or [((), 0.0)]:
            yield Sample(self.name, self.mtype, v, key)


class Histogram:
    """Fixed-bucket histogram (cumulative counts, Prometheus convention)."""

    mtype = "histogram"
    DEFAULT_BUCKETS = (
        0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
    )

    def __init__(self, name: str, help: str = "", buckets: Optional[Iterable[float]] = None):
        self.name, self.help = name, help
        self.buckets = tuple(sorted(buckets or self.DEFAULT_BUCKETS))
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # +inf tail
        self._sum = 0.0
        self._n = 0

    def observe(self, v: float) -> None:
        with self._lock:
            self._sum += v
            self._n += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def samples(self) -> Iterable[Sample]:
        with self._lock:
            counts, total, n = list(self._counts), self._sum, self._n
        cum = 0
        for b, c in zip(self.buckets, counts):
            cum += c
            yield Sample(
                f"{self.name}_bucket", "counter", float(cum), (("le", repr(b)),)
            )
        yield Sample(f"{self.name}_bucket", "counter", float(n), (("le", "+Inf"),))
        yield Sample(f"{self.name}_sum", "counter", total)
        yield Sample(f"{self.name}_count", "counter", float(n))


class MetricsRegistry:
    """Named metrics + pluggable collectors over pre-existing stats objects."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}
        self._collectors: List[Callable[[], Iterable[Sample]]] = []

    def _get(self, cls, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {type(m).__name__}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def histogram(self, name: str, help: str = "", buckets=None) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def register_collector(self, fn: Callable[[], Iterable[Sample]]) -> None:
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def collect(self) -> List[Sample]:
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors)
        out: List[Sample] = []
        for m in metrics:
            out.extend(m.samples())
        for fn in collectors:
            out.extend(fn())
        return out


def _stats_collector() -> Iterable[Sample]:
    """Absorb every registered core.stats EventCounter group."""
    from paddle_tpu_torch.core import stats

    for group, ec in stats.EVENT_COUNTERS.items():
        for event, n in sorted(ec.as_dict().items()):
            yield Sample(
                "paddle_tpu_events_total", "counter", float(n),
                (("event", event), ("group", group)),
            )


def _trace_collector() -> Iterable[Sample]:
    from paddle_tpu_torch.obs import trace

    yield Sample(
        "paddle_tpu_trace_spans_recorded_total", "counter",
        float(trace.TRACER.recorded),
    )
    yield Sample(
        "paddle_tpu_trace_spans_dropped_total", "counter",
        float(trace.TRACER.dropped),
    )


REGISTRY = MetricsRegistry()
REGISTRY.register_collector(_stats_collector)
REGISTRY.register_collector(_trace_collector)


# -- serving failure-path counters ---------------------------------------------
#
# One naming authority, so the scheduler/session/cache increment the same
# metrics a reader of either engine expects. All counters (never gauges).


def observe_deadline_miss(kind: str) -> None:
    """One request missed a deadline; kind is 'ttft' (first token landed
    late — the client-hedging signal) or 'total' (request cancelled)."""
    REGISTRY.counter(
        "paddle_tpu_serving_deadline_misses_total",
        "serving requests past a deadline, by kind (ttft|total)",
    ).inc(kind=kind)


def observe_shed(reason: str) -> None:
    """One request rejected by load shedding (queue bound, already-expired
    deadline, or load-aware overload check) — the named reason matches the
    QuotaExceeded the caller saw."""
    REGISTRY.counter(
        "paddle_tpu_serving_shed_total",
        "serving requests shed at admission, by named reason",
    ).inc(reason=reason)


def observe_engine_restart(cause: str) -> None:
    """The serving supervisor restarted the decode engine; cause is 'fault'
    (engine thread raised) or 'stall' (no step progress past the watchdog)."""
    REGISTRY.counter(
        "paddle_tpu_serving_engine_restarts_total",
        "serving engine restarts by the session supervisor, by cause",
    ).inc(cause=cause)


def observe_pages_recycled(n: int) -> None:
    """KV pages returned to the free list by a cancellation (deadline expiry
    or client abandonment), as opposed to normal retirement."""
    REGISTRY.counter(
        "paddle_tpu_serving_pages_recycled_on_cancel_total",
        "KV pages recycled from cancelled (not normally retired) requests",
    ).inc(n)


def observe_prefix_hit(pages: int) -> None:
    """An admission aliased `pages` cached prefix pages into a new slot's
    block table — each page is prefill work the request skipped."""
    REGISTRY.counter(
        "paddle_tpu_serving_prefix_pages_shared_total",
        "KV pages aliased from the shared-prefix cache into new slots",
    ).inc(pages)


def observe_prefix_cow(n: int) -> None:
    """Prefix lookups that stopped at a genuine divergence — the
    copy-on-write boundary where the request switches to a private page."""
    REGISTRY.counter(
        "paddle_tpu_serving_prefix_cow_total",
        "prefix-cache lookups ending at a copy-on-write divergence",
    ).inc(n)


def observe_prefix_evictions(n: int) -> None:
    """Unreferenced cached prefix pages LRU-evicted — under pool pressure at
    reserve time, or by the prefix_cache_pages cap at registration."""
    REGISTRY.counter(
        "paddle_tpu_serving_prefix_evictions_total",
        "prefix-cache pages evicted (pool pressure or cache-size cap)",
    ).inc(n)


# -- read paths -----------------------------------------------------------------


def _flat_key(s: Sample) -> str:
    if not s.labels:
        return s.name
    return s.name + "{" + ",".join(f"{k}={v}" for k, v in s.labels) + "}"


def snapshot(registry: Optional[MetricsRegistry] = None) -> Dict[str, float]:
    """Flat {key: value} view of every sample."""
    return {
        _flat_key(s): s.value for s in (registry or REGISTRY).collect()
    }


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _fmt(v: float) -> str:
    """Lossless value formatting: integral values print as integers, the
    rest with full float precision (%g would truncate large counters)."""
    f = float(v)
    if f.is_integer() and abs(f) < 2**53:
        return str(int(f))
    return repr(f)


def to_prometheus_text(registry: Optional[MetricsRegistry] = None) -> str:
    """Render the registry in the Prometheus text exposition format."""
    samples = (registry or REGISTRY).collect()
    by_name: Dict[str, List[Sample]] = {}
    types: Dict[str, str] = {}
    for s in samples:
        by_name.setdefault(s.name, []).append(s)
        types.setdefault(s.name, "counter" if s.mtype == "counter" else s.mtype)
    lines: List[str] = []
    for name in sorted(by_name):
        lines.append(f"# TYPE {name} {types[name]}")
        for s in by_name[name]:
            if s.labels:
                lab = ",".join(f'{k}="{_escape(v)}"' for k, v in s.labels)
                lines.append(f"{name}{{{lab}}} {_fmt(s.value)}")
            else:
                lines.append(f"{name} {_fmt(s.value)}")
    return "\n".join(lines) + "\n"
