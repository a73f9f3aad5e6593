"""Metrics registry: counters, gauges and histograms behind one read path.

The port's slice of `paddle_tpu/obs/metrics.py`: the registry primitives,
the collector that absorbs the named `core.stats.EventCounter` groups and
the tracer's span counts, the serving failure-path counters the scheduler,
KV cache and session increment, the router tier's counters, and the
flat/Prometheus read paths, the resize-epoch and autoscaler counters, and
the master's fleet view: `snapshot()` is the flat dict a trainer
piggybacks on its heartbeat, `FleetMetrics` keeps one per trainer on the
master and `aggregate_snapshots` sums them, and `to_prometheus_text(fleet=)`
renders that aggregate. Metric names are the JAX package's, so one
dashboard reads either engine."""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Mapping, NamedTuple, Optional, Tuple

__all__ = [
    "Counter",
    "Histogram",
    "MetricsRegistry",
    "FleetMetrics",
    "Gauge",
    "REGISTRY",
    "Sample",
    "aggregate_snapshots",
    "observe_deadline_miss",
    "observe_engine_restart",
    "observe_late_result_dropped",
    "observe_pages_recycled",
    "observe_prefix_cow",
    "observe_prefix_evictions",
    "observe_prefix_hit",
    "observe_replica_evicted",
    "observe_replica_failover",
    "observe_resize",
    "observe_router_hedge",
    "observe_router_shed",
    "observe_scale_decision",
    "observe_scale_rejected",
    "observe_scale_suppressed",
    "observe_shed",
    "observe_takeover",
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


class Gauge(Counter):
    """Last-write-wins value; `set()` replaces, `inc()` still adjusts."""

    mtype = "gauge"

    def set(self, v: float, **labels: Any) -> None:
        with self._lock:
            self._vals[_labels(labels)] = float(v)


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

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

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

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


def _stats_collector() -> Iterable[Sample]:
    """Absorb core.stats: every registered EventCounter group, the StatSet
    timers and the shape-signature count."""
    from paddle_tpu_torch.core import stats

    for group, ec in stats.EVENT_COUNTERS.items():
        for event, n in sorted(ec.as_dict().items()):
            yield Sample(
                "paddle_tpu_events_total", "counter", float(n),
                (("event", event), ("group", group)),
            )
    for name, d in sorted(stats.GLOBAL_STATS.as_dict().items()):
        yield Sample(
            "paddle_tpu_timer_ms_total", "counter", float(d["total_ms"]),
            (("name", name),),
        )
        yield Sample(
            "paddle_tpu_timer_calls_total", "counter", float(d["count"]),
            (("name", name),),
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


def observe_resize(phase_seconds: Mapping[str, float]) -> None:
    """Record one completed elastic-resize epoch: bumps
    `paddle_tpu_resize_epochs_total` and adds each phase's seconds to
    `paddle_tpu_resize_latency_seconds_total{phase=...}`. Counters, not
    gauges: the master sums heartbeat snapshots key by key, so the fleet
    aggregate reads as total epochs and total seconds a phase."""
    REGISTRY.counter(
        "paddle_tpu_resize_epochs_total",
        "completed elastic resize epochs",
    ).inc()
    lat = REGISTRY.counter(
        "paddle_tpu_resize_latency_seconds_total",
        "elastic resize wall-clock by phase",
    )
    for phase, s in phase_seconds.items():
        lat.inc(float(s), phase=phase)


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


# -- the router tier: the JAX package's family and label names, so one
# Prometheus text reads both packages' fleets --------------------------------------


def observe_takeover(plane: str) -> None:
    """A warm standby took over a dead control plane (runtime/election.py);
    paired with the `<plane>_takeover` FT_EVENTS key."""
    REGISTRY.counter(
        "paddle_tpu_takeovers_total",
        "control-plane standby takeovers, by plane",
    ).inc(plane=plane)


def observe_replica_evicted(cause: str) -> None:
    """The router evicted a replica lease; cause is 'lease' (heartbeats
    stopped: death or a self-fenced wedge), 'conn' (dispatch/pump
    connections dead), 'deregister' or 'drain_timeout'."""
    REGISTRY.counter(
        "paddle_tpu_router_replica_evictions_total",
        "serving replicas evicted from the router fleet, by cause",
    ).inc(cause=cause)


def observe_replica_failover(cause: str) -> None:
    """One in-flight request re-submitted to a survivor after its replica
    was lost (token-identical: the pinned per-request seed)."""
    REGISTRY.counter(
        "paddle_tpu_router_failovers_total",
        "in-flight requests failed over to a surviving replica, by cause",
    ).inc(cause=cause)


def observe_router_hedge() -> None:
    """A token-less request past its TTFT hedge was duplicated onto a second
    replica (first token wins, the loser cancelled on its replica)."""
    REGISTRY.counter(
        "paddle_tpu_router_hedges_total",
        "cross-replica TTFT hedges launched by the router",
    ).inc()


def observe_late_result_dropped() -> None:
    """A replica answered a request the router had already delivered from a
    survivor: the late winner was dropped by the fleet dedup map."""
    REGISTRY.counter(
        "paddle_tpu_router_late_results_dropped_total",
        "late replica results dropped by the fleet (tenant, request) dedup",
    ).inc()


def observe_router_shed(reason: str) -> None:
    """The router shed a submit fleet-wide ('no_replicas', or 'overload'
    when every live replica shed or was saturated)."""
    REGISTRY.counter(
        "paddle_tpu_router_shed_total",
        "submits shed by the router fleet-wide, by named reason",
    ).inc(reason=reason)


def observe_scale_decision(lever: str, direction: str) -> None:
    """The autoscaler admitted one scale action past its hysteresis,
    cooldown and flap gates; lever 'serving' (spawn/drain) or 'train'
    (resize epoch), direction 'grow' or 'shrink'."""
    REGISTRY.counter(
        "paddle_tpu_autoscaler_decisions_total",
        "autoscaler scale actions admitted, by lever and direction",
    ).inc(lever=lever, direction=direction)


def observe_scale_suppressed(reason: str) -> None:
    """The decision engine wanted an action but a rate-limit gate held it:
    'startup', 'cooldown', 'flap' or 'backoff'."""
    REGISTRY.counter(
        "paddle_tpu_autoscaler_suppressed_total",
        "autoscaler actions suppressed by rate-limit gates, by reason",
    ).inc(reason=reason)


def observe_scale_rejected(lever: str) -> None:
    """A pulled lever refused the order (a resize the master rejected, or
    one that timed out): the backoff trigger."""
    REGISTRY.counter(
        "paddle_tpu_autoscaler_rejected_total",
        "autoscaler lever pulls rejected or timed out, by lever",
    ).inc(lever=lever)


# -- read paths -----------------------------------------------------------------


def _flat_key(s: Sample) -> str:
    if not s.labels:
        return s.name
    return s.name + "{" + ",".join(f"{k}={v}" for k, v in s.labels) + "}"


def snapshot(registry: Optional[MetricsRegistry] = None) -> Dict[str, float]:
    """Flat {key: value} view of every sample: the payload a trainer
    piggybacks on its master heartbeat."""
    return {
        _flat_key(s): s.value for s in (registry or REGISTRY).collect()
    }


def aggregate_snapshots(snaps: Iterable[Mapping[str, float]]) -> Dict[str, float]:
    """Sum per-trainer snapshots key by key; a value that is not a number
    is skipped."""
    out: Dict[str, float] = {}
    for snap in snaps:
        for k, v in snap.items():
            try:
                out[k] = out.get(k, 0.0) + float(v)
            except (TypeError, ValueError):
                continue
    return out


class FleetMetrics:
    """The master's store of per-trainer heartbeat snapshots. An entry
    expires `ttl_s` after its last heartbeat (a dead trainer's numbers must
    not inflate the fleet forever) and goes at once on deregister or
    eviction, with the lease."""

    def __init__(self, ttl_s: float = 60.0):
        self.ttl_s = float(ttl_s)
        self._lock = threading.Lock()
        self._by_id: Dict[str, Tuple[float, Dict[str, float]]] = {}

    def update(self, trainer_id: str, snap: Mapping[str, Any]) -> None:
        if not trainer_id or not isinstance(snap, Mapping):
            return
        clean = {
            str(k): float(v)
            for k, v in snap.items()
            if isinstance(v, (int, float))
        }
        with self._lock:
            self._by_id[trainer_id] = (time.monotonic(), clean)

    def drop(self, trainer_id: Optional[str]) -> None:
        if not trainer_id:
            return
        with self._lock:
            self._by_id.pop(trainer_id, None)

    def aggregate(self) -> Dict[str, Any]:
        cutoff = time.monotonic() - self.ttl_s
        with self._lock:
            live = {
                tid: snap
                for tid, (seen, snap) in self._by_id.items()
                if seen >= cutoff
            }
        return {
            "reporting_trainers": len(live),
            "counters": aggregate_snapshots(live.values()),
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


def to_prometheus_text(
    registry: Optional[MetricsRegistry] = None,
    fleet: Optional[Mapping[str, Any]] = None,
    extra: Optional[Mapping[str, float]] = None,
) -> str:
    """Render the registry (plus an optional fleet aggregate and flat extra
    gauges) in the Prometheus text exposition format."""
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
    if extra:
        for k, v in sorted(extra.items()):
            lines.append(f"# TYPE {k} gauge")
            lines.append(f"{k} {_fmt(v)}")
    if fleet:
        n = int(fleet.get("reporting_trainers", 0) or 0)
        lines.append("# TYPE paddle_tpu_fleet_reporting_trainers gauge")
        lines.append(f"paddle_tpu_fleet_reporting_trainers {n}")
        counters = fleet.get("counters") or {}
        if counters:
            lines.append("# TYPE paddle_tpu_fleet gauge")
            for k, v in sorted(counters.items()):
                lines.append(
                    f'paddle_tpu_fleet{{key="{_escape(str(k))}"}} '
                    f"{_fmt(v)}"
                )
    return "\n".join(lines) + "\n"
