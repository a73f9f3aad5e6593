"""Structured tracing: spans in a bounded per-process ring buffer.

The port's copy of `paddle_tpu/obs/trace.py` (pure host code; the same
PADDLE_TPU_TRACE switch turns it on).

One request or one training step crosses several threads (RPC handler,
serving engine, prefetch worker) and several PROCESSES (trainer → master →
standby; serving client → server); per-subsystem timers cannot say "this 40 ms belonged to THAT request". A span fixes that: a named
interval carrying (trace_id, span_id, parent_id, wall-clock, attrs), recorded
into a fixed-size ring so a long-lived server never grows, and exported as
Chrome trace-event JSON loadable in Perfetto (chrome://tracing).

Gating discipline matches the JAX package's PADDLE_TPU_TIMER: tracing is off
unless PADDLE_TPU_TRACE is set / enable_tracing() is called, and a disabled
`span()` costs one attribute lookup + a truth test — it returns a shared
no-op context manager, builds no strings, and takes no locks. Hot loops
(train dispatch, serving decode) therefore stamp spans unconditionally and
keep file I/O and unconditional string formatting out of them (the JAX
package's tests/test_lint_hotloop.py pins its copy's sites).

Cross-process correlation: `wire_context()` serializes the current span as a
tiny {"t": trace_id, "s": span_id} dict that rides on the line-JSON RPC
frames (runtime/master.py, serving/server.py); the receiving side re-enters
it with `activate()`, so its spans join the caller's trace id. Each process
exports its own ring (`export_chrome()` / the `trace_export` RPC) and the
events stitch on trace_id — same trace, different pid rows in Perfetto."""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "TRACER",
    "Tracer",
    "activate",
    "enable_tracing",
    "export_chrome",
    "record_span",
    "reset",
    "span",
    "wire_context",
]

# wall-clock microseconds: Chrome trace `ts` unit, and shared across processes
# so client/server spans of one RPC line up on a common axis
_now_us = lambda: time.time_ns() // 1000  # noqa: E731

_REQUIRED_EVENT_KEYS = ("ph", "ts", "pid", "tid", "name")  # golden-format keys


class Tracer:
    """Span recorder: enabled flag + ring buffer + per-thread context stack."""

    def __init__(self, capacity: Optional[int] = None):
        self.enabled = os.environ.get("PADDLE_TPU_TRACE", "").lower() not in (
            "", "0", "false", "off",
        )
        self.capacity = capacity or int(
            os.environ.get("PADDLE_TPU_TRACE_BUF", "8192")
        )
        self._lock = threading.Lock()
        self._ring: List[Optional[tuple]] = [None] * self.capacity
        self._head = 0  # next write index
        self._recorded = 0  # total spans ever recorded (ring may have dropped)
        self._tls = threading.local()
        # span ids are "<pid hex>.<n>": unique within a trace even when a
        # client and a forked server both mint ids
        self._ids = itertools.count(1)
        self._pid_tag = f"{os.getpid():x}"

    # -- context stack (thread-local) ---------------------------------------
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current(self) -> Optional[Tuple[str, str]]:
        """(trace_id, span_id) of the innermost open span on this thread."""
        st = getattr(self._tls, "stack", None)
        return st[-1] if st else None

    def new_span_id(self) -> str:
        return f"{self._pid_tag}.{next(self._ids)}"

    def new_trace_id(self) -> str:
        return os.urandom(8).hex()

    # -- recording ----------------------------------------------------------
    def record(
        self,
        name: str,
        t0_us: int,
        dur_us: int,
        trace_id: str,
        span_id: str,
        parent_id: Optional[str],
        attrs: Optional[Dict[str, Any]],
    ) -> None:
        row = (
            name, int(t0_us), int(dur_us), trace_id, span_id, parent_id,
            attrs, threading.get_ident(),
        )
        with self._lock:
            self._ring[self._head] = row
            self._head = (self._head + 1) % self.capacity
            self._recorded += 1

    def snapshot(self) -> List[tuple]:
        """Buffered spans, oldest first (ring order)."""
        with self._lock:
            if self._recorded < self.capacity:
                return [r for r in self._ring[: self._head] if r is not None]
            return [
                r
                for r in self._ring[self._head:] + self._ring[: self._head]
                if r is not None
            ]

    @property
    def recorded(self) -> int:
        return self._recorded

    @property
    def dropped(self) -> int:
        return max(0, self._recorded - self.capacity)

    def reset(self) -> None:
        with self._lock:
            self._ring = [None] * self.capacity
            self._head = 0
            self._recorded = 0


TRACER = Tracer()


def enable_tracing(on: bool = True) -> None:
    TRACER.enabled = on


def reset() -> None:
    TRACER.reset()


# -- span APIs ---------------------------------------------------------------


class _NullSpan:
    """Shared no-op context manager: the entire disabled-path cost."""

    __slots__ = ()
    trace_id = span_id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _LiveSpan:
    __slots__ = ("name", "attrs", "trace_id", "span_id", "parent_id", "_t0")

    def __init__(self, name: str, attrs: Optional[Dict[str, Any]]):
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "_LiveSpan":
        parent = TRACER.current()
        if parent is None:
            self.trace_id, self.parent_id = TRACER.new_trace_id(), None
        else:
            self.trace_id, self.parent_id = parent[0], parent[1]
        self.span_id = TRACER.new_span_id()
        TRACER._stack().append((self.trace_id, self.span_id))
        self._t0 = _now_us()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = _now_us()
        st = TRACER._stack()
        # unwind to our own entry: a span leaked open by an exception below
        # us must not poison this thread's context stack forever
        want = (self.trace_id, self.span_id)
        while st:
            if st.pop() == want:
                break
        TRACER.record(
            self.name, self._t0, t1 - self._t0, self.trace_id, self.span_id,
            self.parent_id, self.attrs,
        )
        return False


def span(name: str, **attrs: Any):
    """`with span("train.dispatch", k=4): ...` — records one complete span.

    Disabled: returns a shared no-op CM (one truth test; `attrs` should
    therefore be cheap literals, never formatted strings — the hot-loop lint
    enforces this for the train/decode loops)."""
    if not TRACER.enabled:
        return _NULL_SPAN
    return _LiveSpan(name, attrs or None)


def record_span(
    name: str,
    t0_us: int,
    t1_us: int,
    trace_id: Optional[str] = None,
    parent_id: Optional[str] = None,
    attrs: Optional[Dict[str, Any]] = None,
) -> None:
    """Record a span whose interval was measured externally (queue waits,
    time-to-first-token, pass durations). Inherits the thread's current
    context when trace_id is not given. No-op when disabled."""
    if not TRACER.enabled:
        return
    if trace_id is None:
        cur = TRACER.current()
        if cur is not None:
            trace_id, parent_id = cur[0], parent_id or cur[1]
        else:
            trace_id = TRACER.new_trace_id()
    TRACER.record(
        name, t0_us, max(0, int(t1_us) - int(t0_us)), trace_id,
        TRACER.new_span_id(), parent_id, attrs,
    )


def span_from_monotonic(
    name: str,
    started_monotonic: float,
    trace_id: Optional[str] = None,
    parent_id: Optional[str] = None,
    attrs: Optional[Dict[str, Any]] = None,
) -> None:
    """Record [started_monotonic, now] measured on time.monotonic (the
    scheduler's clock) as a wall-clock span ending now."""
    if not TRACER.enabled:
        return
    t1 = _now_us()
    dur_us = int((time.monotonic() - started_monotonic) * 1e6)
    record_span(name, t1 - max(0, dur_us), t1, trace_id, parent_id, attrs)


# -- cross-process context ---------------------------------------------------


def wire_context() -> Optional[Dict[str, str]]:
    """The current span as the tiny dict that piggybacks on line-JSON RPC
    frames (`"_trace": {"t": ..., "s": ...}`); None when disabled/no span."""
    if not TRACER.enabled:
        return None
    cur = TRACER.current()
    if cur is None:
        return None
    return {"t": cur[0], "s": cur[1]}


class _Activation:
    __slots__ = ("ctx", "_pushed")

    def __init__(self, ctx):
        self.ctx = ctx
        self._pushed = False

    def __enter__(self):
        if self.ctx is not None:
            TRACER._stack().append(self.ctx)
            self._pushed = True
        return self

    def __exit__(self, *exc):
        if self._pushed:
            st = TRACER._stack()
            while st:
                if st.pop() == self.ctx:
                    break
        return False


def activate(ctx) -> _Activation:
    """Re-enter a foreign span context so spans opened inside join its trace.

    `ctx` is a wire dict ({"t": ..., "s": ...}), a (trace_id, span_id)
    tuple, or None (no-op). Disabled tracing is also a no-op."""
    if not TRACER.enabled or ctx is None:
        return _Activation(None)
    if isinstance(ctx, dict):
        t, s = ctx.get("t"), ctx.get("s")
        if not t:
            return _Activation(None)
        return _Activation((str(t), str(s or "")))
    return _Activation((ctx[0], ctx[1]))


def server_span(name: str, wire_ctx, **attrs: Any):
    """RPC-handler helper: adopt the caller's wire context (when present) and
    open a span under it — `with server_span("rpc.submit", req.get("_trace"))`.
    Disabled: the shared no-op CM."""
    if not TRACER.enabled:
        return _NULL_SPAN
    return _ServerSpan(name, wire_ctx, attrs or None)


class _ServerSpan:
    __slots__ = ("_act", "_span")

    def __init__(self, name, wire_ctx, attrs):
        self._act = activate(wire_ctx)
        self._span = _LiveSpan(name, attrs)

    def __enter__(self):
        self._act.__enter__()
        return self._span.__enter__()

    def __exit__(self, *exc):
        try:
            return self._span.__exit__(*exc)
        finally:
            self._act.__exit__(*exc)


# -- export ------------------------------------------------------------------


def _to_event(row: tuple, pid: int) -> Dict[str, Any]:
    name, t0, dur, trace_id, span_id, parent_id, attrs, tid = row
    args: Dict[str, Any] = {"trace_id": trace_id, "span_id": span_id}
    if parent_id:
        args["parent_id"] = parent_id
    if attrs:
        args.update(attrs)
    return {
        "ph": "X",
        "cat": "paddle_tpu",
        "name": name,
        "ts": t0,
        "dur": max(0, dur),
        "pid": pid,
        "tid": tid,
        "args": args,
    }


def export_chrome(path: Optional[str] = None) -> Dict[str, Any]:
    """Buffered spans as a Chrome trace-event JSON object (Perfetto /
    chrome://tracing loadable): {"traceEvents": [...complete events...]}.
    Every event carries ph/ts/dur/pid/tid/name plus trace/span ids in args.
    With `path`, also writes the JSON file."""
    pid = os.getpid()
    out = {
        "displayTimeUnit": "ms",
        "traceEvents": [_to_event(r, pid) for r in TRACER.snapshot()],
        "otherData": {"dropped_spans": TRACER.dropped},
    }
    if path:
        with open(path, "w") as f:
            json.dump(out, f)
    return out


def validate_chrome(trace_obj: Dict[str, Any]) -> List[str]:
    """Golden-format check used by tests and the export CLI: returns the
    list of problems (empty = loadable shape with the required keys)."""
    problems: List[str] = []
    events = trace_obj.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    for i, ev in enumerate(events):
        for k in _REQUIRED_EVENT_KEYS:
            if k not in ev:
                problems.append(f"event {i} missing {k!r}")
    try:
        json.dumps(trace_obj)
    except (TypeError, ValueError) as e:
        problems.append(f"not JSON-serializable: {e}")
    return problems
