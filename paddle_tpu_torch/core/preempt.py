"""Preemption-safe shutdown (the port's copy of `paddle_tpu/core/preempt.py`).

A SIGTERM/SIGINT only sets a flag; the train loop polls it at dispatch
boundaries (`requested()`), lets the step in flight finish, writes a
CRC-valid mid-pass checkpoint and the `latest` pointer, and raises
`trainer.Preempted`, which a CLI turns into the exit code `EXIT_PREEMPTED`.
A restart with `auto_resume=True` continues from exactly that batch
boundary, bitwise equal to a run that was never preempted on a
deterministic reader.

Semantics:
- first SIGTERM/SIGINT: request a drain (flag + deadline = now + grace_s);
- a second signal while draining gives up: the previous handler goes back
  and the signal is delivered again;
- past the grace deadline the trainer skips the checkpoint write and exits
  with whatever the last durable checkpoint was (`deadline_passed()`).

The seeded `preempt` fault site (`core/faults.py`) calls `request()`
directly, so the drain is a deterministic, tested path without signals.

`request_resize(world)` parks an elastic-resize order (a cooperative drain
that re-shards the state and continues) exactly as the JAX package does;
a trainer with a mesh drains and re-shards at its next dispatch boundary
(on several ranks, rank 0 takes the order for all), and one without a
mesh takes it and ignores it, as the JAX package's does."""

from __future__ import annotations

import logging
import os
import signal
import threading
import time
from typing import Dict, Optional, Tuple

from paddle_tpu_torch.core import stats

log = logging.getLogger("paddle_tpu_torch.preempt")

# Distinct exit code for "checkpointed and exited on a preemption notice" —
# chosen outside the 128+signum band so a supervisor can tell a clean drain
# (restart with auto_resume) from an unhandled kill.
EXIT_PREEMPTED = 77

DEFAULT_SIGNALS = (signal.SIGTERM, signal.SIGINT)


class ResizeRequest:
    """One pending elastic-resize order: re-shape the mesh data axis to
    `world` chips. `epoch` is the master's resize-epoch id (0 for local,
    uncoordinated requests) and `instance` the announcing master's resize-
    plane instance token ("" for local) — epoch numbers restart when a
    standby is promoted, so only the (instance, epoch) pair identifies an
    epoch; `requested_at` anchors the drain-latency split reported by the
    trainer."""

    __slots__ = ("world", "epoch", "instance", "reason", "requested_at")

    def __init__(
        self, world: int, epoch: int = 0, instance: str = "",
        reason: str = "resize",
    ):
        if int(world) < 1:
            raise ValueError(f"resize world must be >= 1, got {world}")
        self.world = int(world)
        self.epoch = int(epoch)
        self.instance = instance or ""
        self.reason = reason
        self.requested_at = time.monotonic()

    def __repr__(self):
        return (
            f"ResizeRequest(world={self.world}, epoch={self.epoch}, "
            f"instance={self.instance!r}, reason={self.reason!r})"
        )


class PreemptionGuard:
    """Flag + deadline the train loop polls at batch boundaries."""

    def __init__(self, grace_s: float = 30.0):
        self.grace_s = float(grace_s)
        self._lock = threading.Lock()
        self._requested_at: Optional[float] = None
        self._reason: Optional[str] = None
        self._resize: Optional[ResizeRequest] = None
        self._old_handlers: Dict[int, object] = {}

    # -- signal wiring -------------------------------------------------------
    def install(self, signals: Tuple[int, ...] = DEFAULT_SIGNALS) -> "PreemptionGuard":
        """Install drain handlers. Only possible from the main thread
        (signal.signal's rule); elsewhere the guard still works via
        `request()` — e.g. the chaos injector — so failure is non-fatal."""
        for sig in signals:
            try:
                self._old_handlers[sig] = signal.signal(sig, self._on_signal)
            except ValueError as e:  # non-main thread
                log.warning("cannot install handler for signal %d: %s", sig, e)
        return self

    def uninstall(self) -> None:
        for sig, old in self._old_handlers.items():
            try:
                signal.signal(sig, old)
            except (ValueError, TypeError):
                pass
        self._old_handlers.clear()

    def _on_signal(self, signum, frame) -> None:
        if self.requested:
            # second notice while draining: stop being graceful — put the
            # previous handler back and re-deliver so default semantics
            # (KeyboardInterrupt / process death) take over immediately
            old = self._old_handlers.get(signum, signal.SIG_DFL)
            signal.signal(signum, old)
            os.kill(os.getpid(), signum)
            return
        try:
            name = signal.Signals(signum).name
        except ValueError:
            name = f"signal {signum}"
        self.request(name)

    # -- flag ----------------------------------------------------------------
    def request(self, reason: str = "preempt") -> None:
        """Mark the run as preempted; idempotent (first reason/deadline win)."""
        with self._lock:
            if self._requested_at is not None:
                return
            self._requested_at = time.monotonic()
            self._reason = reason
        stats.FT_EVENTS.incr("preempt_request")
        log.warning(
            "preemption notice (%s): draining — will finish the current step, "
            "checkpoint, and exit with code %d (grace %.1fs)",
            reason, EXIT_PREEMPTED, self.grace_s,
        )

    @property
    def requested(self) -> bool:
        return self._requested_at is not None

    @property
    def reason(self) -> Optional[str]:
        return self._reason

    def deadline_passed(self) -> bool:
        """True once the grace budget is exhausted — the drain should stop
        doing durable work (checkpoint writes) and just exit."""
        with self._lock:
            if self._requested_at is None:
                return False
            return time.monotonic() - self._requested_at > self.grace_s

    # -- elastic resize (cooperative drain, no exit) -------------------------
    def request_resize(
        self, world: int, epoch: int = 0, instance: str = "",
        reason: str = "resize",
    ) -> bool:
        """Park a resize order for the train loop's next dispatch boundary.
        A strictly LATER epoch from the SAME master instance supersedes an
        unclaimed earlier request (the master may re-announce after
        membership churn), and any epoch from a DIFFERENT instance does too
        (a heartbeat reply reflects the live master's current state — a
        promoted standby's epoch 1 outranks a dead primary's parked epoch
        5). Stale/duplicate same-instance epochs, and a local epoch-0
        order while any request is already parked, are ignored — a local
        request can never clobber a pending master-coordinated one.
        Returns True when the request was accepted."""
        req = ResizeRequest(world, epoch, instance, reason)
        with self._lock:
            cur = self._resize
            if cur is not None:
                if epoch == 0:
                    return False  # local order never clobbers a parked one
                if cur.instance == req.instance and cur.epoch >= epoch:
                    return False  # duplicate/stale within one master's numbering
            self._resize = req
        stats.FT_EVENTS.incr("resize_request")
        log.warning(
            "resize notice (%s): will drain at the next batch boundary and "
            "re-shard onto %d chip(s) (epoch %d)", reason, req.world, req.epoch,
        )
        return True

    @property
    def resize_pending(self) -> bool:
        return self._resize is not None

    def resize_request(self) -> Optional[ResizeRequest]:
        with self._lock:
            return self._resize

    def take_resize(self) -> Optional[ResizeRequest]:
        """Claim the pending resize (clears the flag) — exactly one drain per
        request, even with several pollers."""
        with self._lock:
            req, self._resize = self._resize, None
            return req

    def reset(self) -> None:
        with self._lock:
            self._requested_at = None
            self._reason = None
            self._resize = None


# -- module-level singleton (what the trainer and CLI talk to) ---------------

_GUARD: Optional[PreemptionGuard] = None
_GUARD_LOCK = threading.Lock()


def install(grace_s: float = 30.0, signals: Tuple[int, ...] = DEFAULT_SIGNALS) -> PreemptionGuard:
    """Create (or reconfigure) the process-wide guard and hook the signals."""
    global _GUARD
    with _GUARD_LOCK:
        if _GUARD is None:
            _GUARD = PreemptionGuard(grace_s)
        else:
            _GUARD.grace_s = float(grace_s)
        return _GUARD.install(signals)


def get() -> PreemptionGuard:
    """The process-wide guard, created flag-only (no signal handlers) on
    first use — this is how the chaos `preempt` site requests a drain in
    processes that never called install()."""
    global _GUARD
    with _GUARD_LOCK:
        if _GUARD is None:
            _GUARD = PreemptionGuard()
        return _GUARD


def requested() -> bool:
    """Cheap poll for the train loop: no guard → never preempted."""
    g = _GUARD
    return g is not None and g.requested


def resize_requested() -> bool:
    """Cheap per-boundary poll for the train loop: no guard → no resize."""
    g = _GUARD
    return g is not None and g.resize_pending


def reset() -> None:
    """Clear the flag and detach handlers (test isolation)."""
    global _GUARD
    with _GUARD_LOCK:
        if _GUARD is not None:
            _GUARD.uninstall()
            _GUARD.reset()
        _GUARD = None
