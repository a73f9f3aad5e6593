"""Warm-standby election: one watch loop for every control plane (the
counterpart of `paddle_tpu/runtime/election.py`).

  * watch — a raw TCP connect probe against the primary's endpoint every
    `poll_s`; no RPC protocol is assumed, so anything that listens (a
    RouterServer, a master) is watchable;
  * weighted strikes — a refused or unreachable probe counts 1.0, a timed
    out probe only 0.5 (slow is not dead: an overloaded primary must not
    be usurped on latency alone);
  * patient confirmation — once the strike budget (`confirm_failures`) is
    spent, one last probe with a 3x patient timeout must still fail before
    the standby declares takeover;
  * bind at takeover — the watcher binds nothing; the caller starts its
    server only after `wait_for_takeover` returns, so an early client gets
    connection-refused and keeps rotating its endpoint list instead of
    talking to a cold standby;
  * instance token — every takeover mints a fresh per-incarnation token;
    downstream fencing compares it, so a healed old primary's stale replies
    are recognisably from a dead incarnation;
  * observability — each takeover bumps `FT_EVENTS["<plane>_takeover"]`
    and `paddle_tpu_takeovers_total{plane=...}`.

Without a consensus backend this stays a heuristic: a primary alive on the
far side of a true network partition can double-serve for a window. The
router therefore pairs election with data-plane fencing: instance-token
heartbeat fencing and the (tenant, client_req_id) dedup latch."""

from __future__ import annotations

import logging
import socket
import threading
import time
import uuid
from typing import Optional

from paddle_tpu_torch.core import stats
from paddle_tpu_torch.obs import metrics as obs_metrics
from paddle_tpu_torch.runtime.master import EndpointsLike, parse_endpoints

log = logging.getLogger("paddle_tpu_torch.runtime.election")


def mint_instance_token() -> str:
    """A fresh per-incarnation identity (8 hex chars): two incarnations of
    the same control plane never share one, so replies can be fenced by
    which incarnation produced them."""
    return uuid.uuid4().hex[:8]


class StandbyWatcher:
    """The election loop, as an object so drills can stop() it.

    `wait_for_takeover()` blocks until the primary is confirmed dead
    (returns the freshly minted instance token), `max_wait_s` elapses, or
    `stop()` / the shared `stop_evt` fires (returns None)."""

    def __init__(
        self,
        primary: EndpointsLike,
        plane: str,
        poll_s: float = 0.2,
        confirm_failures: float = 2,
        probe_timeout_s: float = 1.0,
        confirm_timeout_s: float = 3.0,
        max_wait_s: Optional[float] = None,
        stop_evt: Optional[threading.Event] = None,
    ):
        self.primary = parse_endpoints(primary)[0]
        self.plane = str(plane)
        self.poll_s = float(poll_s)
        self.confirm_failures = float(confirm_failures)
        self.probe_timeout_s = float(probe_timeout_s)
        self.confirm_timeout_s = float(confirm_timeout_s)
        self.max_wait_s = max_wait_s
        self._stop_evt = stop_evt if stop_evt is not None else threading.Event()
        self.misses = 0.0
        self.probes = 0

    def stop(self) -> None:
        self._stop_evt.set()

    def _probe_once(self, timeout_s: float) -> float:
        """One connect probe; returns the miss weight it earned (0.0 alive,
        0.5 timed out, 1.0 refused or unreachable)."""
        self.probes += 1
        try:
            socket.create_connection(self.primary, timeout=timeout_s).close()
            return 0.0
        except TimeoutError:
            return 0.5
        except OSError:
            return 1.0

    def wait_for_takeover(self) -> Optional[str]:
        (phost, pport) = self.primary
        # clock-ok: one deadline stamp per watch, checked once per probe
        # cycle (poll_s-paced: this loop is the cold path)
        deadline = (
            time.monotonic() + self.max_wait_s
            if self.max_wait_s is not None else None
        )
        while True:
            if self._stop_evt.is_set():
                return None
            # clock-ok: one expiry check per poll_s-paced probe cycle
            if deadline is not None and time.monotonic() > deadline:
                return None
            w = self._probe_once(self.probe_timeout_s)
            self.misses = 0.0 if w == 0.0 else self.misses + w
            if self.misses >= self.confirm_failures:
                # final confirmation, patient timeout: live beats standby
                if self._probe_once(self.confirm_timeout_s) == 0.0:
                    self.misses = 0.0
                else:
                    break
            time.sleep(self.poll_s)
        token = mint_instance_token()
        log.warning(
            "%s standby: primary %s:%d unreachable (%.1f strikes) — taking "
            "over as incarnation %s", self.plane, phost, pport, self.misses,
            token,
        )
        stats.FT_EVENTS.incr(f"{self.plane}_takeover")
        obs_metrics.observe_takeover(self.plane)
        return token


def watch_primary(
    primary: EndpointsLike,
    plane: str,
    poll_s: float = 0.2,
    confirm_failures: float = 2,
    max_wait_s: Optional[float] = None,
    stop_evt: Optional[threading.Event] = None,
) -> Optional[str]:
    """Block until `primary` is confirmed dead; returns the new incarnation's
    instance token (takeover counters already bumped), or None on stop /
    `max_wait_s` expiry. The functional face of `StandbyWatcher` that
    `RouterStandby` consumes."""
    return StandbyWatcher(
        primary, plane, poll_s=poll_s, confirm_failures=confirm_failures,
        max_wait_s=max_wait_s, stop_evt=stop_evt,
    ).wait_for_takeover()
