"""Serving fleet membership: replica leases, piggybacked health, the agent
(the counterpart of `paddle_tpu/serving/fleet.py`, on the same wire).

N `ServingServer` replicas sit behind one router, and every signal the
router needs to dispatch (liveness, queue depth, free pages, the load
estimator's queue-wait figure, engine restarts) rides traffic that already
flows, never a per-decision round trip:

  * a replica registers with the router (`replica_register`, advertising
    its serving endpoint) and renews the lease with `replica_heartbeat`
    every lease/3, the heartbeat request carrying a load snapshot straight
    out of `ServingSession.stats()`;
  * the heartbeat reply carries the router's control signals back: a
    planned drain order, a "re-register" hint after an eviction the replica
    outlived;
  * a wedged replica self-fences: the agent watches the session's progress
    marker, and an engine that has work but has made no progress past
    `stall_fence_s` (and is not inside a step: a first step's graph capture
    is not a wedge) stops claiming liveness, so the router's lease expiry
    is the one arbiter of "alive".

`Replica` is the router's view of one replica, `FleetView` the lease and
load books (no RPC lives here), `ReplicaAgent` the replica-side joiner.
Dispatch, failover and dedup live in serving/router.py."""

from __future__ import annotations

import logging
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from paddle_tpu_torch.core import stats
from paddle_tpu_torch.runtime.master import (
    EndpointsLike,
    MasterClient,
    parse_endpoints,
)

log = logging.getLogger("paddle_tpu_torch.serving.fleet")

# the load-snapshot keys a replica heartbeat piggybacks (a subset of
# ServingSession.stats()): what the router's least-loaded choice and its
# fleet-wide shed read, and the cumulative shed / deadline-miss counters an
# autoscaler reads from the router's stats
LOAD_KEYS = (
    "queue_depth", "active_slots", "max_slots", "free_pages",
    "estimated_queue_wait_s", "engine_restarts", "decode_steps",
    "shed", "deadline_misses",
)


class ReplicaState:
    LIVE = "live"          # holding a lease, assignable
    DRAINING = "draining"  # planned drain: no new assignments, in-flight runs
    DRAINED = "drained"    # drain complete: deregistered cleanly
    EVICTED = "evicted"    # lease expired / connection dead: failed over
    CLOSED = "closed"      # pump shut down; terminal


class Replica:
    """The router's view of one ServingServer replica. All mutation happens
    under the owning Router's lock; this object is pure bookkeeping."""

    def __init__(self, replica_id: str, endpoint: Tuple[str, int],
                 index: int):
        self.replica_id = replica_id
        self.endpoint = (str(endpoint[0]), int(endpoint[1]))
        # registration order: the deterministic tie-break for assignment
        # scoring (replica ids carry a random prefix)
        self.index = index
        self.state = ReplicaState.LIVE
        self.last_seen = time.monotonic()
        self.load: Dict[str, Any] = {}
        # fleet request ids whose delivery the router still expects from
        # this replica (live assignments)
        self.outstanding: Set[int] = set()
        # fleet rid -> replica-side rid for every request forwarded and not
        # yet answered or cancelled: survives eviction so the pump can keep
        # polling a partitioned replica and catch a late winner (which the
        # dedup map drops and counts)
        self.rids: Dict[int, int] = {}
        self.assigned_total = 0
        self.failovers = 0
        self.late_results_dropped = 0
        self.conn_failures = 0
        # delta-poll cursors: fleet rid -> tokens of that request this
        # replica already sent, so each pump cycle reads only the unseen
        # suffix (a lost cursor just means one full-width reply)
        self.poll_cursors: Dict[int, int] = {}
        self.evicted_at: Optional[float] = None
        self.drain_deadline: Optional[float] = None
        # set once the drain completed: the next heartbeat reply tells the
        # agent, which fires its on_drained callback and stops renewing
        self.drained = False

    def view(self) -> Dict[str, Any]:
        return {
            "replica_id": self.replica_id,
            "endpoint": list(self.endpoint),
            "state": self.state,
            "outstanding": len(self.outstanding),
            "assigned_total": self.assigned_total,
            "failovers": self.failovers,
            "late_results_dropped": self.late_results_dropped,
            "load": dict(self.load),
        }


def _score(rep: Replica) -> tuple:
    """Least-loaded ordering key, from piggybacked state and the router's
    own assignment books only: occupancy (the router's in flight there +
    what the replica reports queued and decoding) over slot width, then the
    replica's queue-wait estimate, then engine restarts (a flapping replica
    loses ties), then registration order."""
    load = rep.load
    slots = max(1, int(load.get("max_slots", 1) or 1))
    occupancy = (
        len(rep.outstanding)
        + int(load.get("queue_depth", 0) or 0)
        + int(load.get("active_slots", 0) or 0)
    )
    return (
        occupancy / slots,
        float(load.get("estimated_queue_wait_s", 0.0) or 0.0),
        int(load.get("engine_restarts", 0) or 0),
        rep.index,
    )


class FleetView:
    """Replica membership and load books for the router: register mints a
    lease, heartbeats renew it, silence past `lease_s` is eviction. No RPC
    happens here."""

    # occupancy slack the affinity preference may cost: the affine replica
    # wins while its occupancy per slot is within this much of the
    # least-loaded choice
    AFFINITY_SLACK = 0.25

    def __init__(self, lease_s: float = 5.0):
        self.lease_s = float(lease_s)
        self._lock = threading.Lock()
        self._replicas: Dict[str, Replica] = {}
        self._prefix = uuid.uuid4().hex[:6]
        self._next = 0
        self.evicted_total = 0

    def register(self, endpoint: Tuple[str, int]) -> Replica:
        with self._lock:
            rep = Replica(
                f"rep-{self._prefix}-{self._next}", endpoint, self._next
            )
            self._next += 1
            self._replicas[rep.replica_id] = rep
            return rep

    def heartbeat(self, replica_id: Optional[str],
                  load: Optional[Dict[str, Any]]) -> Optional[Replica]:
        """Renew a lease and absorb the piggybacked load snapshot. Returns
        the replica (the caller reads its state), or None for an id this
        fleet never held: adopting on sight would resurrect a replica the
        router already failed over."""
        if not replica_id:
            return None
        with self._lock:
            rep = self._replicas.get(replica_id)
            if rep is None or rep.state not in (
                ReplicaState.LIVE, ReplicaState.DRAINING
            ):
                return rep
            rep.last_seen = time.monotonic()
            if load:
                rep.load = {k: load[k] for k in LOAD_KEYS if k in load}
            return rep

    def get(self, replica_id: str) -> Optional[Replica]:
        with self._lock:
            return self._replicas.get(replica_id)

    def replicas(self) -> List[Replica]:
        with self._lock:
            return list(self._replicas.values())

    def live(self) -> List[Replica]:
        with self._lock:
            return [
                r for r in self._replicas.values()
                if r.state == ReplicaState.LIVE
            ]

    def expired(self, now: Optional[float] = None) -> List[Replica]:
        now = time.monotonic() if now is None else now
        with self._lock:
            return [
                r for r in self._replicas.values()
                if r.state in (ReplicaState.LIVE, ReplicaState.DRAINING)
                and now - r.last_seen > self.lease_s
            ]

    def choose(self, exclude: Set[str] = frozenset(),
               prefer: Optional[str] = None) -> Optional[Replica]:
        """The least-loaded live replica (None when none), see _score.

        With `prefer` naming a replica, that replica wins while it is live,
        not excluded and within AFFINITY_SLACK of the least-loaded one's
        occupancy: traffic sharing a prompt head lands where its prefix
        cache is warm. The preference is a hint, never a constraint."""
        with self._lock:
            candidates = [
                r for r in self._replicas.values()
                if r.state == ReplicaState.LIVE
                and r.replica_id not in exclude
            ]
        if not candidates:
            return None
        best = min(candidates, key=_score)
        if prefer is not None and prefer != best.replica_id:
            for r in candidates:
                if (r.replica_id == prefer
                        and _score(r)[0] <= _score(best)[0]
                        + self.AFFINITY_SLACK):
                    return r
        return best


class ReplicaAgent:
    """Replica-side fleet joiner: registers this ServingServer with the
    router and renews the lease with load-snapshot heartbeats.

    Self-fencing: each tick reads the session's progress marker; an engine
    that has work but has made no progress for longer than `stall_fence_s`
    while parked between steps stops heartbeating, so the router's lease
    expiry fails its requests over to a survivor. When the wedge clears,
    heartbeats resume; an evicted-then-healed replica is told to
    re-register and rejoins under a fresh lease, while its old pump
    connection lets its late results reach the router's dedup map.

    Router HA: `router_endpoints` may list a primary and a warm standby.
    The agent rotates itself (one single-endpoint client at a time), so
    every control hint in a reply is from the endpoint the agent just spoke
    to. Replies carry the router's per-incarnation `instance` token; a hint
    from a foreign incarnation is obeyed only when this agent's registered
    incarnation is provably gone (its endpoint answered as the new
    incarnation, or unreachable past ROTATE_AFTER consecutive failures);
    otherwise it is a stale reply from a partitioned old primary, counted
    and dropped."""

    # consecutive connection failures against the registered endpoint
    # before the agent concludes its router is gone and rotates
    ROTATE_AFTER = 2

    def __init__(
        self,
        router_endpoints: EndpointsLike,
        session,
        advertise: Tuple[str, int],
        client_kw: Optional[dict] = None,
        stall_fence_s: float = 5.0,
        on_drained: Optional[Callable[[], None]] = None,
    ):
        self._eps = parse_endpoints(router_endpoints)
        self._cur = 0
        self._client_kw = dict(client_kw or {"timeout": 5.0, "retries": 3})
        self._client = MasterClient(self._eps[self._cur], **self._client_kw)
        # which router incarnation and endpoint index hold our registration
        self.router_instance: Optional[str] = None
        self._reg_ep: Optional[int] = None
        self._conn_failures = 0
        self.rotations = 0
        self.stale_replies = 0
        self.session = session
        self.advertise = (str(advertise[0]), int(advertise[1]))
        self.stall_fence_s = float(stall_fence_s)
        self.on_drained = on_drained
        self.replica_id: Optional[str] = None
        self.lease_s = 5.0
        self.fenced_heartbeats = 0
        self._last_marker: Optional[tuple] = None
        self._last_change = time.monotonic()
        self._evt = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="replica-agent", daemon=True
        )

    # -- health -------------------------------------------------------------
    def _healthy(self, now: float) -> bool:
        """False only for a genuine wedge: work pending, the engine parked
        between steps (an in-flight step may be a first capture), and no
        progress past the fence window."""
        s = self.session
        if s is None:
            return True
        marker = s.progress_marker()
        if marker != self._last_marker:
            self._last_marker = marker
            self._last_change = now
            return True
        if not s.scheduler.has_work() or s._engine_in_step:
            self._last_change = now
            return True
        return (now - self._last_change) <= self.stall_fence_s

    def _load_snapshot(self) -> Dict[str, Any]:
        if self.session is None:
            return {}
        st = self.session.stats()
        return {k: st[k] for k in LOAD_KEYS if k in st}

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "ReplicaAgent":
        self._register()
        self._thread.start()
        return self

    def _rotate(self) -> None:
        """Move to the next router endpoint (a no-op for one endpoint)."""
        if len(self._eps) <= 1:
            return
        self._client.close()
        self._cur = (self._cur + 1) % len(self._eps)
        self._client = MasterClient(self._eps[self._cur], **self._client_kw)
        self.rotations += 1
        stats.FT_EVENTS.incr("replica_router_rotate")
        log.warning("replica agent rotating to router endpoint %s:%d",
                    *self._eps[self._cur])

    def _note_conn_failure(self) -> None:
        self._conn_failures += 1
        # unregistered, any live router will do: rotate on the first
        # failure; registered, stay pinned to our router until its death is
        # confirmed (ROTATE_AFTER strikes), so one transient hiccup cannot
        # hand control hints to a different incarnation
        threshold = 1 if self.replica_id is None else self.ROTATE_AFTER
        if self._conn_failures >= threshold:
            self._rotate()

    def _register(self) -> bool:
        try:
            resp = self._client.call(
                "replica_register",
                endpoint=list(self.advertise),
                load=self._load_snapshot(),
            )
        except ConnectionError as e:
            # the router being down must not kill the replica: it keeps
            # serving direct traffic and the heartbeat loop keeps trying
            log.warning("replica register with router failed (%s); retrying "
                        "from the heartbeat loop", e)
            self._note_conn_failure()
            return False
        if "replica_id" not in resp:
            log.warning("router refused replica registration: %r", resp)
            return False
        self.replica_id = resp["replica_id"]
        self.lease_s = float(resp.get("lease_s", 5.0))
        self.router_instance = resp.get("instance")
        self._reg_ep = self._cur
        self._conn_failures = 0
        stats.FT_EVENTS.incr("replica_registered")
        return True

    def _handle_reply(self, resp: dict) -> Optional[str]:
        """Fold one heartbeat reply into the agent's state. Returns
        'drained' when the agent should stop renewing, else None."""
        inst = resp.get("instance")
        foreign = (
            inst is not None and self.router_instance is not None
            and inst != self.router_instance
        )
        if foreign:
            at_home = self._reg_ep is not None and self._cur == self._reg_ep
            lost_home = self._conn_failures >= self.ROTATE_AFTER
            if not (at_home or lost_home):
                # a different incarnation answered while ours was last
                # known reachable: a stale, partitioned old primary. Ignore
                # its hints and go home.
                self.stale_replies += 1
                stats.FT_EVENTS.incr("replica_stale_router_reply")
                if self._reg_ep is not None and self._cur != self._reg_ep:
                    self._client.close()
                    self._cur = self._reg_ep
                    self._client = MasterClient(
                        self._eps[self._cur], **self._client_kw
                    )
                return None
            # our incarnation is gone: register afresh with the answerer
            self.replica_id = None
            stats.FT_EVENTS.incr("replica_reregister")
            self._register()
            return None
        self._conn_failures = 0
        if resp.get("drained"):
            # the planned drain completed router-side: tell the operator
            # hook and stop renewing
            if self.on_drained is not None:
                try:
                    self.on_drained()
                except Exception:
                    log.exception("on_drained callback failed")
            return "drained"
        if resp.get("reregister"):
            # the router evicted this lease and we outlived the verdict:
            # rejoin fresh (the old id stays dead, so late results stay
            # distinguishable), against the endpoint that issued the hint
            self.replica_id = None
            stats.FT_EVENTS.incr("replica_reregister")
            self._register()
        return None

    def _loop(self) -> None:
        while True:
            period = max(0.05, self.lease_s / 3.0)
            if self._evt.wait(period):
                return
            now = time.monotonic()
            if not self._healthy(now):
                # self-fence: a wedged engine must not renew the lease
                self.fenced_heartbeats += 1
                stats.FT_EVENTS.incr("replica_heartbeat_fenced")
                continue
            if self.replica_id is None:
                self._register()
                continue
            try:
                resp = self._client.call(
                    "replica_heartbeat",
                    replica_id=self.replica_id,
                    load=self._load_snapshot(),
                )
            except ConnectionError:
                stats.FT_EVENTS.incr("replica_heartbeat_lost")
                self._note_conn_failure()
                continue
            if self._handle_reply(resp) == "drained":
                return

    def stop(self) -> None:
        """Clean leave: deregister so the router drops the lease now."""
        self._evt.set()
        self._thread.join(timeout=5.0)
        if self.replica_id is not None:
            try:
                self._client.call(
                    "replica_deregister", replica_id=self.replica_id
                )
            except ConnectionError:
                pass  # the lease simply expires
        self._client.close()

    def kill(self) -> None:
        """Crash semantics (drills): stop heartbeating without
        deregistering, so the router finds the death through lease expiry
        and dead connections, as after a real process kill."""
        self._evt.set()
        self._client.close()
