"""Fault-tolerant multi-replica serving router (the counterpart of
`paddle_tpu/serving/router.py`, on the same wire).

The tier that lets serving go wide: N `ServingServer` replicas (each
possibly tensor-parallel) behind one router that stays correct while
replicas crash, wedge, join and drain.

  * membership — replicas hold leases in a `FleetView` (serving/fleet.py),
    renewed by heartbeats whose REQUEST carries the replica's load snapshot
    and whose REPLY carries the router's control signals (drain orders,
    re-register hints) — the master plane's piggyback discipline, so the
    dispatch path never pays a health round-trip;
  * dispatch — each submit routes to the least-loaded LIVE replica, scored
    purely from piggybacked state + the router's own assignment books (no
    RPC per decision; the ONE blocking call in the path is the forward of
    the submit itself, pinned by tests/test_torch_router.py). When
    every replica sheds, the router sheds too — with the TIGHTEST
    `retry_after_ms` any replica offered — never a hang;
  * in-flight failover — when a replica's lease lapses (it died, or its
    agent self-fenced a wedge) or its connection drops, the router
    re-submits that replica's outstanding requests to a survivor under the
    SAME idempotency key and the SAME pinned per-request seed, so
    re-execution is token-identical for greedy AND sampled streams (the
    session's seeded sampling). The fleet-level (tenant, client_req_id) dedup map
    guarantees exactly-one delivered result: the pump keeps polling a
    partitioned replica after eviction, and a LATE answer from it is
    dropped and counted, never double-delivered;
  * planned drain — `drain(replica_id)` stops new assignments, lets
    in-flight streams finish against a deadline (stragglers fail over),
    then deregisters: the lever an autoscaling controller pulls;
  * hedging — the client-side TTFT hedge, promoted into the router:
    a token-less request past `hedge_ttft_s` is duplicated onto a second
    replica under the same key+seed; the first replica to produce a token
    wins and the loser is cancelled server-side.

Results flow back through per-REPLICA pump threads batch-polling
`poll_many` — one round-trip per pump cycle per replica regardless of how
many requests are in flight there (the "RPC Considered Harmful" shape, and
the shape a batched control plane generalizes).

`RouterServer` wraps the router in the same line-JSON TCP surface a
`ServingServer` exposes, so `ServingClient` talks to a router unchanged.
On the card: `chip_smoke.py` phases 45-46."""

from __future__ import annotations

import collections
import itertools
import logging
import socketserver
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from paddle_tpu_torch.core import stats
from paddle_tpu_torch.obs import metrics as obs_metrics
from paddle_tpu_torch.obs import trace
from paddle_tpu_torch.runtime.election import mint_instance_token, watch_primary
from paddle_tpu_torch.runtime.master import EndpointsLike, MasterClient, _Membership
from paddle_tpu_torch.serving.fleet import FleetView, Replica, ReplicaState
from paddle_tpu_torch.serving.quota import QuotaExceeded
from paddle_tpu_torch.serving.scheduler import FinishReason
from paddle_tpu_torch.serving.server import _Handler, clamp_cursor

log = logging.getLogger("paddle_tpu_torch.serving.router")


class _BadRequest(RuntimeError):
    """A replica refused the forward for a non-load reason (bad prompt,
    over max_len, ...): the client's problem, not the fleet's — never
    retried on another replica."""


# prompt tokens hashed into the affinity key: long enough to distinguish
# system prompts, short enough that appending user turns to a shared head
# still lands on the same replica (the multi-turn shape)
AFFINITY_HEAD = 16


def affinity_key(prompt: Sequence[int]) -> Optional[int]:
    """Prefix-affinity key: a hash of the prompt
    HEAD, so requests sharing a system prompt / conversation prefix map to
    the same key and the dispatch score can prefer the replica whose
    prefix cache is already warm for it.
    Int-tuple hashing is deterministic within a process — this key never
    crosses the wire."""
    if not prompt:
        return None
    return hash(tuple(prompt[:AFFINITY_HEAD]))


class RouterHandle:
    """Client-facing future for one fleet request: the router's mirror of
    the replica-side RequestHandle (tokens so far, completion, timing), plus
    the fleet bookkeeping (assignments, failovers, hedges, late drops) the
    chaos drill asserts on. Thread-safe via the owning Router's lock."""

    QUEUED = "queued"
    RUNNING = "running"
    DONE = "done"
    CANCELLED = "cancelled"

    def __init__(self, request_id: int, tenant: str, prompt: List[int],
                 max_new_tokens: Optional[int], key: str, seed: int,
                 now: float,
                 deadline_s: Optional[float] = None,
                 ttft_deadline_s: Optional[float] = None,
                 temperature: Optional[float] = None,
                 top_k: Optional[int] = None,
                 hedge_ttft_s: Optional[float] = None):
        self.request_id = request_id
        self.tenant = tenant
        self.prompt = prompt
        self.prompt_len = len(prompt)
        self.affinity = affinity_key(prompt)
        self.max_new_tokens = max_new_tokens
        self.key = key  # the fleet-wide idempotency key (client_req_id)
        # the pinned sampling identity: forwarded EXPLICITLY on every
        # (re-)submit so failover/hedge re-execution draws the same tokens
        # on any replica — replica-local seed defaults would diverge
        self.seed = seed
        self.temperature = temperature
        self.top_k = top_k
        self.hedge_ttft_s = hedge_ttft_s
        self.status = self.QUEUED
        self.tokens: List[int] = []
        self.finish_reason: Optional[str] = None
        self.t_submit = now
        self.t_first_token: Optional[float] = None
        self.t_done: Optional[float] = None
        self.t_deadline = None if deadline_s is None else now + float(deadline_s)
        self.t_ttft_deadline = (
            None if ttft_deadline_s is None else now + float(ttft_deadline_s)
        )
        # live assignments: replica_id -> replica-side request id (two
        # entries only while a hedge is in flight)
        self.assignments: Dict[str, int] = {}
        self.delivered_by: Optional[str] = None
        self.failovers = 0
        self.hedged = False
        self.late_drops = 0
        # endpoints whose late answer was already counted: a healed
        # replica's re-registration maps the request again for its new
        # pump, and one answer seen by two pumps is still one late winner
        self.late_from: Set[Tuple[str, int]] = set()
        self.t_parked: Optional[float] = None
        self._router: Optional["Router"] = None
        # terminal-state latch, written ONLY under the owning Router's lock
        # (first writer wins): delivery, cancel, park-expiry and shed-discard
        # all race here, and `_event.is_set()` alone leaves a window between
        # deciding and waking where a second writer could overwrite the
        # status a waiter already observed
        self._finished = False
        self._event = threading.Event()

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def cancel(self) -> bool:
        if self._router is None or self.done:
            return False
        return self._router.cancel(self.request_id)

    def result(self, timeout: Optional[float] = None,
               cancel_on_timeout: bool = True) -> List[int]:
        if not self._event.wait(timeout):
            if cancel_on_timeout:
                self.cancel()
            raise TimeoutError(
                f"fleet request {self.request_id} not done after {timeout}s"
            )
        if self.status == self.CANCELLED:
            raise RuntimeError(
                f"fleet request {self.request_id} cancelled "
                f"({self.finish_reason})"
            )
        return self.tokens

    def _finish_locked(self, status: str, reason: Optional[str],
                       now: float) -> bool:
        """Write the terminal state (caller holds the Router lock); False
        when another writer already finished this handle. The caller fires
        `_event` OUTSIDE the lock after a True return."""
        if self._finished:
            return False
        self._finished = True
        self.status = status
        self.finish_reason = reason
        self.t_done = now
        return True


class Router:
    """The routing core: usable in-process (benches, drills) or wrapped by
    `RouterServer` for the TCP surface. start()/stop() manage the reaper;
    replica pumps start at registration."""

    # consecutive pump/submit connection failures before a LIVE replica is
    # declared dead (lease expiry is the other, slower detector)
    CONN_FAILURE_EVICT = 3

    def __init__(
        self,
        lease_s: float = 5.0,
        poll_interval_s: float = 0.02,
        hedge_ttft_s: Optional[float] = None,
        late_grace_s: Optional[float] = None,
        drain_deadline_s: float = 30.0,
        park_give_up_s: Optional[float] = None,
        handle_ttl_s: float = 600.0,
        replica_client_kw: Optional[dict] = None,
    ):
        self.fleet = FleetView(lease_s)
        self.poll_interval_s = float(poll_interval_s)
        # router-level TTFT hedge default; per-request submit() wins
        self.hedge_ttft_s = hedge_ttft_s
        # how long an evicted replica's pump keeps polling for LATE winners
        # (the partitioned-then-healed case the dedup map exists for)
        self.late_grace_s = (
            float(late_grace_s) if late_grace_s is not None
            else max(4.0 * lease_s, 10.0)
        )
        self.drain_deadline_s = float(drain_deadline_s)
        # an unplaceable request (every replica gone) parks this long before
        # failing with the named reason 'replica_lost'
        self.park_give_up_s = (
            float(park_give_up_s) if park_give_up_s is not None
            else max(2.0 * lease_s, 5.0)
        )
        self.handle_ttl_s = float(handle_ttl_s)
        # per-incarnation identity: minted fresh for every Router
        # object and echoed on replica register/heartbeat replies, so agents
        # can fence control hints by WHICH router incarnation issued them —
        # a healed old primary's stale replies are recognizably not ours.
        # A RouterStandby overwrites this with its election token.
        self.instance = mint_instance_token()
        self._replica_client_kw = dict(
            replica_client_kw or {"timeout": 5.0, "retries": 2}
        )
        self._lock = threading.Lock()
        self._handles: Dict[int, RouterHandle] = {}
        self._by_key: Dict[Tuple[str, str], int] = {}
        self._unassigned: Set[int] = set()
        self._ids = itertools.count()
        # per-replica submit-path clients (shared, serialized by a lock —
        # MasterClient is one socket); pumps own a separate connection
        self._submit_clients: Dict[str, Tuple[threading.Lock, MasterClient]] = {}
        self._pumps: List[threading.Thread] = []
        self._stop = threading.Event()
        self._reaper: Optional[threading.Thread] = None
        # push-streaming seam: pumps bump this sequence whenever
        # a mirror grows or finishes; RouterServer pusher threads diff the
        # handle's token mirror and write frames on their own time — the
        # pump threads never touch a client socket
        self._stream_cv = threading.Condition()
        self._stream_seq = 0
        # prefix-affinity books: affinity key ->
        # replica_id of the LAST successful assignment with that prompt
        # head, bounded LRU (guarded by self._lock). Dispatch prefers the
        # mapped replica within FleetView.AFFINITY_SLACK; a failover simply
        # re-points the key at the surviving replica it lands on.
        self._affinity: "collections.OrderedDict[int, str]" = (
            collections.OrderedDict()
        )
        self.affinity_cap = 4096
        self.affinity_hits = 0     # assignments landed on the affine replica
        self.affinity_misses = 0   # keyed assignments that landed elsewhere
        # fleet counters (also exported via obs metrics)
        self.submitted = 0
        self.completed = 0
        self.failovers = 0
        self.hedges = 0
        self.late_results_dropped = 0
        self.shed = 0
        self.replica_evictions = 0
        self.drains_completed = 0
        # requests this incarnation ADOPTED from replica state via the
        # takeover sweep (it never saw their submit — a dead predecessor did)
        self.adopted = 0

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "Router":
        if self._reaper is None:
            self._reaper = threading.Thread(
                target=self._reap_loop, name="router-reaper", daemon=True
            )
            self._reaper.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._reaper is not None:
            self._reaper.join(timeout=5.0)
        for t in list(self._pumps):
            t.join(timeout=5.0)
        with self._lock:
            clients = list(self._submit_clients.values())
            self._submit_clients.clear()
        for _lk, c in clients:
            c.close()

    # -- replica membership (RouterServer RPC surface) -----------------------
    def register_replica(self, endpoint: Sequence,
                         load: Optional[dict] = None) -> dict:
        rep = self.fleet.register((endpoint[0], int(endpoint[1])))
        if load:
            rep.load = dict(load)
        # takeover sweep — BEFORE the pump starts, so the first
        # pump cycle already polls every adopted request. For a fresh
        # replica this is one cheap empty-reply RPC; for a replica
        # re-registering after a router takeover (or an eviction it
        # outlived) it rebuilds this incarnation's in-flight/dedup books
        # from the data plane. Cold path: once per registration EVENT.
        self._sweep_replica(rep)
        pump = threading.Thread(
            target=self._pump_loop, args=(rep,),
            name=f"router-pump-{rep.replica_id}", daemon=True,
        )
        self._pumps.append(pump)
        pump.start()
        stats.FT_EVENTS.incr("router_replica_joined")
        log.info("replica %s joined at %s:%d", rep.replica_id, *rep.endpoint)
        return {"replica_id": rep.replica_id, "lease_s": self.fleet.lease_s,
                "instance": self.instance}

    def replica_heartbeat(self, replica_id: Optional[str],
                          load: Optional[dict] = None) -> dict:
        # every reply names this incarnation: the agent's fencing compares
        # it against the incarnation it registered with
        rep = self.fleet.heartbeat(replica_id, load)
        if rep is None:
            return {"ok": False, "reregister": True,
                    "instance": self.instance}
        if rep.drained:
            return {"ok": True, "drained": True, "instance": self.instance}
        if rep.state == ReplicaState.DRAINING:
            return {"ok": True, "drain": True, "instance": self.instance}
        if rep.state not in (ReplicaState.LIVE,):
            # evicted lease the replica outlived (wedge healed, partition
            # closed): rejoin fresh; the old pump still catches late results
            return {"ok": False, "reregister": True,
                    "instance": self.instance}
        return {"ok": True, "instance": self.instance}

    # -- takeover sweep ------------------------------------------------------
    def _sweep_replica(self, rep: Replica) -> None:
        """Stateless-reconciling takeover: ask a just-registered replica for
        every keyed request it still holds (in flight AND server-held
        results) and rebuild the fleet books — handles, the (tenant, key)
        dedup map, rid mappings, seeds. After a router death the data plane
        is the only copy of this state; one sweep per registration event
        recovers it without a journal. Connection/err failures degrade to
        an empty sweep: the replica is simply treated as fresh."""
        lock, client = self._submit_client(rep)
        try:
            with lock:
                # rpc-ok: ONE sweep call per replica registration event
                # (cold path — never in the pump/dispatch/reap loops)
                resp = client.call("outstanding")
        except (ConnectionError, OSError):
            return
        items = resp.get("requests") or []
        if not items:
            return
        # clock-ok: one admission stamp for the whole adopted batch
        now = time.monotonic()
        adopted = 0
        with self._lock:
            for item in items:
                try:
                    adopted += self._adopt_locked(rep, item, now)
                except (KeyError, TypeError, ValueError):
                    continue  # one malformed item must not void the sweep
        if adopted:
            stats.FT_EVENTS.incr("router_requests_adopted", adopted)
            log.warning(
                "takeover sweep: adopted %d request(s) from replica %s",
                adopted, rep.replica_id,
            )
        self._notify_streams()

    def _adopt_locked(self, rep: Replica, item: dict, now: float) -> int:
        """Fold one `outstanding` item into the books (caller holds the
        lock). Returns 1 when a NEW handle was minted (this incarnation
        never saw the request), 0 for a key we already track — in which
        case the replica's copy is mapped as an additional assignment and
        the dedup latch arbitrates: first terminal answer wins, the other
        is dropped-and-counted exactly like a hedge loser or late winner."""
        tenant = str(item.get("tenant_id") or "default")
        key = str(item["client_req_id"])
        rrid = int(item["request_id"])
        rid = self._by_key.get((tenant, key))
        h = self._handles.get(rid) if rid is not None else None
        if h is None:
            rid = next(self._ids)
            h = RouterHandle(
                rid, tenant, [int(t) for t in item.get("prompt") or []],
                item.get("max_new_tokens"), key,
                # re-pin the seed from replica state: a later failover of
                # this request re-submits under the SAME sampling identity,
                # so re-execution is token-identical, greedy AND sampled
                seed=int(item.get("seed") or 0) & 0xFFFFFFFF,
                now=now,
                temperature=item.get("temperature"),
                top_k=item.get("top_k"),
            )
            h._router = self
            h.status = RouterHandle.RUNNING
            self._handles[rid] = h
            self._by_key[(tenant, key)] = rid
            self.adopted += 1
            fresh = 1
        else:
            fresh = 0
        if h._finished:
            # already delivered by a survivor: map the replica's copy for
            # polling only, so its eventual answer lands in the dedup latch
            # (dropped + counted), never re-delivered
            rep.rids[h.request_id] = rrid
            return fresh
        rep.rids[h.request_id] = rrid
        rep.outstanding.add(h.request_id)
        h.assignments[rep.replica_id] = rrid
        self._unassigned.discard(h.request_id)
        h.t_parked = None
        return fresh

    def get_by_key(self, tenant: str, key: str) -> Optional[RouterHandle]:
        """Resolve a request by its (tenant, client_req_id) identity — what
        a client reattaching across a takeover presents when its request_id
        names a dead incarnation's books."""
        with self._lock:
            rid = self._by_key.get((str(tenant), str(key)))
            return self._handles.get(rid) if rid is not None else None

    def deregister_replica(self, replica_id: Optional[str]) -> bool:
        rep = self.fleet.get(replica_id) if replica_id else None
        if rep is None:
            return False
        self._evict(rep, "deregister")
        return True

    def drain(self, replica_id: str,
              deadline_s: Optional[float] = None) -> dict:
        """Planned drain: stop new assignments now; in-flight streams get
        until the deadline (then fail over); the lease drops when empty."""
        rep = self.fleet.get(replica_id)
        if rep is None or rep.state not in (
            ReplicaState.LIVE, ReplicaState.DRAINING
        ):
            return {"err": f"no live replica {replica_id!r}"}
        # clock-ok: once per drain ORDER (an operator/controller action)
        now = time.monotonic()
        with self._lock:
            rep.state = ReplicaState.DRAINING
            rep.drain_deadline = now + float(
                deadline_s if deadline_s is not None else self.drain_deadline_s
            )
            outstanding = len(rep.outstanding)
        stats.FT_EVENTS.incr("router_drain_ordered")
        log.warning(
            "drain ordered for replica %s: %d stream(s) in flight, "
            "deadline %.1fs", replica_id, outstanding,
            rep.drain_deadline - now,
        )
        return {"ok": True, "replica_id": replica_id,
                "outstanding": outstanding}

    # -- client surface ------------------------------------------------------
    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: Optional[int] = None,
        tenant: str = "default",
        deadline_s: Optional[float] = None,
        ttft_deadline_s: Optional[float] = None,
        temperature: Optional[float] = None,
        top_k: Optional[int] = None,
        seed: Optional[int] = None,
        client_req_id: Optional[str] = None,
        hedge_ttft_s: Optional[float] = None,
    ) -> RouterHandle:
        """Dispatch one request to the least-loaded live replica. Raises
        QuotaExceeded (reason 'overload', tightest retry_after_ms across the
        fleet) when no replica will take it — the fleet-wide shed; a shed
        submit leaves no state behind, so the client's retry is a fresh
        request. A repeated (tenant, client_req_id) reattaches to the
        original handle (the fleet-level dedup map)."""
        # clock-ok: once per SUBMIT (admission stamp; deadlines, hedge and
        # park timing all derive from it) — never per replica tried
        now = time.monotonic()
        prompt = [int(t) for t in prompt]
        with self._lock:
            if client_req_id is not None:
                rid = self._by_key.get((tenant, str(client_req_id)))
                if rid is not None and rid in self._handles:
                    return self._handles[rid]  # idempotent reattach
            rid = next(self._ids)
            key = client_req_id if client_req_id is not None else f"fleet-{rid}"
            h = RouterHandle(
                rid, tenant, prompt, max_new_tokens, str(key),
                seed=(int(seed) if seed is not None else rid) & 0xFFFFFFFF,
                now=now, deadline_s=deadline_s,
                ttft_deadline_s=ttft_deadline_s,
                temperature=temperature, top_k=top_k,
                hedge_ttft_s=(
                    hedge_ttft_s if hedge_ttft_s is not None
                    else self.hedge_ttft_s
                ),
            )
            h._router = self
            self._handles[rid] = h
            self._by_key[(tenant, str(key))] = rid
            self.submitted += 1
        live = self.fleet.live()
        if not live:
            self._discard(h, now)
            self.shed += 1
            obs_metrics.observe_router_shed("no_replicas")
            raise QuotaExceeded(
                "no live replicas behind the router", "overload",
                retry_after_ms=int(self.fleet.lease_s * 1000),
            )
        if deadline_s is not None and deadline_s > 0:
            # fleet-wide proactive shed, pure piggybacked state: when EVERY
            # live replica's own queue-wait estimate already exceeds the
            # request's budget, forwarding would only collect N shed replies
            waits = [
                float(r.load.get("estimated_queue_wait_s", 0.0) or 0.0)
                for r in live
            ]
            if waits and min(waits) > float(deadline_s):
                self._discard(h, now)
                self.shed += 1
                obs_metrics.observe_router_shed("overload")
                raise QuotaExceeded(
                    f"fleet saturated: best replica queue-wait estimate "
                    f"{min(waits):.2f}s exceeds the {deadline_s:.2f}s "
                    f"deadline budget", "overload",
                    retry_after_ms=max(1, int(min(waits) * 1000)),
                )
        try:
            ok, hints = self._try_assign(h, now=now, park_on_fail=False)
        except _BadRequest:
            # the replica refused for a non-load reason (bad prompt, over
            # max_len): the client's error — leave no fleet state behind
            self._discard(h, now)
            raise
        if not ok:
            self._discard(h, now)
            self.shed += 1
            obs_metrics.observe_router_shed("overload")
            hint = min([x for x in hints if x is not None], default=None)
            raise QuotaExceeded(
                "every live replica shed this request", "overload",
                retry_after_ms=(
                    hint if hint is not None
                    else int(self.fleet.lease_s * 1000)
                ),
            )
        return h

    def get_handle(self, request_id: int) -> Optional[RouterHandle]:
        with self._lock:
            return self._handles.get(int(request_id))

    def _notify_streams(self) -> None:
        """Wake RouterServer frame pushers: a mirror advanced or a handle
        reached a terminal state (same contract as the session's engine-step
        bump — no socket writes happen here)."""
        with self._stream_cv:
            self._stream_seq += 1
            self._stream_cv.notify_all()

    def stream_wait(self, seq: int, timeout: float = 0.25) -> int:
        """Block (pusher side) until the mirrors advance past `seq` or the
        timeout elapses; returns the current sequence."""
        with self._stream_cv:
            if self._stream_seq == seq:
                self._stream_cv.wait(timeout)
            return self._stream_seq

    def cancel(self, request_id: int) -> bool:
        # clock-ok: once per client CANCEL order, not on any per-step path
        now = time.monotonic()
        with self._lock:
            h = self._handles.get(int(request_id))
            if h is None or not h._finish_locked(
                RouterHandle.CANCELLED, FinishReason.CANCELLED, now
            ):
                # unknown, or a pump delivery won the race — the delivered
                # result stands, this cancel is a no-op
                return False
            cancels = self._strip_assignments_locked(h)
            self._unassigned.discard(h.request_id)
        self._send_cancels(cancels)
        h._event.set()
        self._notify_streams()
        return True

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            outstanding = sum(
                1 for h in self._handles.values() if not h.done
            )
            parked = len(self._unassigned)
        reps = [r.view() for r in self.fleet.replicas()]
        return {
            "replicas": reps,
            "live_replicas": sum(1 for r in reps if r["state"] == "live"),
            "submitted": self.submitted,
            "completed": self.completed,
            "outstanding": outstanding,
            "parked": parked,
            "failovers": self.failovers,
            "hedges": self.hedges,
            "late_results_dropped": self.late_results_dropped,
            "shed": self.shed,
            "replica_evictions": self.replica_evictions,
            "drains_completed": self.drains_completed,
            "adopted_requests": self.adopted,
            "affinity_hits": self.affinity_hits,
            "affinity_misses": self.affinity_misses,
            "instance": self.instance,
            # the tightest current queue-wait estimate across live replicas:
            # what a load balancer above THIS tier would piggyback on
            "estimated_queue_wait_s": min(
                [
                    float(r["load"].get("estimated_queue_wait_s", 0.0) or 0.0)
                    for r in reps if r["state"] == "live"
                ],
                default=0.0,
            ),
            # fleet-wide cumulative pressure counters, summed from the
            # piggybacked per-replica snapshots (fleet.LOAD_KEYS) — the
            # autoscaler's shed/deadline-miss signal, zero extra RPCs
            "fleet_shed": sum(
                int(r["load"].get("shed", 0) or 0)
                for r in reps if r["state"] == "live"
            ),
            "fleet_deadline_misses": sum(
                int(r["load"].get("deadline_misses", 0) or 0)
                for r in reps if r["state"] == "live"
            ),
        }

    # -- assignment path -----------------------------------------------------
    def _fail_parked(self, h: RouterHandle, reason: str, now: float) -> None:
        with self._lock:
            self._unassigned.discard(h.request_id)
            finished = h._finish_locked(RouterHandle.CANCELLED, reason, now)
        if finished:
            h._event.set()
            self._notify_streams()

    def _discard(self, h: RouterHandle, now: Optional[float] = None) -> None:
        """Remove a front-door-shed (or bad) request from the fleet books —
        and COMPLETE it cancelled first: a concurrent retry with the same
        idempotency key may have reattached to this handle between its
        registration and this shed, and that caller must get a prompt
        raise from result(), not a hang on a handle nobody owns anymore."""
        with self._lock:
            self._handles.pop(h.request_id, None)
            self._by_key.pop((h.tenant, h.key), None)
            finished = h._finish_locked(
                RouterHandle.CANCELLED, FinishReason.CANCELLED,
                now if now is not None else h.t_submit,
            )
        if finished:
            h._event.set()
            self._notify_streams()

    def _submit_client(self, rep: Replica) -> Tuple[threading.Lock, MasterClient]:
        with self._lock:
            got = self._submit_clients.get(rep.replica_id)
            if got is None:
                got = (
                    threading.Lock(),
                    MasterClient(rep.endpoint, **self._replica_client_kw),
                )
                self._submit_clients[rep.replica_id] = got
            return got

    def _choose_replica(self, exclude: Set[str],
                        affinity: Optional[int] = None) -> Optional[Replica]:
        """Pure piggybacked-state choice — no RPC lives here (pinned by the
        hot-path RPC budget test). With an affinity key, the replica that last served this prompt head
        is preferred (within the fleet's load slack); a dead or excluded
        affine replica degrades to plain least-loaded."""
        prefer = None
        if affinity is not None:
            with self._lock:
                prefer = self._affinity.get(affinity)
        return self.fleet.choose(exclude=exclude, prefer=prefer)

    def _try_assign(self, h: RouterHandle, now: float,
                    exclude: Optional[Set[str]] = None,
                    park_on_fail: bool = True) -> Tuple[bool, List[Optional[int]]]:
        """Walk replicas least-loaded-first until one accepts; collect shed
        hints. On total failure either park the request for the reaper's
        retry (failover path) or report back (front-door path)."""
        tried: Set[str] = set(exclude or ())
        hints: List[Optional[int]] = []
        while not h._finished:
            rep = self._choose_replica(tried, affinity=h.affinity)
            if rep is None:
                break
            try:
                self._forward(rep, h, now)
                return True, hints
            except QuotaExceeded as e:
                hints.append(e.retry_after_ms)
                tried.add(rep.replica_id)
            except _BadRequest:
                raise
            except (ConnectionError, OSError):
                tried.add(rep.replica_id)
                self._note_conn_failure(rep)
        if park_on_fail and not h._finished:
            with self._lock:
                if h.t_parked is None:
                    h.t_parked = now
                self._unassigned.add(h.request_id)
        return False, hints

    def _forward(self, rep: Replica, h: RouterHandle, now: float) -> None:
        """The ONE blocking RPC in the assignment path: forward the submit
        to the chosen replica under the fleet idempotency key + pinned seed,
        then record the assignment. Raises QuotaExceeded on a replica shed
        (hint attached), _BadRequest on a non-load refusal, ConnectionError
        when the replica is unreachable."""
        kw: Dict[str, Any] = dict(
            prompt=h.prompt, max_new_tokens=h.max_new_tokens,
            tenant_id=h.tenant, client_req_id=h.key, seed=h.seed,
            temperature=h.temperature, top_k=h.top_k,
        )
        if h.t_deadline is not None:
            kw["deadline_s"] = max(1e-3, h.t_deadline - now)
        if h.t_ttft_deadline is not None:
            kw["ttft_deadline_s"] = max(1e-3, h.t_ttft_deadline - now)
        lock, client = self._submit_client(rep)
        # span-ok: one ring write per ASSIGNMENT (submit/failover/hedge),
        # never per decode step or per poll cycle
        with trace.span("router.assign", request_id=h.request_id):
            with lock:
                # rpc-ok: the sanctioned submit forward — the single
                # blocking replica RPC the assignment path is allowed
                resp = client.call("submit", **kw)
        if "err" in resp:
            if resp.get("rejected"):
                raise QuotaExceeded(
                    str(resp["err"]), str(resp["rejected"]),
                    retry_after_ms=resp.get("retry_after_ms"),
                )
            raise _BadRequest(str(resp["err"]))
        rrid = int(resp["request_id"])
        with self._lock:
            if h.affinity is not None:
                # record (and LRU-refresh) the prompt-head -> replica map;
                # a failover landing elsewhere re-points the key so the
                # NEXT request with this head follows the warm cache
                if self._affinity.get(h.affinity) == rep.replica_id:
                    self.affinity_hits += 1
                else:
                    if h.affinity in self._affinity:
                        self.affinity_misses += 1
                    self._affinity[h.affinity] = rep.replica_id
                self._affinity.move_to_end(h.affinity)
                while len(self._affinity) > self.affinity_cap:
                    self._affinity.popitem(last=False)
            rep.rids[h.request_id] = rrid
            rep.outstanding.add(h.request_id)
            rep.assigned_total += 1
            h.assignments[rep.replica_id] = rrid
            if h.status == RouterHandle.QUEUED:
                h.status = RouterHandle.RUNNING
            self._unassigned.discard(h.request_id)
            h.t_parked = None
            evicted_meanwhile = rep.state not in (
                ReplicaState.LIVE, ReplicaState.DRAINING
            )
        if evicted_meanwhile:
            # the replica died between choose and record: hand the request
            # straight back to the failover path instead of stranding it
            self._failover_requests(rep, [h.request_id], "evicted_mid_assign")

    def _note_conn_failure(self, rep: Replica) -> None:
        with self._lock:
            rep.conn_failures += 1
            dead = (
                rep.state in (ReplicaState.LIVE, ReplicaState.DRAINING)
                and rep.conn_failures >= self.CONN_FAILURE_EVICT
            )
        if dead:
            self._evict(rep, "conn")

    # -- failover ------------------------------------------------------------
    def _strip_assignments_locked(self, h: RouterHandle) -> List[Tuple[str, int, str]]:
        """Drop every live assignment of `h` (caller holds self._lock);
        returns (replica_id, replica_rid, tenant) triples to cancel."""
        cancels = []
        for rep_id, rrid in list(h.assignments.items()):
            rep = self.fleet.get(rep_id)
            if rep is not None:
                rep.outstanding.discard(h.request_id)
                rep.rids.pop(h.request_id, None)
                rep.poll_cursors.pop(h.request_id, None)
            cancels.append((rep_id, rrid, h.tenant))
            del h.assignments[rep_id]
        return cancels

    def _send_cancels(self, cancels: List[Tuple[str, int, str]]) -> None:
        # pipelined: group per replica and ship each group as
        # ONE batch on the shared socket — a drain-timeout or multi-hedge
        # teardown stops paying a round trip per cancelled request
        by_rep: Dict[str, List[Tuple[int, str]]] = {}
        for rep_id, rrid, tenant in cancels:
            by_rep.setdefault(rep_id, []).append((rrid, tenant))
        for rep_id, batch in by_rep.items():
            rep = self.fleet.get(rep_id)
            if rep is None:
                continue
            lock, client = self._submit_client(rep)
            try:
                with lock:
                    # rpc-ok: per cancel/hedge-loser order, never per step
                    client.call_many([
                        ("cancel", {"request_id": rrid, "tenant_id": tenant})
                        for rrid, tenant in batch
                    ])
            except (ConnectionError, OSError):
                pass  # dead replica: nothing to cancel anymore

    def _evict(self, rep: Replica, cause: str) -> None:
        """A replica stopped being assignable (lease lapsed, connection
        dead, deregistered): fail its outstanding requests over to
        survivors. The pump keeps polling it for `late_grace_s` so a
        partitioned-not-dead replica's late answers land in the dedup map
        (dropped + counted) instead of vanishing unobserved."""
        # clock-ok: once per EVICTION event, not per request or per poll
        now = time.monotonic()
        with self._lock:
            if rep.state not in (ReplicaState.LIVE, ReplicaState.DRAINING):
                return
            rep.state = ReplicaState.EVICTED
            rep.evicted_at = now
            victims = sorted(rep.outstanding)
            rep.outstanding.clear()
        self.replica_evictions += 1
        self.fleet.evicted_total += 1
        stats.FT_EVENTS.incr("router_replica_evicted")
        obs_metrics.observe_replica_evicted(cause)
        log.warning(
            "replica %s evicted (%s); failing %d in-flight request(s) over",
            rep.replica_id, cause, len(victims),
        )
        self._failover_requests(rep, victims, cause, now=now)

    def _failover_requests(self, rep: Replica, rids: List[int], cause: str,
                           now: Optional[float] = None) -> None:
        if now is None:
            # clock-ok: once per failover BATCH (an eviction/drain event)
            now = time.monotonic()
        for rid in rids:
            with self._lock:
                h = self._handles.get(rid)
                if h is None:
                    continue
                h.assignments.pop(rep.replica_id, None)
                if h._finished or h.assignments:
                    continue  # delivered, or a hedge partner still lives
            h.failovers += 1
            self.failovers += 1
            obs_metrics.observe_replica_failover(cause)
            # span-ok: one ring write per FAILED-OVER request (rare path)
            with trace.span("router.failover", request_id=rid):
                self._try_assign(
                    h, now=now, exclude={rep.replica_id}, park_on_fail=True
                )

    def _finish_drain(self, rep: Replica) -> None:
        with self._lock:
            if rep.state != ReplicaState.DRAINING:
                return
            rep.state = ReplicaState.DRAINED
            rep.drained = True
        self.drains_completed += 1
        stats.FT_EVENTS.incr("router_drain_complete")
        log.warning("replica %s drained and deregistered", rep.replica_id)

    # -- result pump (one thread per replica) --------------------------------
    def _pump_loop(self, rep: Replica) -> None:
        client = MasterClient(
            rep.endpoint,
            timeout=self._replica_client_kw.get("timeout", 5.0),
            retries=1,
        )
        try:
            while not self._stop.is_set():
                ok = self._pump_once(rep, client)
                with self._lock:
                    if ok is True:
                        # only a SUCCESSFUL round trip resets the failure
                        # count: the no-op case (ok is None, nothing to
                        # poll) must not keep absolving an asymmetrically
                        # partitioned replica whose submit forwards fail —
                        # an idle replica scores least-loaded, so every
                        # submit would eat its connect timeout forever
                        rep.conn_failures = 0
                    state = rep.state
                    idle = not rep.rids
                    evicted_at = rep.evicted_at
                if ok is False:
                    self._note_conn_failure(rep)
                if state == ReplicaState.EVICTED:
                    # grace window: keep polling a possibly-partitioned
                    # replica so late winners reach the dedup map
                    if (idle or time.monotonic()  # clock-ok: grace check,
                            # once per pump cycle while evicted
                            > (evicted_at or 0.0) + self.late_grace_s):
                        break
                if state == ReplicaState.DRAINED and idle:
                    break
                if self._stop.wait(self.poll_interval_s):
                    break
        finally:
            with self._lock:
                rep.state = ReplicaState.CLOSED
                sc = self._submit_clients.pop(rep.replica_id, None)
            if sc is not None:
                sc[1].close()
            client.close()

    def _pump_once(self, rep: Replica,
                   client: MasterClient) -> Optional[bool]:
        """One batch poll of every request still mapped on this replica —
        ONE round trip regardless of in-flight count. Returns True on a
        successful round trip, False on a connection failure (the loop
        counts those toward eviction), None when there was nothing to poll
        (no RPC happened — proves nothing about the connection)."""
        with self._lock:
            pairs = [
                (rid, rrid, self._handles[rid].tenant,
                 rep.poll_cursors.get(rid, 0))
                for rid, rrid in rep.rids.items()
                if rid in self._handles
            ]
        if not pairs:
            return None
        # delta poll: each item names the cursor this pump
        # already folded, so steady-state cycles move O(new tokens) per
        # request instead of O(all tokens) — the replica clamps a stale
        # cursor back to a full reply, so this is never a correctness seam
        items = [
            {"request_id": rrid, "tenant_id": tenant, "from": cur}
            for _, rrid, tenant, cur in pairs
        ]
        try:
            # rpc-ok: the sanctioned batch poll — per pump CYCLE per
            # replica, never per request
            resp = client.call("poll_many", items=items)
        except (ConnectionError, OSError):
            return False
        # clock-ok: ONE wall-clock read per pump cycle stamps every result
        # processed from this batch (TTFT mirrors, completion times)
        now = time.monotonic()
        by_rrid = {}
        for entry in resp.get("results", []):
            if isinstance(entry, dict) and "request_id" in entry:
                by_rrid[int(entry["request_id"])] = entry
        for rid, rrid, _tenant, _cur in pairs:
            entry = by_rrid.get(rrid)
            if entry is not None:
                self._on_result(rep, rid, entry, now)
        return True

    def _on_result(self, rep: Replica, rid: int, entry: dict,
                   now: float) -> None:
        """Fold one poll_many entry into the fleet books. The dedup latch
        lives here: the FIRST terminal result for a fleet request wins; a
        later one (the failed-over original finally answering) is dropped
        and counted."""
        delivered = False
        grew = False
        cancels: List[Tuple[str, int, str]] = []
        late = dropped = False
        with self._lock:
            h = self._handles.get(rid)
            if h is None:
                rep.rids.pop(rid, None)
                rep.poll_cursors.pop(rid, None)
                rep.outstanding.discard(rid)
                return
            if entry.get("err"):
                # the replica no longer knows this id (process restart,
                # handle GC): that assignment is void — re-place unless a
                # partner still runs it
                rep.rids.pop(rid, None)
                rep.poll_cursors.pop(rid, None)
                rep.outstanding.discard(rid)
                h.assignments.pop(rep.replica_id, None)
                if not h._finished and not h.assignments:
                    if h.t_parked is None:
                        h.t_parked = now
                    self._unassigned.add(rid)
                return
            toks = [int(t) for t in (entry.get("tokens") or [])]
            if not entry.get("done"):
                base = entry.get("from")
                # advance this pump's cursor to what the replica now holds
                # (a delta reply echoes tokens_so_far; a legacy full reply
                # just counts its tokens)
                rep.poll_cursors[rid] = (
                    int(entry.get("tokens_so_far", len(toks)))
                    if base is not None else len(toks)
                )
                if toks and not h._finished:
                    if base is None:
                        merged = toks  # legacy full-list reply
                    elif int(base) > len(h.tokens):
                        # cursor ran ahead of the mirror (stale books):
                        # drop the gapped suffix and refetch full next cycle
                        merged = None
                        rep.poll_cursors[rid] = 0
                    else:
                        merged = h.tokens[: int(base)] + toks
                    # grow-only: the mirror is a prefix-consistent record —
                    # a slower replica's shorter view never rolls it back
                    if merged is not None and len(merged) > len(h.tokens):
                        h.tokens = merged
                        grew = True
                        if h.t_first_token is None:
                            h.t_first_token = now
                    if (grew and len(h.assignments) > 1
                            and rep.replica_id in h.assignments):
                        # first token wins: cancel the hedge loser(s). Only
                        # a live assignment wins: a copy the router dropped
                        # (an evicted registration's, still polled for its
                        # late answer) must not cancel the ones it counts on
                        winner = rep.replica_id
                        for rep_id, rrid in list(h.assignments.items()):
                            if rep_id == winner:
                                continue
                            other = self.fleet.get(rep_id)
                            if other is not None:
                                other.outstanding.discard(rid)
                                other.rids.pop(rid, None)
                                other.poll_cursors.pop(rid, None)
                            cancels.append((rep_id, rrid, h.tenant))
                            del h.assignments[rep_id]
            else:
                rep.rids.pop(rid, None)
                rep.poll_cursors.pop(rid, None)
                rep.outstanding.discard(rid)
                assigned = h.assignments.pop(rep.replica_id, None) is not None
                status = (
                    RouterHandle.CANCELLED if entry.get("cancelled")
                    else RouterHandle.DONE
                )
                if (status == RouterHandle.CANCELLED and not assigned
                        and not h._finished):
                    # a copy the router no longer counts on (an evicted
                    # replica's, or one it cancelled itself as a hedge
                    # loser, seen through another registration of the same
                    # replica) was cancelled: that is not this request's
                    # answer, which its live assignment still owes (or, with
                    # none left, a re-placement)
                    if not h.assignments:
                        if h.t_parked is None:
                            h.t_parked = now
                        self._unassigned.add(rid)
                    return
                if not h._finish_locked(status, entry.get("finish_reason"),
                                        now):
                    # the late winner: already delivered from a survivor —
                    # drop, count, and leave the delivered result untouched
                    dropped = True
                    if rep.endpoint not in h.late_from:
                        h.late_from.add(rep.endpoint)
                        h.late_drops += 1
                        rep.late_results_dropped += 1
                        self.late_results_dropped += 1
                        late = True
                else:
                    h.delivered_by = rep.replica_id
                    if toks:
                        h.tokens = [int(t) for t in toks]
                        if h.t_first_token is None:
                            h.t_first_token = now
                    if status == RouterHandle.DONE:
                        self.completed += 1
                    delivered = True
                    cancels = self._strip_assignments_locked(h)
        if dropped:
            if late:
                stats.FT_EVENTS.incr("router_late_result_dropped")
                obs_metrics.observe_late_result_dropped()
            return
        if cancels:
            self._send_cancels(cancels)
        if delivered:
            h._event.set()
        if delivered or grew:
            self._notify_streams()

    # -- reaper --------------------------------------------------------------
    def _reap_loop(self) -> None:
        period = max(0.05, min(0.5, self.fleet.lease_s / 4.0))
        while not self._stop.wait(period):
            try:
                self._reap_once()
            except Exception:
                log.exception("router reaper tick failed")

    def _reap_once(self) -> None:
        """One maintenance tick: lease evictions, drain completion, parked
        re-assignment, hedge launches, handle GC — every decision off ONE
        timestamp."""
        # clock-ok: the single per-tick read every reaper decision batches on
        now = time.monotonic()
        for rep in self.fleet.expired(now):
            self._evict(rep, "lease")
        for rep in self.fleet.replicas():
            if rep.state != ReplicaState.DRAINING:
                continue
            with self._lock:
                empty = not rep.outstanding
                past = rep.drain_deadline is not None and now > rep.drain_deadline
                stragglers = sorted(rep.outstanding) if past else []
                cancels = []
                if past:
                    rep.outstanding.clear()
                    for rid in stragglers:
                        # unlike an eviction (replica presumed dead), a
                        # drain-timeout replica is ALIVE: cancel its copy so
                        # it stops decoding and releases slots + KV pages —
                        # otherwise the straggler runs twice and its
                        # eventual completion miscounts as a late winner
                        rrid = rep.rids.pop(rid, None)
                        rep.poll_cursors.pop(rid, None)
                        h = self._handles.get(rid)
                        if rrid is not None and h is not None:
                            cancels.append((rep.replica_id, rrid, h.tenant))
            if stragglers:
                log.warning(
                    "drain deadline passed on %s with %d stream(s) in "
                    "flight; cancelling there and failing them over",
                    rep.replica_id, len(stragglers),
                )
                self._send_cancels(cancels)
                self._failover_requests(rep, stragglers, "drain_timeout",
                                        now=now)
                empty = True
            if empty:
                self._finish_drain(rep)
        # parked (unplaceable) requests: retry, expire, or give up named
        with self._lock:
            parked = [
                self._handles[rid] for rid in list(self._unassigned)
                if rid in self._handles
            ]
        for h in parked:
            if h.done:
                with self._lock:
                    self._unassigned.discard(h.request_id)
                continue
            if h.t_deadline is not None and now >= h.t_deadline:
                self._fail_parked(h, FinishReason.DEADLINE, now)
                continue
            ok, _hints = self._try_assign(h, now=now, park_on_fail=True)
            if ok:
                continue
            if (not self.fleet.live()
                    and h.t_parked is not None
                    and now - h.t_parked > self.park_give_up_s):
                self._fail_parked(h, FinishReason.REPLICA_LOST, now)
        # hedging: duplicate token-less requests past their TTFT hedge onto
        # a second replica (same key + seed; first token wins)
        with self._lock:
            hedgeable = [
                h for h in self._handles.values()
                if (not h.done and h.hedge_ttft_s is not None
                    and not h.hedged and not h.tokens
                    and len(h.assignments) == 1
                    and now - h.t_submit >= h.hedge_ttft_s)
            ]
        for h in hedgeable:
            exclude = set(h.assignments)
            # span-ok: one ring write per HEDGE launch (TTFT-miss path)
            with trace.span("router.hedge", request_id=h.request_id):
                ok, _hints = self._try_assign(
                    h, now=now, exclude=exclude, park_on_fail=False
                )
            if ok:
                h.hedged = True
                self.hedges += 1
                stats.FT_EVENTS.incr("router_hedge")
                obs_metrics.observe_router_hedge()
        # GC finished handles past the TTL (submit-and-vanish clients)
        cutoff = now - self.handle_ttl_s
        with self._lock:
            stale = [
                rid for rid, h in self._handles.items()
                if h.done and (h.t_done or 0) < cutoff
            ]
            for rid in stale:
                h = self._handles.pop(rid)
                self._by_key.pop((h.tenant, h.key), None)
                self._unassigned.discard(rid)


class RouterServer:
    """The router behind the same line-JSON TCP surface a ServingServer
    exposes (reusing its request handler), so a `ServingClient` — and every
    retry/idempotency/hedging behavior it already has — talks to a router
    unchanged. Adds the replica-facing methods (replica_register /
    replica_heartbeat / replica_deregister) and the ops methods (drain /
    replicas)."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        lease_s: float = 5.0,
        tenant_lease_s: float = 30.0,
        **router_kw,
    ):
        self.router = Router(lease_s=lease_s, **router_kw)
        self.membership = _Membership(tenant_lease_s)
        self._srv = socketserver.ThreadingTCPServer(
            (host, port), _Handler, bind_and_activate=True
        )
        self._srv.daemon_threads = True
        self._srv.ctx = self  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None
        self._killed = False
        self.stream_frames = 0
        self.stream_bytes = 0
        self.stream_tokens = 0
        self.stream_coalesced = 0
        self.stream_active = 0  # pushers currently attached (fan-out gauge)
        self._stream_lock = threading.Lock()

    @property
    def address(self) -> tuple:
        return self._srv.server_address

    @property
    def fleet(self) -> FleetView:
        return self.router.fleet

    def dispatch(self, method: str, req: dict,
                 tenant_id: Optional[str]) -> dict:
        r = self.router
        if method == "register":
            tid = self.membership.register()
            return {"tenant_id": tid, "lease_s": self.membership.lease_s}
        if method == "heartbeat":
            return {"ok": bool(tenant_id)}
        if method == "deregister":
            if tenant_id:
                self.membership.drop(tenant_id)
            return {"ok": bool(tenant_id)}
        if method == "replica_register":
            ep = req.get("endpoint")
            if (not isinstance(ep, (list, tuple)) or len(ep) != 2):
                return {"err": f"replica_register needs endpoint [host, "
                               f"port], got {ep!r}"}
            return r.register_replica(ep, req.get("load"))
        if method == "replica_heartbeat":
            return r.replica_heartbeat(req.get("replica_id"), req.get("load"))
        if method == "replica_deregister":
            return {"ok": r.deregister_replica(req.get("replica_id"))}
        if method == "drain":
            return r.drain(str(req.get("replica_id")), req.get("deadline_s"))
        if method == "replicas":
            return {"replicas": [x.view() for x in r.fleet.replicas()]}
        if method == "stats":
            out = r.stats()
            out["live_tenants"] = self.membership.live
            out["stream_frames_pushed"] = self.stream_frames
            out["stream_bytes_pushed"] = self.stream_bytes
            out["stream_tokens_pushed"] = self.stream_tokens
            out["stream_frames_coalesced"] = self.stream_coalesced
            return out
        if method == "metrics":
            return {"text": obs_metrics.to_prometheus_text()}
        if method == "trace_export":
            return {"chrome_trace": trace.export_chrome()}
        if method in ("submit", "generate"):
            tenant = tenant_id or "default"
            try:
                h = r.submit(
                    req["prompt"], req.get("max_new_tokens"), tenant=tenant,
                    deadline_s=req.get("deadline_s"),
                    ttft_deadline_s=req.get("ttft_deadline_s"),
                    temperature=req.get("temperature"),
                    top_k=req.get("top_k"),
                    seed=req.get("seed"),
                    client_req_id=req.get("client_req_id"),
                    hedge_ttft_s=req.get("hedge_ttft_s"),
                )
            except _BadRequest as e:
                # the replica's own error text, unwrapped: a client talking
                # to the router must see the same err shape it would get
                # from one server ("ValueError: empty prompt"), not the
                # router's internal exception class
                return {"err": str(e)}
            if method == "submit":
                out = {"request_id": h.request_id}
                if req.get("stream"):
                    # push streaming THROUGH the router: frames
                    # follow on this connection as the pump advances the
                    # mirror; the pump's poll stays authoritative
                    out["stream"] = True
                    out["_stream"] = (h, 0)
                return out
            try:
                h.result(timeout=float(req.get("timeout_s", 120.0)),
                         cancel_on_timeout=False)
            except TimeoutError:
                return {
                    "err": "generate timed out router-side; still running",
                    "request_id": h.request_id, "done": False,
                }
            except RuntimeError:
                pass  # cancelled: _completion names the reason
            return dict(self._completion(h), request_id=h.request_id)
        if method in ("poll", "cancel", "stream"):
            if req.get("client_req_id"):
                # identity is the (tenant, client_req_id) key, NOT the rid:
                # after a takeover this incarnation's rid counter restarted,
                # so the client's stale rid may name a DIFFERENT request —
                # resolving by rid would hand it someone else's tokens. The
                # takeover sweep rebuilt the key map from replica state;
                # a key miss means the request is not in these books.
                h = r.get_by_key(tenant_id or "default",
                                 str(req["client_req_id"]))
            else:
                h = r.get_handle(int(req["request_id"]))
            if h is None:
                return {"err": f"unknown request_id {req['request_id']}"}
            if h.tenant != (tenant_id or "default"):
                return {"err": "request belongs to another tenant"}
            if method == "cancel":
                return {"cancelled": r.cancel(h.request_id), "done": h.done}
            if method == "stream":
                cur = clamp_cursor(req.get("from"), len(h.tokens))
                return {
                    "request_id": h.request_id, "stream": True,
                    "from": cur, "_stream": (h, cur),
                }
            if not h.done:
                toks = list(h.tokens)
                cur = clamp_cursor(req.get("from"), len(toks))
                return {"done": False, "tokens_so_far": len(toks),
                        "tokens": toks[cur:], "from": cur}
            return self._completion(h)
        return {"err": f"unknown method {method!r}"}

    @staticmethod
    def _completion(h: RouterHandle) -> dict:
        return {
            "done": True,
            "tokens": list(h.tokens),
            "finish_reason": h.finish_reason,
            "cancelled": h.status == RouterHandle.CANCELLED,
        }

    # -- push-stream plumbing (shared with server._Handler._push_frames) ----
    def stream_wait(self, seq: int, timeout: float = 0.25) -> int:
        return self.router.stream_wait(seq, timeout)

    @staticmethod
    def _stream_final(h: RouterHandle) -> dict:
        return {
            "done": True,
            "finish_reason": h.finish_reason,
            "cancelled": h.status == RouterHandle.CANCELLED,
        }

    def note_frames(self, n: int, nbytes: int = 0, ntokens: int = 0,
                    coalesced: int = 0) -> None:
        with self._stream_lock:
            self.stream_frames += n
            self.stream_bytes += nbytes
            self.stream_tokens += ntokens
            self.stream_coalesced += coalesced
        stats.FT_EVENTS.incr("router_stream_frames", n)

    def note_stream(self, delta: int) -> None:
        with self._stream_lock:
            self.stream_active += delta

    def start(self) -> "RouterServer":
        self.router.start()
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._killed:
            return
        if self._thread is not None:
            self._srv.shutdown()
        self._srv.server_close()
        self.router.stop()

    def kill(self) -> None:
        """Fault injection (chaos drills, HA tests): die abruptly — stop
        accepting, drop the port, answer nothing. No drain, no goodbye to
        replicas or clients; the standby's probe loop and the replicas'
        heartbeat rotation are what must notice. Mirrors ServingServer.kill."""
        self._killed = True
        self.router._stop.set()

        def _die():
            try:
                self._srv.shutdown()
                self._srv.server_close()
            except OSError:
                pass

        threading.Thread(target=_die, name="router-kill", daemon=True).start()


class RouterStandby:
    """Warm standby for the serving router, on the shared
    election primitive (`runtime/election.py`). Watches the primary's TCP
    port; after N strikes plus one patient confirmation probe it binds its
    OWN port and becomes the fleet's router — *stateless-reconciling*
    takeover, no journal, no replicated log:

      - replicas carry both endpoints; their heartbeat rotation finds the
        standby, the unknown-id `reregister` hint heals leases, and
        `register_replica`'s takeover sweep rebuilds the in-flight/dedup
        books from each replica's `outstanding` reply (prompt, seed,
        temperature, tokens so far, server-held results);
      - clients carry both endpoints too; their retry/reattach path
        presents the (tenant, client_req_id) key, which the rebuilt key
        map resolves even though request ids restarted;
      - the election token becomes this incarnation's `Router.instance`,
        fencing replica agents against a healed old primary.

    The standby binds at TAKEOVER, not at construction: two live routers
    must never answer the same fleet, and an un-elected standby holding a
    bound port would look alive to the other standby's probes."""

    def __init__(self, primary: EndpointsLike, host: str = "127.0.0.1",
                 port: int = 0, poll_s: float = 0.2,
                 confirm_failures: int = 2,
                 max_wait_s: Optional[float] = None,
                 stop_evt: Optional[threading.Event] = None,
                 lease_s: float = 5.0, tenant_lease_s: float = 30.0,
                 **router_kw):
        self.primary = primary
        self.host, self.port = host, int(port)
        self.poll_s = float(poll_s)
        self.confirm_failures = int(confirm_failures)
        self.max_wait_s = max_wait_s
        self.stop_evt = stop_evt
        self.lease_s = float(lease_s)
        self.tenant_lease_s = float(tenant_lease_s)
        self.router_kw = router_kw

    def run(self) -> Optional["RouterServer"]:
        """Block watching the primary; on confirmed death return a STARTED
        RouterServer whose `Router.instance` is the election token. None
        when stopped or timed out with the primary still alive."""
        token = watch_primary(
            self.primary, plane="router", poll_s=self.poll_s,
            confirm_failures=self.confirm_failures,
            max_wait_s=self.max_wait_s, stop_evt=self.stop_evt,
        )
        if token is None:
            return None
        srv = RouterServer(
            host=self.host, port=self.port, lease_s=self.lease_s,
            tenant_lease_s=self.tenant_lease_s, **self.router_kw,
        )
        srv.router.instance = token
        log.warning(
            "router standby (incarnation %s) taking over on %s:%d",
            token, *srv.address,
        )
        return srv.start()


def _main(argv: Optional[List[str]] = None) -> int:
    """`python -m paddle_tpu_torch.serving.router serve|standby|drain|status`:
    the router as its own process, the warm-standby role and the operator
    levers. `serve --autoscale` runs the autoscaler controller beside the
    router (`runtime/autoscaler.py`), with the JAX package's `--autoscale*`
    flags; the port adds `--autoscale_config` (a JSON object of further
    `ScaleConfig` fields: cooldowns, thresholds, quiet period) and
    `--autoscale_spawn_log_dir` (where spawned replicas write their
    output)."""
    import argparse
    import json
    import signal as _signal

    ap = argparse.ArgumentParser(prog="paddle_tpu_torch.serving.router")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sv = sub.add_parser("serve", help="run a router in front of N replicas")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=0)
    sv.add_argument("--lease_s", type=float, default=5.0,
                    help="replica lease: silence past this is eviction + "
                         "in-flight failover")
    sv.add_argument("--hedge_ttft_s", type=float, default=0.0,
                    help="fleet default TTFT hedge (0 = off): a token-less "
                         "request past this is duplicated onto a second "
                         "replica, first token wins")
    sv.add_argument("--drain_deadline_s", type=float, default=30.0)
    # the autoscaler beside this router: it watches the stats this process
    # already aggregates from heartbeats and pulls the spawn/drain (and,
    # with --autoscale_master, training resize) levers. The router never
    # depends on it: kill the controller and the fleet is simply static.
    sv.add_argument("--autoscale", action="store_true",
                    help="run an autoscaler controller for this router's "
                         "fleet (see paddle_tpu_torch/runtime/autoscaler.py)")
    sv.add_argument("--autoscale_master", default=None,
                    help="master host:port — arms the training resize "
                         "lever so training borrows idle serving chips")
    sv.add_argument("--autoscale_tick_s", type=float, default=1.0)
    sv.add_argument("--autoscale_chips", type=int, default=8,
                    help="total chip budget arbitrated across both fleets")
    sv.add_argument("--autoscale_min_replicas", type=int, default=1)
    sv.add_argument("--autoscale_max_replicas", type=int, default=8)
    sv.add_argument("--autoscale_spawn_arg", action="append", default=None,
                    help="repeatable: extra argv for spawned replicas "
                         "(default: --demo)")
    sv.add_argument("--autoscale_config", default=None,
                    help="JSON object of further ScaleConfig fields, e.g. "
                         "'{\"serving_cooldown_s\": 4, \"startup_quiet_s\": 1}'")
    sv.add_argument("--autoscale_spawn_log_dir", default=None,
                    help="write each spawned replica's stdout/stderr there "
                         "(default: discarded)")
    sb = sub.add_parser(
        "standby",
        help="watch a primary router; take over its fleet when it dies "
             "(replicas and clients must carry this standby's endpoint in "
             "their --router_endpoints list)",
    )
    sb.add_argument("--primary", required=True, help="primary host:port")
    sb.add_argument("--host", default="127.0.0.1")
    sb.add_argument("--port", type=int, default=0)
    sb.add_argument("--lease_s", type=float, default=5.0)
    sb.add_argument("--hedge_ttft_s", type=float, default=0.0)
    sb.add_argument("--drain_deadline_s", type=float, default=30.0)
    sb.add_argument("--poll_s", type=float, default=0.2)
    sb.add_argument("--max_wait_s", type=float, default=None,
                    help="give up after this long with the primary healthy")
    for name in ("drain", "status"):
        p = sub.add_parser(name)
        p.add_argument("--endpoint", required=True, help="router host:port")
        if name == "drain":
            p.add_argument("--replica", required=True,
                           help="replica id (see `status`)")
            p.add_argument("--deadline_s", type=float, default=None)
    args = ap.parse_args(argv)

    if args.cmd == "serve":
        extra_cfg = json.loads(args.autoscale_config) if args.autoscale_config else {}
        srv = RouterServer(
            host=args.host, port=args.port, lease_s=args.lease_s,
            hedge_ttft_s=args.hedge_ttft_s or None,
            drain_deadline_s=args.drain_deadline_s,
        ).start()
        ctl = None
        if args.autoscale:
            from paddle_tpu_torch.runtime.autoscaler import (
                AutoscalerController, ReplicaSpawner, ScaleConfig,
            )

            ctl = AutoscalerController(
                router_endpoints=srv.address,
                master_endpoints=args.autoscale_master,
                config=ScaleConfig(
                    chips_total=args.autoscale_chips,
                    min_replicas=args.autoscale_min_replicas,
                    max_replicas=args.autoscale_max_replicas,
                    **extra_cfg,
                ),
                spawner=ReplicaSpawner(
                    srv.address,
                    extra_args=(args.autoscale_spawn_arg
                                if args.autoscale_spawn_arg is not None
                                else ["--demo"]),
                    log_dir=args.autoscale_spawn_log_dir,
                ),
                tick_s=args.autoscale_tick_s,
            ).start()

        def _shutdown(*_):
            if ctl is not None:
                ctl.stop()
            srv.stop()

        _signal.signal(_signal.SIGTERM, _shutdown)
        _signal.signal(_signal.SIGINT, _shutdown)
        print(json.dumps({"role": "router", "address": list(srv.address),
                          "autoscale": bool(args.autoscale)}),
              flush=True)
        while srv._thread is not None and srv._thread.is_alive():
            time.sleep(0.05)
        if ctl is not None:
            ctl.stop()
            if ctl.spawner is not None:
                ctl.spawner.stop_all()
            print(json.dumps({"role": "router", "autoscaler": ctl.stats()}),
                  flush=True)
        return 0
    if args.cmd == "standby":
        stop_evt = threading.Event()
        _signal.signal(_signal.SIGTERM, lambda *_: stop_evt.set())
        _signal.signal(_signal.SIGINT, lambda *_: stop_evt.set())
        srv = RouterStandby(
            args.primary, host=args.host, port=args.port,
            poll_s=args.poll_s, max_wait_s=args.max_wait_s,
            stop_evt=stop_evt, lease_s=args.lease_s,
            hedge_ttft_s=args.hedge_ttft_s or None,
            drain_deadline_s=args.drain_deadline_s,
        ).run()
        if srv is None:
            print(json.dumps({"role": "router_standby", "takeover": False}),
                  flush=True)
            return 3
        print(json.dumps({"role": "router_standby", "takeover": True,
                          "address": list(srv.address)}), flush=True)
        while srv._thread is not None and srv._thread.is_alive():
            time.sleep(0.05)
        srv.stop()
        return 0
    client = MasterClient(args.endpoint)
    try:
        if args.cmd == "drain":
            out = client.call("drain", replica_id=args.replica,
                              deadline_s=args.deadline_s)
        else:
            out = client.call("stats")
        print(json.dumps(out))
        return 0 if "err" not in out else 1
    finally:
        client.close()


if __name__ == "__main__":
    import sys

    sys.exit(_main())
