"""The task master and its RPC plane (the port's copy of
`paddle_tpu/runtime/master.py`; go/master parity, SURVEY §2.2).

- `TaskMaster`: the in-process dispatcher over the native library
  (`csrc/native/master.cc`): todo / pending / done queues, lease timeouts
  with re-queue, the failure cap, passes, and snapshot / restore in the JAX
  package's snapshot format, so a standby of either package takes over
  from the other's snapshot.
- `MasterServer` over `_Handler`: the master as a TCP service, line JSON
  or the binary frame layer (`runtime/frames.py`) after the `_hello`
  probe; every RPC of the JAX package's, byte for byte on the wire.
  `standby_master` watches a primary (`runtime/election.py`) and takes
  over from the shared snapshot; `python -m
  paddle_tpu_torch.runtime.master serve|standby` runs either as a process.
- `_Membership`: soft-state leases with roles (trainer / reader) and task
  ownership, so an evicted trainer's tasks are re-queued at once. The
  serving server and the router use it for their tenant leases.
- `_ResizeEpoch` and `_SnapshotPolicy`: the elastic-resize state machine
  (announce, a drain barrier piggybacked on heartbeat replies, go, idle)
  and debounced atomic snapshot writes.
- `MasterClient`: reconnect, endpoint failover, bounded exponential
  backoff with jitter, the `_hello` negotiation, pipelined `call_many`,
  push-stream `call_stream`, the seeded `conn_reset` chaos site.
- The trainer side: `_Heartbeater`, `ResizeClient` (the
  `SGDTrainer.train(resize_barrier=...)` hook) and `cluster_reader`, the
  v2 cluster reader (bulk `get_tasks` leases with piggybacked acks, and a
  drain between tasks when a resize epoch is announced).

Chaos sites: `master_drop`, `master_kill`, `conn_reset`,
`resize_drain_stall` (`core/faults.py`)."""

from __future__ import annotations

import base64
import ctypes as C
import json
import logging
import os
import random
import socket
import socketserver
import threading
import time
import uuid
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Set, Tuple, Union

from paddle_tpu_torch.core import faults, stats
from paddle_tpu_torch.obs import metrics as obs_metrics
from paddle_tpu_torch.obs import trace as obs_trace
from paddle_tpu_torch.runtime import frames, native, recordio

log = logging.getLogger("paddle_tpu_torch.master")

Endpoint = Tuple[str, int]
EndpointsLike = Union[str, Endpoint, Sequence[Union[str, Endpoint]]]


def parse_endpoints(address: EndpointsLike) -> List[Endpoint]:
    """Normalize one endpoint or a failover list into [(host, port), ...].

    Accepts a (host, port) tuple, "host:port", the CLI's comma form
    "a:p1,b:p2", or any sequence mixing those."""
    if isinstance(address, str):
        parts = [p.strip() for p in address.split(",") if p.strip()]
    elif (
        isinstance(address, (tuple, list))
        and len(address) == 2
        and isinstance(address[0], str)
        and isinstance(address[1], int)
    ):
        parts = [address]
    else:
        parts = list(address)
    out: List[Endpoint] = []
    for p in parts:
        if isinstance(p, str):
            host, sep, port = p.rpartition(":")
            if not sep:
                raise ValueError(f"bad master endpoint {p!r}: want host:port")
            out.append((host, int(port)))
        else:
            host, port = p
            out.append((str(host), int(port)))
    if not out:
        raise ValueError(f"no master endpoints in {address!r}")
    return out



class TaskMaster:
    """In-process task dispatcher (go/master service.go parity) over the
    native library. A task's payload is its newline-joined shard paths."""

    PASS_FINISHED = -2

    def __init__(self, timeout_s: float = 60.0, failure_max: int = 3):
        self._lib = native.lib()
        self._m = self._lib.pt_master_create(timeout_s, failure_max)
        self._buf = C.create_string_buffer(1 << 20)

    def set_dataset(self, shard_paths: Sequence[str], chunks_per_task: int = 1) -> None:
        """Group the shards into tasks of `chunks_per_task` (go master
        NewService(chunksPerTask), service.go:140)."""
        paths = list(shard_paths)
        payloads = ["\n".join(paths[i:i + chunks_per_task])
                    for i in range(0, len(paths), chunks_per_task)]
        blob = b"".join(p.encode() + b"\0" for p in payloads)
        self._lib.pt_master_set_dataset(self._m, blob, len(payloads))

    def get_task(self) -> Optional[tuple]:
        """(task_id, [shard paths]); None while every task is leased;
        (PASS_FINISHED, []) when the pass has no task left."""
        tid = self._lib.pt_master_get_task(self._m, self._buf, len(self._buf))
        while tid == -3:  # the buffer is too small: grow it until the payload fits
            self._buf = C.create_string_buffer(len(self._buf) * 4)
            tid = self._lib.pt_master_get_task(self._m, self._buf, len(self._buf))
        if tid < 0:
            return None if tid == -1 else (self.PASS_FINISHED, [])
        return int(tid), self._buf.value.decode().split("\n")

    def task_finished(self, task_id: int) -> bool:
        return self._lib.pt_master_task_finished(self._m, task_id) == 0

    def task_failed(self, task_id: int) -> bool:
        return self._lib.pt_master_task_failed(self._m, task_id) == 0

    def pass_finished(self, start_next: bool = False) -> bool:
        return self._lib.pt_master_pass_finished(self._m, int(start_next)) == 1

    def stats(self) -> dict:
        out = (C.c_int64 * 5)()
        self._lib.pt_master_stats(self._m, out)
        return {"todo": out[0], "pending": out[1], "done": out[2], "discarded": out[3],
                "pass": out[4]}

    def snapshot(self, path: str) -> None:
        if self._m is None:
            raise OSError("snapshot on a closed TaskMaster")
        if self._lib.pt_master_snapshot(self._m, path.encode()) != 0:
            raise OSError(f"snapshot to {path} failed")

    def restore(self, path: str) -> None:
        """Load a snapshot; a truncated or corrupt one raises and leaves the
        live queues as they were."""
        if self._lib.pt_master_restore(self._m, path.encode()) != 0:
            raise OSError(f"restore from {path} failed")

    @property
    def closed(self) -> bool:
        return self._m is None

    def close(self) -> None:
        if self._m:
            self._lib.pt_master_destroy(self._m)
            self._m = None

    def __del__(self):
        if getattr(self, "_m", None):
            self.close()


class _Membership:
    """Soft-state trainer leases (go/master's etcd TTL keys, in-process).

    Any RPC bearing a trainer_id renews — or adopts — the lease, so a
    failover to a standby that never saw `register` heals itself on the next
    request instead of erroring (retry-exact RPCs). Pending-task ownership is
    tracked so an expired trainer's tasks can be re-queued eagerly."""

    def __init__(self, lease_s: float):
        self.lease_s = float(lease_s)
        self._lock = threading.Lock()
        self._last_seen: Dict[str, float] = {}
        # lease role: "trainer" (default) or "reader" — one PROCESS may hold
        # both (ResizeClient + registered cluster_reader), so membership-
        # triggered resize worlds must count trainer leases, not all leases
        self._roles: Dict[str, str] = {}
        self._owned: Dict[str, Set[int]] = {}
        self._owner: Dict[int, str] = {}
        self._next = 0
        # server-unique prefix: ids minted by a primary and its standby never
        # collide, so an adopted lease is unambiguous
        self._prefix = uuid.uuid4().hex[:6]
        self.evicted = 0

    def register(self, role: str = "trainer") -> str:
        with self._lock:
            tid = f"tr-{self._prefix}-{self._next}"
            self._next += 1
            self._last_seen[tid] = time.monotonic()
            self._roles[tid] = role or "trainer"
            return tid

    def note_seen(self, tid: Optional[str], role: Optional[str] = None) -> None:
        if not tid:
            return
        with self._lock:
            self._last_seen[tid] = time.monotonic()
            if role:
                # heartbeats re-assert the role so a lease ADOPTED by a
                # standby (which never saw `register`) heals its type too
                self._roles[tid] = role

    def own(self, tid: Optional[str], task_id: int) -> None:
        if not tid:
            return
        with self._lock:
            self._owned.setdefault(tid, set()).add(task_id)
            self._owner[task_id] = tid

    def release(self, task_id: int) -> None:
        with self._lock:
            tid = self._owner.pop(task_id, None)
            if tid is not None:
                self._owned.get(tid, set()).discard(task_id)

    def drop(self, tid: str) -> Set[int]:
        """Forget a trainer (graceful deregister or eviction); returns the
        task ids it still held, for the caller to re-queue. Reader-role
        entries survive as tombstones: an evicted-but-alive reader whose
        next get_task/task_done resurrects the lease (note_seen carries no
        role) must not default back to "trainer" and inflate the next
        membership-triggered world size. Ids are never reused, so the
        tombstones are one short string per ever-registered reader."""
        with self._lock:
            self._last_seen.pop(tid, None)
            if self._roles.get(tid, "trainer") != "reader":
                self._roles.pop(tid, None)
            tasks = self._owned.pop(tid, set())
            for t in tasks:
                self._owner.pop(t, None)
            return tasks

    def expired(self) -> List[str]:
        now = time.monotonic()
        with self._lock:
            return [
                tid for tid, seen in self._last_seen.items()
                if now - seen > self.lease_s
            ]

    @property
    def live(self) -> int:
        with self._lock:
            return len(self._last_seen)

    @property
    def live_trainers(self) -> int:
        """Trainer-role leases only — the world size a membership-triggered
        resize should announce (reader leases join the drain barrier but do
        not shard the data axis)."""
        with self._lock:
            return sum(
                1 for t in self._last_seen
                if self._roles.get(t, "trainer") != "reader"
            )

    def role(self, tid: Optional[str]) -> str:
        with self._lock:
            return self._roles.get(tid, "trainer") if tid else "trainer"

    def ids(self) -> List[str]:
        with self._lock:
            return list(self._last_seen)


class _ResizeEpoch:
    """Master-side elastic-resize state machine.

    One epoch at a time:

        idle --announce--> draining --all live members acked--> go
          ^                                                      |
          +------------- every acked member saw go --------------+

    `announce(world, live)` snapshots the live trainer set as the drain
    BARRIER membership; each member acks `resize_drained` at its own batch
    boundary. The barrier is recomputed on eviction (`note_dropped`) so a
    trainer KILLED during the drain cannot deadlock the epoch: lease expiry
    shrinks the membership and the survivors proceed. A trainer that is
    wedged but still heart-beating (`resize_drain_stall` — its daemon
    heartbeat thread keeps the lease alive) is caught by the second guard:
    `tick()` (called from the master's reaper loop) times the DRAIN phase
    out after `drain_timeout_s` and drops non-acked members from the
    barrier, so liveness never depends on every member being prompt. In
    `go`, members poll `resize_status` (their poll marks them resumed); once
    every surviving member resumed, the epoch closes and the drain/total
    latency lands in `last`. A timed-out straggler that eventually wakes
    sees the epoch in `go`/`idle`, adopts the decided world, and rejoins.

    Task accounting stays exactly-once across the epoch by construction:
    drained trainers hold no in-flight task (the reader drains between task
    acks), and a killed trainer's pending tasks ride the existing eager
    re-queue on eviction — nothing is double-acked and nothing is lost, so
    `done == ntasks` holds at pass end regardless of how many epochs (or
    mid-epoch deaths) the pass saw."""

    def __init__(self, drain_timeout_s: float = 60.0):
        self._lock = threading.Lock()
        self.drain_timeout_s = float(drain_timeout_s)
        # epoch numbers are a per-master-INSTANCE counter: a promoted
        # standby (or restarted master) counts from 1 again, so clients
        # must treat (instance, epoch) — not the bare number — as the
        # epoch's identity or a post-failover collision with an already-
        # handled number silently exempts them from the new master's epochs
        self.instance = uuid.uuid4().hex[:8]
        self.epoch = 0
        self.state = "idle"  # idle | draining | go
        self.world = 0
        self.barrier: Set[str] = set()
        self.acked: Set[str] = set()
        self.resumed: Set[str] = set()
        self.evicted_during = 0
        self.timed_out = 0
        self.announced_at = 0.0
        self.drained_at = 0.0
        self.completed = 0
        self.last: Dict[str, Any] = {}

    def announce(self, world: int, live: Sequence[str]) -> Dict[str, Any]:
        with self._lock:
            if self.state != "idle":
                return {
                    "err": (
                        f"resize epoch {self.epoch} still {self.state} "
                        f"(world {self.world}); retry after it completes"
                    )
                }
            self.epoch += 1
            self.state = "draining"
            self.world = int(world)
            self.barrier = set(live)
            self.acked = set()
            self.resumed = set()
            self.evicted_during = 0
            self.timed_out = 0
            self.announced_at = time.monotonic()
            self.drained_at = 0.0
            if not self.barrier:
                # nobody to drain (resize before any trainer registered):
                # complete immediately instead of wedging `draining` — and
                # rejecting every later announce — until the drain timeout
                self._maybe_go_locked()
            info = self._info_locked()
        stats.FT_EVENTS.incr("resize_announce")
        log.warning(
            "resize epoch %d announced: world -> %d, drain barrier of %d "
            "trainer(s)", info["epoch"], info["world"], info["barrier"],
        )
        return info

    def ack_drained(self, tid: Optional[str], epoch: int) -> Dict[str, Any]:
        with self._lock:
            if self.state == "draining" and epoch == self.epoch and tid:
                self.acked.add(tid)
                # a late joiner acking the barrier counts as a member (it
                # registered after the announce but still drains with us)
                self.barrier.add(tid)
                self._maybe_go_locked()
            return self._info_locked()

    def mark_resumed(self, tid: Optional[str], epoch: int) -> Dict[str, Any]:
        with self._lock:
            if self.state == "go" and epoch == self.epoch and tid:
                self.resumed.add(tid)
                self._maybe_finish_locked()
            return self._info_locked()

    def note_dropped(self, tid: str) -> None:
        """Membership eviction/deregister during an epoch: the barrier must
        not wait for the dead."""
        with self._lock:
            if self.state == "idle":
                return
            dropped = False
            for s in (self.barrier, self.acked, self.resumed):
                if tid in s:
                    s.discard(tid)
                    dropped = True
            if not dropped:
                return
            self.evicted_during += 1
            if self.state == "draining":
                self._maybe_go_locked()
            elif self.state == "go":
                self._maybe_finish_locked()
        stats.FT_EVENTS.incr("resize_barrier_evicted")

    def tick(self) -> None:
        """Reaper-loop guard: a drain phase older than `drain_timeout_s`
        drops every non-acked member from the barrier (a member can be
        wedged yet still heart-beating, so lease eviction alone is not a
        liveness guarantee) and lets the survivors go. The `go` phase gets
        the same guard against its own wedge mode: a member that acked the
        drain and then hung inside its re-shard (heartbeat thread still
        renewing the lease) must not pin the epoch in `go` — and reject
        every future announce — forever."""
        stragglers: Set[str] = set()
        with self._lock:
            if self.state == "draining":
                if time.monotonic() - self.announced_at < self.drain_timeout_s:
                    return
                stragglers = self.barrier - self.acked
                if stragglers:
                    log.warning(
                        "resize epoch %d: drain barrier timed out after "
                        "%.0fs — dropping %d non-acked member(s) and "
                        "proceeding",
                        self.epoch, self.drain_timeout_s, len(stragglers),
                    )
                    self.barrier -= stragglers
                    self.timed_out += len(stragglers)
                    self.evicted_during += len(stragglers)
                self._maybe_go_locked()
            elif self.state == "go":
                if time.monotonic() - self.drained_at < self.drain_timeout_s:
                    return
                stragglers = self.barrier - self.resumed
                if stragglers:
                    log.warning(
                        "resize epoch %d: %d drained member(s) never resumed "
                        "after %.0fs — dropping them and completing the "
                        "epoch",
                        self.epoch, len(stragglers), self.drain_timeout_s,
                    )
                    self.barrier -= stragglers
                    self.acked -= stragglers
                    self.timed_out += len(stragglers)
                    self.evicted_during += len(stragglers)
                self._maybe_finish_locked()
            else:
                return
        for _ in stragglers:
            stats.FT_EVENTS.incr("resize_barrier_timeout")

    def _maybe_go_locked(self) -> None:
        if self.barrier and not (self.barrier - self.acked):
            self.state = "go"
            self.drained_at = time.monotonic()
            log.warning(
                "resize epoch %d: all %d live trainer(s) drained (%.3fs) — go",
                self.epoch, len(self.barrier),
                self.drained_at - self.announced_at,
            )
        elif not self.barrier:
            # everyone died mid-drain: nothing left to coordinate
            self.state = "go"
            self.drained_at = time.monotonic()
            self._maybe_finish_locked()

    def _maybe_finish_locked(self) -> None:
        if self.barrier - self.resumed:
            return
        self.state = "idle"
        self.completed += 1
        now = time.monotonic()
        self.last = {
            "epoch": self.epoch,
            "world": self.world,
            "trainers": len(self.barrier),
            "evicted_during": self.evicted_during,
            "timed_out": self.timed_out,
            "drain_s": round(
                (self.drained_at or now) - self.announced_at, 6
            ),
            "total_s": round(now - self.announced_at, 6),
        }
        stats.FT_EVENTS.incr("resize_complete")
        log.warning(
            "resize epoch %d complete: world=%d %d trainer(s), %d evicted "
            "mid-epoch, drain %.3fs total %.3fs", self.epoch, self.world,
            len(self.barrier), self.evicted_during, self.last["drain_s"],
            self.last["total_s"],
        )

    def _info_locked(self) -> Dict[str, Any]:
        return {
            "state": self.state,
            "instance": self.instance,
            "epoch": self.epoch,
            "world": self.world,
            "barrier": len(self.barrier),
            "drained": len(self.acked),
            "resumed": len(self.resumed),
            "timed_out": self.timed_out,
            "completed": self.completed,
            "last": dict(self.last),
        }

    def info(self) -> Dict[str, Any]:
        with self._lock:
            return self._info_locked()

    def heartbeat_payload(self) -> Optional[Dict[str, Any]]:
        """The drain signal that piggybacks on heartbeat replies while an
        epoch is active — no extra RPC round-trips on the control plane
        ("RPC Considered Harmful"); None (omitted) when idle."""
        with self._lock:
            if self.state == "idle":
                return None
            return {
                "state": self.state, "instance": self.instance,
                "epoch": self.epoch, "world": self.world,
            }


class _SnapshotPolicy:
    """Debounced, atomic snapshot writes OUTSIDE the RPC lock.

    The native snapshot takes the master's own mutex, so the only thing the
    RPC lock was buying during the write was a full stall of every other
    trainer behind one fsync. Writes go to a temp file + rename (never a torn
    snapshot for a standby to restore), rate-limited to at most once per
    `every` acks and once per `interval_s` seconds."""

    def __init__(self, path: str, every: int = 1, interval_s: float = 0.0):
        self.path = path
        self.every = max(1, int(every))
        self.interval_s = float(interval_s)
        self._lock = threading.Lock()
        self._write_lock = threading.Lock()
        self._acks = 0
        self._last = 0.0  # monotonic; 0 = never written
        self.failures = 0

    def note_ack(self) -> bool:
        """Record one durable-progress event; True when a snapshot is due."""
        with self._lock:
            self._acks += 1
            return self._due_locked()

    def _due_locked(self) -> bool:
        if self._acks < self.every:
            return False
        if self.interval_s and time.monotonic() - self._last < self.interval_s:
            return False
        return True

    def pending(self) -> bool:
        """Acks recorded but not yet made durable (reaper/stop flush them).
        Before the FIRST write, sub-threshold acks stay debounced (stop()
        still flushes them) — `_last == 0` must not read as 'interval long
        since elapsed'."""
        with self._lock:
            if self._acks == 0:
                return False
            if not self.interval_s:
                return True
            if self._last == 0.0:
                return False
            return time.monotonic() - self._last >= self.interval_s

    def write(self, master: TaskMaster) -> None:
        with self._lock:
            self._acks = 0
            self._last = time.monotonic()
        with self._write_lock:
            tmp = f"{self.path}.{os.getpid()}.tmp"
            try:
                master.snapshot(tmp)
                os.replace(tmp, self.path)
            except OSError as e:
                # progress was acked to the trainer but NOT made durable — a
                # crash now replays those tasks; say so instead of silently
                # losing recovery fidelity
                self.failures += 1
                log.warning(
                    "master snapshot to %s failed (%s); a crash before the "
                    "next successful snapshot will re-dispatch acked tasks",
                    self.path, e,
                )
            finally:
                if os.path.exists(tmp):
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass


# ---------------------------------------------------------------------------
# TCP service (the Go master's RPC role), newline-delimited JSON
# ---------------------------------------------------------------------------


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        ms: MasterServer = self.server.ctx  # type: ignore[attr-defined]
        for line in self.rfile:
            try:
                req = json.loads(line)
            except json.JSONDecodeError:
                self._reply({"err": "bad json"})
                continue
            if req.get("method") == "_hello":
                # wire negotiation: the probe and its answer ride
                # line JSON, so a legacy peer — which never probes — is
                # served bit-for-bit by this unchanged loop, while a
                # frames-capable client switches THIS connection to the
                # binary frame layer for the rest of its life
                if req.get("frames") == 1:
                    self._reply({"frames": 1})
                    self._serve_frames(ms)
                    return
                self._reply({"frames": 0})
                continue
            # span per RPC, adopting the caller's piggybacked trace context
            # (`_trace` on the line-JSON frame) so a task's or request's
            # spans stitch client → master under one trace id
            with obs_trace.server_span(
                "rpc." + str(req.get("method")), req.get("_trace"),
                side="server",
            ):
                keep, resp = self._handle_one(ms, req)
            if resp is not None:
                if "_bin" in resp:
                    # line JSON cannot carry raw bytes: base64 downgrade
                    resp = dict(resp)
                    resp["bin_b64"] = base64.b64encode(
                        resp.pop("_bin")
                    ).decode("ascii")
                self._reply(resp)
            if not keep:
                return

    def _serve_frames(self, ms: "MasterServer") -> None:
        """The framed connection loop: request frames are processed in
        arrival order and answered on the same socket, so a pipelining
        client (`MasterClient.call_many`) gets its replies back in request
        order, matched by req_id. A malformed frame severs with a NAMED
        error reply (frames.FrameError subclasses) instead of wedging this
        handler thread on a blocking read."""
        while True:
            try:
                got = frames.read_frame(self.rfile)
            except frames.FrameError as e:
                self._reply_frame({"err": f"{type(e).__name__}: {e}"}, 0, 0, b"")
                return
            if got is None:
                return
            req, req_id, _, _ = got
            with obs_trace.server_span(
                "rpc." + str(req.get("method")), req.get("_trace"),
                side="server",
            ):
                keep, resp = self._handle_one(ms, req)
            if resp is not None:
                flags = 0
                blob = b""
                if "_bin" in resp:
                    resp = dict(resp)
                    blob = resp.pop("_bin")
                    flags |= frames.FLAG_BIN_BLOB
                # piggyback discipline: while a resize epoch is
                # active the drain signal rides EVERY framed data reply to
                # a lease holder, not just heartbeat replies — a busy
                # reader hears it one data round trip sooner and its
                # heartbeat thread stands down (_Heartbeater's
                # data-fresh skip)
                if req.get("trainer_id") and "resize" not in resp:
                    rz = ms.resize.heartbeat_payload()
                    if rz is not None:
                        resp["_rz"] = rz
                        flags |= frames.FLAG_PIGGY
                self._reply_frame(resp, req_id, flags, blob)
            if not keep:
                return

    def _reply_frame(self, obj: dict, req_id: int, flags: int,
                     blob: bytes) -> None:
        try:
            frames.write_frame(
                self.wfile, obj, req_id=req_id, flags=flags, bin_payload=blob
            )
        except (OSError, ValueError):
            pass  # peer vanished mid-reply; its retry path handles it

    def _handle_one(
        self, ms: "MasterServer", req: dict
    ) -> Tuple[bool, Optional[dict]]:
        """Process one request -> (keep_connection, reply | None). The
        caller owns the wire (line vs frame encode); keep=False severs the
        connection (chaos sites, master killed under us)."""
        master = ms.master
        lock = ms.master_lock
        method = req.get("method")
        if faults.get().fire("master_drop"):
            # chaos hook: the RPC vanishes in transit — drop the
            # connection without processing or replying; the client's
            # reconnect/backoff path has to absorb it
            return False, None
        if faults.get().fire("master_kill"):
            # chaos hook: the master process dies mid-RPC — no reply, no
            # final snapshot, every open connection severed; only a
            # standby restoring the last on-disk snapshot saves the pass
            log.warning("chaos: master_kill fired — dying without reply")
            ms.kill()
            return False, None
        trainer_id = req.get("trainer_id")
        ms.membership.note_seen(trainer_id, req.get("role"))
        # (expired leases are swept by the reaper thread every lease_s/4 —
        # that bound IS the eager-requeue guarantee; scanning again per
        # RPC would only add membership-lock traffic to the hot path)
        # membership + observability RPCs never touch the native queue —
        # answered outside master_lock (drop_trainer takes it itself)
        if method == "register":
            role = req.get("role") or "trainer"
            tid = ms.membership.register(role)
            if (
                ms.resize_on_membership
                and role != "reader"
                and ms.membership.live_trainers > 1
            ):
                # join-triggered epoch: re-shape the fleet to the new live
                # TRAINER count (while another epoch is still in flight the
                # announce parks and the reaper re-fires it on completion);
                # a reader lease joining changes no world size
                ms.announce_membership_resize()
            return True, {
                "trainer_id": tid,
                "lease_s": ms.membership.lease_s,
            }
        if method == "heartbeat":
            # note_seen above already renewed (or adopted) the lease; a
            # piggybacked metrics snapshot joins the fleet aggregate
            if trainer_id and "metrics" in req:
                ms.fleet.update(trainer_id, req["metrics"])
            resp = {"ok": bool(trainer_id)}
            rz = ms.resize.heartbeat_payload()
            if rz is not None:
                # the resize drain signal rides the lease renewal — an
                # active epoch reaches every live trainer within one
                # heartbeat period, with zero extra control-plane RPCs
                resp["resize"] = rz
            return True, resp
        if method == "deregister":
            return True, {"ok": ms.drop_trainer(trainer_id, evict=False)}
        if method == "resize":
            # explicit fleet re-shape order (ops tooling / chaos bench);
            # join/evict-triggered epochs go through the same announce. A
            # malformed order gets an err REPLY — crashing the handler here
            # would sever the connection instead
            try:
                world = req["world"]
                # strict: a JSON bool/float would coerce under int() (True
                # -> 1 would re-shard the fleet to one chip; 4.7 -> 4) —
                # reply err instead of guessing what the operator meant
                if (
                    isinstance(world, bool)
                    or not isinstance(world, int)
                    or world < 1
                ):
                    raise ValueError(world)
            except (KeyError, TypeError, ValueError):
                return True, {
                    "err": f"resize needs a positive integer world, got "
                           f"{req.get('world')!r}"
                }
            return True, ms.resize.announce(world, ms.membership.ids())
        if method in ("resize_drained", "resize_status"):
            try:
                epoch = int(req.get("epoch", 0))
            except (TypeError, ValueError):
                epoch = -1  # malformed: matches no epoch, replies status-only
            # in `go`, a member's status poll doubles as its resumed ack
            return True, (
                ms.resize.ack_drained(trainer_id, epoch)
                if method == "resize_drained"
                else ms.resize.mark_resumed(trainer_id, epoch)
            )
        if method == "metrics":
            fleet = ms.fleet.aggregate()
            return True, {
                "text": obs_metrics.to_prometheus_text(fleet=fleet),
                "fleet": fleet,
            }
        if method == "trace_export":
            return True, {"chrome_trace": obs_trace.export_chrome()}
        if method == "snapshot_fetch":
            # bulk body: the snapshot blob rides the frame's RAW
            # binary payload (base64 over a line-JSON connection) — a
            # standby can warm itself over the wire instead of requiring
            # shared snapshot storage. The on-disk file is always a
            # complete snapshot (temp + rename writes), so a plain read
            # outside master_lock is consistent.
            path = ms.snapshot_path
            if not path or not os.path.exists(path):
                return True, {"err": "no snapshot available"}
            try:
                with open(path, "rb") as f:
                    blob = f.read()
            except OSError as e:
                return True, {"err": f"snapshot read failed: {e}"}
            return True, {"_bin": blob, "bytes": len(blob)}
        snapshot_due = False
        with lock:
            if master.closed:  # killed under us — sever like a crash
                return False, None
            if method == "get_task":
                got = master.get_task()
                if got is None:
                    resp = {"retry": True}
                elif got[0] == TaskMaster.PASS_FINISHED:
                    resp = {"pass_finished": True}
                else:
                    resp = {"task_id": got[0], "shards": got[1]}
                    ms.membership.own(trainer_id, got[0])
            elif method == "get_tasks":
                # bulk range lease + piggybacked acks: done /
                # failed acks from the PREVIOUS batch land first — so the
                # final ack of a pass rides the very request that discovers
                # pass_finished — then up to n tasks are leased. One round
                # trip does what the single-task surface took 2n for.
                acked = 0
                for t in req.get("done_ids") or []:
                    if master.task_finished(int(t)):
                        acked += 1
                        if ms.snap is not None and ms.snap.note_ack():
                            snapshot_due = True
                    ms.membership.release(int(t))
                for t in req.get("failed_ids") or []:
                    master.task_failed(int(t))
                    ms.membership.release(int(t))
                tasks: List[dict] = []
                resp = {"tasks": tasks, "acked": acked}
                for _ in range(max(0, int(req.get("n", 1) or 0))):
                    got = master.get_task()
                    if got is None:
                        if not tasks:
                            resp["retry"] = True
                        break
                    if got[0] == TaskMaster.PASS_FINISHED:
                        if not tasks:
                            resp["pass_finished"] = True
                        break
                    tasks.append({"task_id": got[0], "shards": got[1]})
                    ms.membership.own(trainer_id, got[0])
            elif method == "task_finished":
                tid = int(req["task_id"])
                ok = master.task_finished(tid)
                ms.membership.release(tid)
                resp = {"ok": ok}
                if ok and ms.snap is not None:
                    snapshot_due = ms.snap.note_ack()
            elif method == "task_failed":
                tid = int(req["task_id"])
                ok = master.task_failed(tid)
                ms.membership.release(tid)
                resp = {"ok": ok}
            elif method == "set_dataset":
                master.set_dataset(
                    req["shards"], int(req.get("chunks_per_task", 1))
                )
                resp = {"ok": True}
            elif method == "pass_finished":
                resp = {
                    "finished": master.pass_finished(
                        bool(req.get("start_next", False))
                    )
                }
            elif method == "stats":
                resp = master.stats()
                resp["snapshot_failures"] = ms.snapshot_failures
                # role-aware: live_trainers is the world size a resize
                # would announce; reader leases show up in live_leases
                resp["live_trainers"] = ms.membership.live_trainers
                resp["live_leases"] = ms.membership.live
                resp["evicted_trainers"] = ms.membership.evicted
                # resize-epoch observability: state machine position,
                # completed-epoch count and the last epoch's latency split
                resp["resize"] = ms.resize.info()
                # fleet-wide aggregate of the heartbeat metric snapshots:
                # one stats() answers for every reporting trainer
                resp["fleet"] = ms.fleet.aggregate()
            else:
                resp = {"err": f"unknown method {method!r}"}
        if snapshot_due:
            # the write happens OUTSIDE master_lock: other trainers keep
            # getting tasks while this thread does file I/O (the native
            # snapshot takes its own internal mutex for a consistent view)
            ms.snap.write(master)
        return True, resp

    def _reply(self, obj: Any) -> None:
        try:
            self.wfile.write(json.dumps(obj).encode() + b"\n")
            self.wfile.flush()
        except (OSError, ValueError):
            pass  # peer vanished mid-reply; its retry path handles it


class MasterServer:
    """Threaded TCP wrapper; start()/stop(); port 0 picks a free port (the
    reference's in-process-localhost test idiom, test_CompareSparse.cpp:65).

    lease_s: trainer membership lease — a trainer silent for longer is
    evicted and its pending tasks are re-queued immediately.
    snapshot_every / snapshot_interval_s: debounce for the per-ack snapshot
    (at most once per N acks and once per T seconds; the reaper thread and
    stop() flush anything still pending)."""

    def __init__(
        self,
        master: Optional[TaskMaster] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        snapshot_path: Optional[str] = None,
        lease_s: float = 10.0,
        snapshot_every: int = 1,
        snapshot_interval_s: float = 0.0,
        resize_on_membership: bool = False,
        resize_drain_timeout_s: Optional[float] = None,
        initial_world: int = 0,
    ):
        self.master = master or TaskMaster()
        self.master_lock = threading.Lock()
        self.membership = _Membership(lease_s)
        # elastic resize epoch state machine; resize_on_membership=True also
        # announces an epoch (world = live trainer count) whenever a trainer
        # joins or is evicted — the join/evict-triggered policy; explicit
        # `resize` RPCs work either way. The drain timeout defaults to a few
        # leases: enough for every prompt member's next batch boundary,
        # short enough that one wedged-but-heartbeating member cannot hold
        # the fleet hostage.
        self.resize = _ResizeEpoch(
            drain_timeout_s=(
                resize_drain_timeout_s
                if resize_drain_timeout_s is not None
                else max(4.0 * lease_s, 10.0)
            )
        )
        # autoscaler hook: seed the resize plane's world so
        # `stats()["resize"]["world"]` answers "what IS the training world"
        # even before the first epoch — the stateless-reconciling
        # controller re-derives desired state from this observed value
        # instead of journaling its own actions
        self.resize.world = int(initial_world)
        self.resize_on_membership = resize_on_membership
        # membership churn that lands while an epoch is in flight parks here
        # (announce() rejects overlapping epochs); the reaper re-announces
        # against the CURRENT membership once the epoch completes, so the
        # fleet never settles at a stale world size
        self._resize_pending = False
        # serializes announce()+park so a successful announce on one handler
        # thread cannot clobber a concurrent rejected announce's park (the
        # lost-update hazard maybe_reannounce_resize's docstring describes)
        self._resize_announce_lock = threading.Lock()
        # per-trainer heartbeat metric snapshots → fleet aggregate in stats();
        # entries expire a few leases after the last heartbeat
        self.fleet = obs_metrics.FleetMetrics(ttl_s=max(3.0 * lease_s, 30.0))
        self.snap = (
            _SnapshotPolicy(snapshot_path, snapshot_every, snapshot_interval_s)
            if snapshot_path
            else None
        )
        self.snapshot_path = snapshot_path
        self._srv = socketserver.ThreadingTCPServer(
            (host, port), _Handler, bind_and_activate=True
        )
        self._srv.daemon_threads = True
        self._srv.ctx = self  # type: ignore[attr-defined]
        if snapshot_path and os.path.exists(snapshot_path):
            self.master.restore(snapshot_path)  # crash recovery (service.go:166)
        self._thread: Optional[threading.Thread] = None
        self._reaper: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._stopped = False
        self._killed = False

    @property
    def address(self) -> tuple:
        return self._srv.server_address

    @property
    def snapshot_failures(self) -> int:
        return self.snap.failures if self.snap is not None else 0

    @property
    def alive(self) -> bool:
        return (
            self._thread is not None
            and self._thread.is_alive()
            and not self._stopped
            and not self._killed
        )

    def evict_expired(self) -> int:
        """Drop trainers whose lease lapsed; re-queue their pending tasks NOW
        (the per-task timeout would get there eventually — minutes later)."""
        n = 0
        for tid in self.membership.expired():
            if self.drop_trainer(tid, evict=True):
                n += 1
        return n

    def announce_membership_resize(self) -> None:
        """Join/evict-triggered resize epoch for the CURRENT membership.
        The announced WORLD counts trainer-role leases only (a process may
        hold a reader lease too — double-counting would shard the data axis
        to a size no real trainer count backs), while the drain BARRIER
        spans every lease (readers drain between tasks). While another
        epoch is still in flight the announce is rejected; park it so the
        reaper fires it once the epoch completes instead of silently
        dropping the churn. The announce and the park write are one
        critical section: handler threads race here, and a successful
        announce's pending=False must not overwrite a concurrent rejected
        announce's park (that churn would be silently dropped). A success
        CLEARS the park because the membership it announced was read inside
        the same lock — any parked churn is subsumed by that epoch."""
        with self._resize_announce_lock:
            world = self.membership.live_trainers
            if not world:
                return
            r = self.resize.announce(world, self.membership.ids())
            self._resize_pending = "err" in r

    def maybe_reannounce_resize(self) -> None:
        """Reaper hook: fire a parked membership-churn announce once the
        in-flight epoch has completed. Ordering matters: while
        resize_on_membership is on, this thread must never WRITE
        _resize_pending=False on the not-pending path — an RPC handler's
        rejected announce can park (set True) between this thread's read
        and such a write, and the clobbered park would silently drop the
        churn (the fleet settles at a stale world size)."""
        if not self.resize_on_membership:
            self._resize_pending = False
            return
        if not self._resize_pending:
            return
        if self.resize.info()["state"] != "idle":
            return
        if not self.membership.live_trainers:
            # keep the park (same lost-update hazard as above): once a
            # trainer appears the next tick announces at the live count
            return
        self.announce_membership_resize()

    def drop_trainer(self, tid: Optional[str], evict: bool) -> bool:
        if not tid:
            return False
        was_trainer = self.membership.role(tid) != "reader"
        tasks = self.membership.drop(tid)
        self.fleet.drop(tid)
        # a dead/deregistered trainer must not hold up an in-flight resize
        # drain barrier — recompute it against the survivors
        self.resize.note_dropped(tid)
        if (
            evict
            and self.resize_on_membership
            and was_trainer
            and self.membership.live_trainers
        ):
            # evict-triggered epoch: shrink the fleet to the surviving
            # trainers (an evicted reader lease changes no world size)
            self.announce_membership_resize()
        requeued = 0
        with self.master_lock:
            if not self.master.closed:
                for t in tasks:
                    if self.master.task_failed(t):
                        requeued += 1
        if evict:
            self.membership.evicted += 1
            stats.FT_EVENTS.incr("trainer_evicted")
            log.warning(
                "trainer %s lease expired (%gs); evicted, %d pending task(s) "
                "re-queued eagerly", tid, self.membership.lease_s, requeued,
            )
        elif requeued:
            log.info(
                "trainer %s deregistered with %d task(s) in flight; re-queued",
                tid, requeued,
            )
        return True

    def _reap_loop(self) -> None:
        period = max(0.05, min(1.0, self.membership.lease_s / 4.0))
        while not self._stop_evt.wait(period):
            self.evict_expired()
            self.resize.tick()  # drain/go-phase timeout guard
            self.maybe_reannounce_resize()  # parked membership churn
            if self.snap is not None and self.snap.pending():
                # quiet-period flush: acks below the debounce threshold still
                # become durable without waiting for the next burst
                with self.master_lock:
                    closed = self.master.closed
                if not closed:
                    self.snap.write(self.master)

    def start(self) -> "MasterServer":
        self._thread = threading.Thread(target=self._srv.serve_forever, daemon=True)
        self._thread.start()
        self._reaper = threading.Thread(target=self._reap_loop, daemon=True)
        self._reaper.start()
        return self

    def stop(self) -> None:
        """Graceful shutdown: stop serving, flush a final snapshot, close the
        native handle. Idempotent (and safe after kill())."""
        if self._stopped:
            return
        self._stopped = True
        self._stop_evt.set()
        if self._thread is not None:  # shutdown() hangs if serve never ran
            self._srv.shutdown()
        self._srv.server_close()
        if self._reaper is not None:
            self._reaper.join(timeout=5.0)
        if not self._killed and self.snap is not None and not self.master.closed:
            self.snap.write(self.master)
        # the native TaskMaster handle used to leak here — close it (close()
        # is a no-op on an already-closed handle)
        self._close_master()

    def _close_master(self) -> None:
        """Destroy the native handle serialized against BOTH in-flight RPC
        dispatch (master_lock) and any debounced snapshot writer that runs
        outside it (_write_lock) — never a use-after-free under the lib."""
        if self.snap is not None:
            with self.snap._write_lock, self.master_lock:
                self.master.close()
        else:
            with self.master_lock:
                self.master.close()

    def kill(self) -> None:
        """Crash semantics (chaos master_kill): stop serving abruptly — NO
        final snapshot, so recovery exercises the last debounced on-disk
        state, exactly like a real master death."""
        if self._killed or self._stopped:
            return
        self._killed = True
        self._stop_evt.set()

        def _die():
            try:
                if self._thread is not None:
                    self._srv.shutdown()
                self._srv.server_close()
            except OSError:
                pass
            self._close_master()

        # shutdown() must not run on a handler thread holding the serve loop's
        # attention — a dedicated thread severs everything without deadlock
        threading.Thread(target=_die, daemon=True).start()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)


def standby_master(
    primary: EndpointsLike,
    host: str = "127.0.0.1",
    port: int = 0,
    snapshot_path: Optional[str] = None,
    poll_s: float = 0.2,
    confirm_failures: int = 2,
    max_wait_s: Optional[float] = None,
    stop_evt: Optional[threading.Event] = None,
    **server_kw,
) -> Optional[MasterServer]:
    """Warm-standby loop: watch `primary`; when it stays unreachable for
    `confirm_failures` consecutive probes, restore the shared snapshot and
    start serving on (host, port). Blocks until takeover (returns the started
    server), `max_wait_s` elapses, or `stop_evt` is set (returns None).

    The standby does NOT bind its port before takeover — a client failing
    over early gets connection-refused and keeps rotating. Death evidence is
    weighed: a refused/unreachable probe counts fully, a TIMED-OUT probe
    (slow ≠ dead) only half, and a final patient probe must still fail
    before binding — a briefly-overloaded primary is not usurped. Without a
    consensus backend this is still a heuristic: a primary alive on the far
    side of a real network partition can double-serve; production
    deployments should fence via the shared snapshot storage.

    The watch/confirm loop itself is `runtime/election.py` —
    this is the master-plane consumer of the same primitive `RouterStandby`
    and `AutoscalerStandby` stand on."""
    from paddle_tpu_torch.runtime.election import watch_primary

    token = watch_primary(
        primary, plane="master", poll_s=poll_s,
        confirm_failures=confirm_failures, max_wait_s=max_wait_s,
        stop_evt=stop_evt,
    )
    if token is None:
        return None
    log.warning(
        "standby master (incarnation %s) taking over on %s:%d from "
        "snapshot %s", token, host, port, snapshot_path,
    )
    return MasterServer(
        host=host, port=port, snapshot_path=snapshot_path, **server_kw
    ).start()


# exit code of a served master that died to the master_kill chaos site —
# distinct from 0 (clean stop) so a supervisor/test can tell crash from stop
KILLED_EXIT = 17


def _main(argv: Optional[List[str]] = None) -> int:
    """`python -m paddle_tpu_torch.runtime.master serve|standby ...` — a master (or
    warm standby) as its own OS process, for the multi-process chaos
    scenarios (a killed primary, a standby taking over)."""
    import argparse
    import signal as _signal

    ap = argparse.ArgumentParser(prog="paddle_tpu_torch.runtime.master")
    sub = ap.add_subparsers(dest="role", required=True)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--host", default="127.0.0.1")
    common.add_argument("--port", type=int, required=True)
    common.add_argument("--snapshot", default=None)
    common.add_argument("--lease_s", type=float, default=10.0)
    common.add_argument("--snapshot_every", type=int, default=1)
    common.add_argument("--snapshot_interval_s", type=float, default=0.0)
    common.add_argument("--timeout_s", type=float, default=60.0)
    common.add_argument("--failure_max", type=int, default=3)
    common.add_argument("--faults", default=None)
    common.add_argument("--faults_seed", type=int, default=0)
    common.add_argument(
        "--initial_world", type=int, default=0,
        help="seed the resize plane's world: the training world size the "
             "autoscaler reads from stats()['resize']['world'] before the "
             "first epoch",
    )
    common.add_argument(
        "--trace", type=int, default=0,
        help="1 = record RPC spans into the ring buffer (also settable via "
             "PADDLE_TPU_TRACE); fetch them with the trace_export RPC or "
             "`python -m paddle_tpu_torch.obs trace --endpoint host:port`",
    )
    sub.add_parser("serve", parents=[common])
    st = sub.add_parser("standby", parents=[common])
    st.add_argument("--primary", required=True, help="host:port to watch")
    st.add_argument("--poll_s", type=float, default=0.2)
    st.add_argument("--max_wait_s", type=float, default=None)
    args = ap.parse_args(argv)

    if args.faults:
        faults.get().configure(args.faults, args.faults_seed)
    if args.trace:
        obs_trace.enable_tracing(True)

    def build() -> MasterServer:
        return MasterServer(
            TaskMaster(timeout_s=args.timeout_s, failure_max=args.failure_max),
            host=args.host,
            port=args.port,
            snapshot_path=args.snapshot,
            lease_s=args.lease_s,
            snapshot_every=args.snapshot_every,
            snapshot_interval_s=args.snapshot_interval_s,
            initial_world=args.initial_world,
        ).start()

    if args.role == "serve":
        server = build()
    else:
        got = standby_master(
            args.primary,
            host=args.host,
            port=args.port,
            snapshot_path=args.snapshot,
            poll_s=args.poll_s,
            max_wait_s=args.max_wait_s,
            master=TaskMaster(
                timeout_s=args.timeout_s, failure_max=args.failure_max
            ),
            lease_s=args.lease_s,
            snapshot_every=args.snapshot_every,
            snapshot_interval_s=args.snapshot_interval_s,
            initial_world=args.initial_world,
        )
        if got is None:
            print(json.dumps({"role": args.role, "takeover": False}), flush=True)
            return 3
        server = got

    _signal.signal(_signal.SIGTERM, lambda *_: server.stop())
    _signal.signal(_signal.SIGINT, lambda *_: server.stop())
    print(
        json.dumps({"role": args.role, "address": list(server.address)}),
        flush=True,
    )
    while server.alive:
        time.sleep(0.05)
    # distinguish the chaos master_kill crash from a clean SIGTERM stop
    return KILLED_EXIT if server._killed else 0


class _CountingReader:
    """Buffered-reader wrapper that counts received bytes into its owning
    MasterClient — the wire-economics observability (bytes per delivered
    token, bytes per task) the benches report rides on these counters."""

    __slots__ = ("_f", "_owner")

    def __init__(self, f, owner: "MasterClient"):
        self._f = f
        self._owner = owner

    def read(self, n: int = -1) -> bytes:
        b = self._f.read(n)
        self._owner.bytes_received += len(b)
        return b

    def readline(self) -> bytes:
        b = self._f.readline()
        self._owner.bytes_received += len(b)
        return b

    def __iter__(self):
        return self

    def __next__(self) -> bytes:
        b = self.readline()
        if not b:
            raise StopIteration
        return b

    def close(self) -> None:
        self._f.close()


class MasterClient:
    """Blocking RPC client with reconnect + endpoint failover
    (go/master/client.go parity), speaking either wire.

    `address` may be one endpoint or a failover list ((h, p), "h:p",
    "a:p1,b:p2", or a sequence of those — the CLI's --master_endpoints form).
    Failed calls reconnect and retry with bounded exponential backoff plus
    jitter (the Go client's backoff discipline; jitter keeps a restarted
    master from being stampeded by every trainer retrying in lockstep),
    rotating to the next endpoint on every reconnect so a dead primary's
    standby is found inside the same loop. After `retries` attempts
    (default: enough for several full rotations) the terminal ConnectionError
    names the method, the endpoints, the attempt count and the last
    underlying error.

    Wire: each connection opens with the line-JSON `_hello`
    probe; a frames-capable server upgrades the connection to the binary
    frame layer (runtime/frames.py — pipelining via `call_many`, binary
    token payloads, header trace context, piggybacked control signals), a
    legacy server refuses and the client stays line-JSON (memoized per
    endpoint so later reconnects skip the probe). `wire` /
    `PADDLE_TPU_WIRE` selects: "auto" (default), "json" (never probe),
    "frames" (downgrade is an error). All traffic rides ONE socket per
    endpoint; `close()` releases the buffered reader and writer with it."""

    def __init__(
        self,
        address: EndpointsLike,
        timeout: float = 30.0,
        retries: Optional[int] = None,
        backoff_base: float = 0.05,
        backoff_max: float = 2.0,
        wire: Optional[str] = None,
        on_piggyback: Optional[Callable[[Dict[str, Any]], None]] = None,
    ):
        self.endpoints = parse_endpoints(address)
        self.timeout = timeout
        self.retries = (
            max(1, int(retries))
            if retries is not None
            else max(5, 4 * len(self.endpoints))
        )
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.wire = (wire or os.environ.get("PADDLE_TPU_WIRE", "auto")).lower()
        # piggybacked control signals stripped off data replies (`_rz`, the
        # resize drain signal) land here instead of surprising callers
        self.on_piggyback = on_piggyback
        self._i = 0
        self._sock: Optional[socket.socket] = None
        self._rfile: Optional[_CountingReader] = None
        self._wfile = None
        self._framed = False
        self._req_seq = 0
        # endpoints that refused the hello probe: line-JSON forever (well,
        # until this client object dies) — no re-probe per reconnect
        self._legacy: Set[Endpoint] = set()
        self.bytes_sent = 0
        self.bytes_received = 0
        self.round_trips = 0
        # monotonic stamp of the last successful RPC: the heartbeat
        # suppression signal (_Heartbeater skips while data-plane traffic
        # bearing the trainer_id is fresher than a heartbeat would be)
        self.last_rpc = 0.0

    @property
    def address(self) -> Endpoint:
        """The endpoint currently in use (compat with the single-address API)."""
        return self.endpoints[self._i]

    @property
    def wire_framed(self) -> bool:
        """True when the CURRENT connection negotiated the frame layer."""
        return self._framed

    def _connect(self):
        if self._sock is not None:
            return
        self._sock = socket.create_connection(self.address, timeout=self.timeout)
        # requests are small single writes: NODELAY keeps one from waiting
        # behind the server's delayed ACK of the last (Nagle)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._rfile = _CountingReader(self._sock.makefile("rb"), self)
        self._wfile = self._sock.makefile("wb")
        self._framed = False
        if self.wire != "json" and self.address not in self._legacy:
            self._hello()

    def _hello(self) -> None:
        """Wire negotiation: one line-JSON probe per fresh connection. A
        legacy server answers unknown-method (memoized: later reconnects to
        that endpoint skip the probe), a frames-capable one answers
        {"frames": 1} and this connection switches to the frame layer."""
        probe = json.dumps({"method": "_hello", "frames": 1}).encode() + b"\n"
        self._sock.sendall(probe)
        self.bytes_sent += len(probe)
        line = self._rfile.readline()
        if not line:
            raise ConnectionError("master closed connection during hello")
        if json.loads(line).get("frames") == 1:
            self._framed = True
            return
        if self.wire == "frames":
            raise ConnectionError(
                f"endpoint {self.address} refused the frame layer and "
                f"wire='frames' forbids the line-JSON downgrade"
            )
        self._legacy.add(self.address)

    def _rotate(self) -> None:
        if len(self.endpoints) > 1:
            self._i = (self._i + 1) % len(self.endpoints)
            stats.FT_EVENTS.incr("master_failover")
            log.warning("master failover: trying endpoint %s:%d", *self.address)

    def _send(self, req: dict) -> int:
        """Write one request on the current wire; returns its req_id (0 on
        line JSON). frames.write_frame is THE frame-encode site — no
        json.dumps on the framed path (hot-loop lint)."""
        if self._framed:
            self._req_seq = ((self._req_seq + 1) & 0xFFFFFFFF) or 1
            self.bytes_sent += frames.write_frame(
                self._wfile, req, req_id=self._req_seq
            )
            return self._req_seq
        msg = json.dumps(req).encode() + b"\n"
        self._sock.sendall(msg)
        self.bytes_sent += len(msg)
        return 0

    def _recv(self, want_rid: int) -> dict:
        if self._framed:
            got = frames.read_frame(self._rfile)
            if got is None:
                raise ConnectionError("master closed connection")
            resp, rid, flags, blob = got
            if rid != want_rid:
                raise frames.FrameError(
                    f"reply id {rid} does not match request {want_rid}"
                )
            return frames.decode_payload(resp, rid, flags, blob)
        line = self._rfile.readline()
        if not line:
            raise ConnectionError("master closed connection")
        return json.loads(line)

    def _absorb(self, resp: dict) -> dict:
        """Per-reply bookkeeping: stamp data-plane freshness (heartbeat
        suppression) and strip piggybacked control signals to the
        on_piggyback hook."""
        self.last_rpc = time.monotonic()
        if isinstance(resp, dict) and "_rz" in resp:
            rz = resp.pop("_rz")
            if self.on_piggyback is not None:
                try:
                    self.on_piggyback(rz)
                except Exception:
                    log.exception("piggyback callback failed")
        return resp

    def call(self, method: str, **kw) -> dict:
        """One RPC (with reconnect/failover/backoff). With tracing enabled
        the call runs inside a client span and piggybacks its context on the
        frame (`_trace` — moved into the binary header on a framed
        connection), so the server's handler span joins this trace."""
        if obs_trace.TRACER.enabled:
            with obs_trace.span("rpc." + method, side="client") as sp:
                kw["_trace"] = {"t": sp.trace_id, "s": sp.span_id}
                return self._call(method, kw)
        return self._call(method, kw)

    def call_many(self, calls: Sequence[Tuple[str, dict]]) -> List[dict]:
        """Pipelined batch: write every request back-to-back on
        the ONE socket, then collect the replies in order, matched by
        request id — N calls for one round trip of latency (the server
        processes a connection's frames sequentially and answers in
        arrival order). On a line-JSON connection this degrades to serial
        `call`s. A connection failure retries the WHOLE batch through the
        same reconnect/failover/backoff path as `call`, so callers pass
        retry-exact requests (idempotency keys) — the discipline every RPC
        here already follows."""
        if not calls:
            return []
        last_err: Optional[Exception] = None
        for attempt in range(self.retries):
            try:
                self._connect()
                if not self._framed:
                    return [self._call(m, dict(kw)) for m, kw in calls]
                if faults.get().fire("conn_reset"):
                    # chaos hook: the socket resets with the batch in
                    # flight — the retry must re-send ALL of it
                    raise ConnectionResetError("injected conn_reset (chaos)")
                rids = [self._send({"method": m, **kw}) for m, kw in calls]
                out = [self._absorb(self._recv(rid)) for rid in rids]
                self.round_trips += 1
                return out
            except (OSError, ConnectionError, json.JSONDecodeError) as e:
                last_err = e
                self.close()
                stats.FT_EVENTS.incr("master_reconnect")
                self._rotate()
                if attempt + 1 < self.retries:
                    delay = min(self.backoff_max, self.backoff_base * 2 ** attempt)
                    delay *= 0.5 + random.random() / 2
                    log.warning(
                        "pipelined batch of %d failed (%s: %s); reconnecting "
                        "in %.0fms (attempt %d/%d)", len(calls),
                        type(e).__name__, e, delay * 1e3, attempt + 1,
                        self.retries,
                    )
                    time.sleep(delay)
        raise ConnectionError(
            f"pipelined batch of {len(calls)} to {self.endpoints} failed "
            f"after {self.retries} attempts; giving up (last error: "
            f"{type(last_err).__name__}: {last_err})"
        ) from last_err

    def _call(self, method: str, kw: dict) -> dict:
        last_err: Optional[Exception] = None
        for attempt in range(self.retries):
            try:
                self._connect()
                if faults.get().fire("conn_reset"):
                    # chaos hook: network partition/RST between trainer and
                    # master — the reconnect/failover path must absorb it
                    raise ConnectionResetError("injected conn_reset (chaos)")
                rid = self._send({"method": method, **kw})
                resp = self._recv(rid)
                self.round_trips += 1
                return self._absorb(resp)
            except (OSError, ConnectionError, json.JSONDecodeError) as e:
                last_err = e
                self.close()
                stats.FT_EVENTS.incr("master_reconnect")
                self._rotate()
                if attempt + 1 < self.retries:
                    delay = min(self.backoff_max, self.backoff_base * 2 ** attempt)
                    delay *= 0.5 + random.random() / 2  # full-jitter in [.5d, d)
                    log.warning(
                        "master RPC %r failed (%s: %s); reconnecting in %.0fms "
                        "(attempt %d/%d)", method, type(e).__name__, e,
                        delay * 1e3, attempt + 1, self.retries,
                    )
                    time.sleep(delay)
        raise ConnectionError(
            f"master RPC {method!r} to {self.endpoints} failed after "
            f"{self.retries} attempts; giving up (last error: "
            f"{type(last_err).__name__}: {last_err})"
        ) from last_err

    def call_stream(self, method: str, **kw) -> Iterator[dict]:
        """One request whose reply is a FRAME STREAM (serving push
        streaming): the request and its FIRST reply line go
        through the normal reconnect/backoff path, then every subsequent
        line on the same connection is yielded as a frame until one
        carries `done` (or the first reply was an error). Delivered
        frames are never replayed — a mid-stream failure raises
        ConnectionError and resumable callers reattach with their token
        cursor (the serving `from` cursor), on a FRESH call. The
        connection is reusable after a clean `done`; an abandoned or
        broken stream drops it (frames may still be buffered). On a framed
        connection the pushed frames are BINARY (compact token deltas,
        runtime/frames.py) — decoded here back to the exact dicts a
        line-JSON peer would see."""
        first = self._call(method, kw)
        yield first
        if "err" in first:
            return
        clean = False
        try:
            if self._framed:
                while True:
                    got = frames.read_frame(self._rfile)
                    if got is None:
                        raise ConnectionError(
                            "stream closed before its final frame"
                        )
                    obj, rid, flags, blob = got
                    frame = self._absorb(
                        frames.decode_payload(obj, rid, flags, blob)
                    )
                    if frame.get("done"):
                        clean = True
                        yield frame
                        return
                    yield frame
            for line in self._rfile:
                try:
                    frame = json.loads(line)
                except json.JSONDecodeError as e:
                    raise ConnectionError(f"bad stream frame: {e}") from e
                if frame.get("done"):
                    clean = True
                    yield frame
                    return
                yield frame
            raise ConnectionError("stream closed before its final frame")
        except OSError as e:
            raise ConnectionError(f"stream broke mid-flight: {e}") from e
        finally:
            if not clean:
                self.close()

    def close(self) -> None:
        # hygiene: the buffered reader/writer makefile objects
        # are closed WITH the socket — the old path nulled the reader
        # without closing it, leaking the buffer until GC on every
        # reconnect of a long-lived client
        for f in (self._rfile, self._wfile):
            if f is not None:
                try:
                    f.close()
                except OSError:
                    pass
        self._rfile = None
        self._wfile = None
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        self._framed = False


class _Heartbeater:
    """Background lease renewal on its OWN connection (the reader's socket is
    busy inside blocking calls; sharing it would interleave frames).

    Heartbeat REPLIES carry the master's piggybacked resize drain signal
    while an epoch is active; it is stashed on the shared `ident` dict
    (`ident["resize"]`) for the reader's between-task drain check and handed
    to `on_resize` (the ResizeClient's watcher) when given."""

    def __init__(
        self,
        address: EndpointsLike,
        ident: Dict[str, Any],
        client_kw: Optional[dict] = None,
        on_resize: Optional[Callable[[Dict[str, Any]], None]] = None,
    ):
        self._ident = ident
        self._client = MasterClient(address, **(client_kw or {}))
        self._on_resize = on_resize
        self.skipped = 0
        self._skip_streak = 0
        self._evt = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="master-heartbeat", daemon=True
        )

    def start(self) -> "_Heartbeater":
        self._thread.start()
        return self

    def _loop(self) -> None:
        while True:
            period = max(0.05, float(self._ident.get("lease_s", 10.0)) / 3.0)
            if self._evt.wait(period):
                return
            tid = self._ident.get("trainer_id")
            if tid is None:
                continue
            last = self._ident.get("last_rpc")
            if (
                last is not None
                and time.monotonic() - last < period
                and self._skip_streak < 2
            ):
                # piggyback discipline: fresh data-plane traffic
                # bearing this trainer_id already renewed the lease
                # (note_seen fires on every RPC) and carried any resize
                # signal on its framed reply (`_rz`) — an explicit
                # heartbeat would be a pure extra round trip. Capped at 2
                # consecutive skips so the metrics snapshot still reaches
                # the fleet aggregate at a third of the usual cadence.
                self.skipped += 1
                self._skip_streak += 1
                stats.FT_EVENTS.incr("heartbeat_piggybacked")
                continue
            self._skip_streak = 0
            try:
                # metrics snapshot piggybacks on the lease renewal — the
                # master aggregates these into its fleet-wide stats() view
                hb_kw: Dict[str, Any] = {
                    "trainer_id": tid,
                    "metrics": obs_metrics.snapshot(),
                }
                if self._ident.get("role"):
                    # re-assert the lease role so an adoption after master
                    # failover heals the type (reader vs trainer) too
                    hb_kw["role"] = self._ident["role"]
                resp = self._client.call("heartbeat", **hb_kw)
            except ConnectionError:
                # terminal after retries+failover — the lease will lapse and
                # the master re-queues our tasks; the reader's own calls will
                # surface the outage, nothing more to do here
                stats.FT_EVENTS.incr("heartbeat_lost")
                continue
            rz = resp.get("resize") if isinstance(resp, dict) else None
            if rz:
                self._ident["resize"] = rz
                if self._on_resize is not None:
                    try:
                        self._on_resize(rz)
                    except Exception:
                        log.exception("resize watcher callback failed")

    def stop(self) -> None:
        self._evt.set()
        self._thread.join(timeout=5.0)
        self._client.close()


def _barrier_master_lost(
    epoch: int, fallback_world: int, err: Exception
) -> int:
    """The master died mid-epoch (retries exhausted): the documented
    proceed-alone fallback, not a crash of the training pass."""
    stats.FT_EVENTS.incr("resize_barrier_master_lost")
    log.warning(
        "resize epoch %d: master unreachable at the drain barrier (%s) — "
        "proceeding alone with world=%d", epoch, err, fallback_world,
    )
    return fallback_world


# cluster_reader idents living in THIS process, so a co-resident trainer's
# drain barrier can ack on their behalf (see _service_reader_drains)
_READER_IDENTS: List[Dict[str, Any]] = []
_READER_IDENTS_LOCK = threading.Lock()


def _service_reader_drains(client: MasterClient) -> None:
    """Ack the drain for any cluster_reader lease in THIS process whose
    consuming loop cannot reach its own between-task boundary right now —
    in the two-lease setup the reader feeds the very train loop that is
    parked inside the trainer's drain barrier (same thread), so without
    this the barrier and the reader serialize into a circular wait the
    master could only break by timing the healthy reader lease out. A
    reader lease holds no in-flight RESIZE obligation beyond its ack (task
    accounting is lease-based either way); its resumed ack still rides the
    reader's next boundary poll."""
    with _READER_IDENTS_LOCK:
        idents = list(_READER_IDENTS)
    for ident in idents:
        info = ident.get("resize")
        tid = ident.get("trainer_id")
        if not info or tid is None or info.get("state") != "draining":
            continue
        try:
            epoch = int(info.get("epoch", 0))
        except (TypeError, ValueError):
            continue
        key = (info.get("instance"), epoch)
        if key == ident.get("resize_done"):
            continue
        try:
            client.call("resize_drained", trainer_id=tid, epoch=epoch)
        except ConnectionError:
            continue  # the reader's own boundary (or eviction) handles it
        stats.FT_EVENTS.incr("reader_resize_drain")
        ident["resize_done"] = key
        ident["resize_resume"] = epoch
        ident.pop("resize", None)


def _drain_barrier(
    client: MasterClient,
    trainer_id: str,
    epoch: int,
    fallback_world: int,
    poll_s: float = 0.1,
    max_wait_s: float = 120.0,
) -> int:
    """One member's walk through the drain barrier: ack `resize_drained`,
    poll `resize_status` until the epoch leaves `draining` (every live member
    acked, or the stragglers were evicted), mark resumed, and return the
    final world size. A barrier that never resolves within `max_wait_s`
    (master gone mid-epoch) falls back to the announced world so the member
    can proceed alone."""
    # chaos hook: wedge INSIDE the barrier without acking — the master's
    # drain timeout (or lease eviction, if heartbeats stop too) must remove
    # this member for the epoch to complete
    faults.maybe_stall("resize_drain_stall", env="PADDLE_TPU_RESIZE_STALL_S")
    try:
        info = client.call("resize_drained", trainer_id=trainer_id, epoch=epoch)
    except ConnectionError as e:
        return _barrier_master_lost(epoch, fallback_world, e)
    deadline = time.monotonic() + max_wait_s
    while info.get("state") == "draining" and info.get("epoch") == epoch:
        if time.monotonic() > deadline:
            log.warning(
                "resize epoch %d: drain barrier unresolved after %.0fs — "
                "proceeding alone with world=%d", epoch, max_wait_s,
                fallback_world,
            )
            return fallback_world
        # co-resident reader leases can't ack while we hold their consumer
        # thread here; their heartbeat stash may land at any poll, so
        # service them every iteration (no-op when nothing is stashed)
        _service_reader_drains(client)
        time.sleep(poll_s)
        try:
            info = client.call(
                "resize_status", trainer_id=trainer_id, epoch=epoch
            )
        except ConnectionError as e:
            return _barrier_master_lost(epoch, fallback_world, e)
    if info.get("state") == "go" and info.get("epoch") == epoch:
        # the status poll that observes `go` is the resumed ack; make sure
        # one landed even when the drained reply itself already said go
        try:
            info = client.call(
                "resize_status", trainer_id=trainer_id, epoch=epoch
            )
        except ConnectionError:
            # the master decided `go` and then died: the observed world IS
            # the decision — proceed with it; there is nobody left to ack
            stats.FT_EVENTS.incr("resize_barrier_master_lost")
    if info.get("epoch") == epoch and info.get("world"):
        return int(info["world"])
    last = info.get("last") or {}
    if last.get("epoch") == epoch and last.get("world"):
        # the epoch completed (and went idle) before we looked
        return int(last["world"])
    return fallback_world


class ResizeClient:
    """Trainer-side fleet hook for elastic resize.

    Registers a membership lease, heartbeats it from a background thread,
    and watches the heartbeat replies for an announced resize epoch: on
    `draining` it parks a resize order on the core.preempt guard, which the
    train loop claims at its next dispatch boundary. Pass `barrier` as
    `SGDTrainer.train(resize_barrier=...)` — after the trainer's mid-pass
    drain checkpoint it acks `resize_drained`, blocks until every live
    member drained (or was evicted), and returns the final world size to
    re-shard to.

        rc = ResizeClient("host:p1,host:p2")
        trainer.train(reader, resize_barrier=rc.barrier, ...)
        rc.close()

    A data-parallel job of several rank processes holds one, on rank 0:
    the master counts one trainer a job, as it does for the JAX package's
    one process. Rank 0 alone reads the parked order and walks the barrier;
    every rank passes `train(elastic=True)`, reads rank 0's decision for
    each dispatch boundary from the job's store, and receives the world the
    barrier returned by a broadcast over the old group (`SGDTrainer.
    _drain_resize`). CLI: `train --trainer_count=N --elastic=1
    --master_endpoints=...`.

    A trainer that ALSO consumes tasks via cluster_reader holds two
    membership leases (the reader's and this one); both join the drain
    barrier and both ack — the reader between tasks (without blocking for
    go), this client at the trainer's batch boundary. When the resize lands
    mid-task the trainer drains first while it holds the reader's consumer
    thread, so the barrier acks the reader lease on its behalf
    (_service_reader_drains) instead of waiting for a boundary that cannot
    come."""

    def __init__(
        self,
        address: EndpointsLike,
        client_kw: Optional[dict] = None,
        poll_s: float = 0.1,
        max_wait_s: float = 120.0,
    ):
        self._client = MasterClient(address, **(client_kw or {}))
        resp = self._client.call("register")
        if "trainer_id" not in resp:
            raise ConnectionError(
                f"resize client could not register with the master: {resp}"
            )
        self.trainer_id = resp["trainer_id"]
        self._ident: Dict[str, Any] = {
            "trainer_id": self.trainer_id,
            "lease_s": float(resp.get("lease_s", 10.0)),
        }
        self.poll_s = poll_s
        self.max_wait_s = max_wait_s
        self._seen: Optional[Tuple[Any, int]] = None
        self._hb = _Heartbeater(
            address, self._ident, client_kw=client_kw, on_resize=self._watch
        ).start()

    def _watch(self, info: Dict[str, Any]) -> None:
        """Heartbeat-thread hook: turn a newly-announced epoch into a parked
        resize order (idempotent per epoch — re-announcements of an epoch we
        already claimed must not re-trigger a drain). The epoch's identity
        is (master instance, epoch number), compared by equality: epoch
        numbers are per-master-instance counters, so a restarted/standby
        master announcing a number we already handled — equal OR lower — is
        a genuinely new epoch, and suppressing it would silently exempt
        this trainer from every resize the new master coordinates."""
        from paddle_tpu_torch.core import preempt

        try:
            epoch = int(info.get("epoch", 0))
            world = int(info.get("world", 0))
        except (TypeError, ValueError):
            return
        if info.get("state") != "draining" or world < 1:
            return
        key = (info.get("instance"), epoch)
        if key == self._seen:
            return
        self._seen = key
        preempt.get().request_resize(
            world, epoch=epoch, instance=info.get("instance") or "",
            reason="master resize epoch",
        )

    def barrier(self, req, pass_id: int, batches_done: int) -> int:
        """The train(resize_barrier=...) callable (see _drain_barrier)."""
        return _drain_barrier(
            self._client, self.trainer_id, req.epoch, req.world,
            poll_s=self.poll_s, max_wait_s=self.max_wait_s,
        )

    def close(self) -> None:
        self._hb.stop()
        try:
            self._client.call("deregister", trainer_id=self.trainer_id)
        except ConnectionError:
            pass  # lease will simply expire
        self._client.close()


def cluster_reader(
    master_address: EndpointsLike,
    deserialize: Callable[[bytes], Any] = None,
    poll_interval: float = 0.5,
    register: bool = True,
    client_kw: Optional[dict] = None,
    lease_batch: int = 1,
) -> Callable[[], Iterator[Any]]:
    """v2 cluster reader (master/client.py:15): pull tasks from the master,
    stream their recordio shards, ack on completion, report failures. One
    call of the returned reader = one pass.

    `master_address` may be a failover list (see MasterClient). With
    `register=True` the reader takes out a membership lease and renews it
    from a background heartbeat thread, so a trainer that dies mid-task is
    evicted and its tasks re-queued eagerly rather than after the per-task
    timeout; the lease is released (`deregister`) on a clean pass end.

    Wire economics: tasks are leased through the bulk
    `get_tasks` form — up to `lease_batch` tasks per round trip, with the
    PREVIOUS batch's done acks piggybacked on the same request, so the
    steady-state cost is 1/lease_batch round trips per task where the
    single-task surface paid 2 (lease + ack). Failure acks flush eagerly.
    Deferred done acks are flushed before joining a resize drain barrier
    (the lease must hold no half-acked task across an epoch) and on every
    exit path; an ack lost to a crash replays its task — exactly the
    at-least-once delivery the single-task ack-loss path already had. On a
    framed connection the resize drain signal also piggybacks on data
    replies and the heartbeat thread stands down while data-plane traffic
    is fresh (_Heartbeater), cutting the idle control chatter too.

    Elastic resize: a registered reader is a drain-barrier MEMBER. When the
    heartbeat thread sees an announced epoch it stashes the signal on the
    shared ident; the reader drains at its natural boundary — between task
    acks, holding no in-flight task (so the master's exactly-once accounting
    needs no special casing) — and acks `resize_drained` WITHOUT blocking
    for go (in the two-lease setup the trainer lease's ack, which go also
    needs, can only happen after this reader yields back to the train loop);
    the resumed ack rides a `resize_status` poll at a later boundary."""
    import pickle

    deserialize = deserialize or pickle.loads

    def _maybe_drain(client: MasterClient, ident: Dict[str, Any]) -> None:
        tid = ident.get("trainer_id")
        if tid is None:
            return
        pending = ident.get("resize_resume")
        if pending is not None:
            # a previous boundary acked the drain without blocking; finish
            # the epoch's bookkeeping now — a resize_status poll that
            # observes `go` IS this lease's resumed ack (any other state
            # means the epoch moved on without us, e.g. closed by the
            # go-phase timeout or eviction — nothing left to ack)
            try:
                st = client.call("resize_status", trainer_id=tid, epoch=pending)
            except ConnectionError:
                st = {}
            if st.get("state") != "draining" or st.get("epoch") != pending:
                ident.pop("resize_resume", None)
        info = ident.get("resize")
        if not info:
            return
        try:
            epoch = int(info.get("epoch", 0))
        except (TypeError, ValueError):
            ident.pop("resize", None)
            return
        # the epoch's identity is (master instance, number) — see
        # ResizeClient._watch: a restarted master re-counts from 1, so a
        # number collision with the last drained epoch of a PREVIOUS
        # master must not make this reader skip the new master's barrier
        key = (info.get("instance"), epoch)
        if info.get("state") != "draining" or key == ident.get("resize_done"):
            ident.pop("resize", None)
            return
        # ack the drain WITHOUT blocking for go: when the process also runs
        # a ResizeClient-coordinated trainer on this thread (the documented
        # two-lease setup), go needs the trainer lease's ack too — and that
        # ack only happens once this reader yields back to the train loop's
        # dispatch boundary, so waiting here would serialize into a circular
        # wait the master could only break by timing out a healthy lease.
        # The reader holds no in-flight task at this point either way, which
        # is all the exactly-once accounting needs; the resumed ack rides
        # the status poll at a later boundary (or, for a pass that ends
        # first, deregister's barrier drop closes the epoch).
        faults.maybe_stall("resize_drain_stall", env="PADDLE_TPU_RESIZE_STALL_S")
        try:
            client.call("resize_drained", trainer_id=tid, epoch=epoch)
        except ConnectionError as e:
            _barrier_master_lost(epoch, int(info.get("world", 0) or 0), e)
            ident.pop("resize", None)
            return
        stats.FT_EVENTS.incr("reader_resize_drain")
        ident["resize_resume"] = epoch
        ident["resize_done"] = key
        ident.pop("resize", None)

    def reader() -> Iterator[Any]:
        client = MasterClient(master_address, **(client_kw or {}))
        # reader-role lease: joins resize drain barriers (and is drained
        # between task acks) but does not count toward a membership-
        # triggered world size — the process's ResizeClient lease does
        ident: Dict[str, Any] = {
            "trainer_id": None, "lease_s": 10.0, "role": "reader",
        }
        # a resize drain signal piggybacked on a framed data reply lands in
        # the same slot the heartbeat thread uses — one consumption path
        client.on_piggyback = lambda rz: ident.__setitem__("resize", rz)
        # done acks deferred onto the next get_tasks request (failed acks
        # flush eagerly); lists, drained atomically after a successful call
        pending_done: List[int] = []
        pending_failed: List[int] = []

        def _id_kw() -> Dict[str, Any]:
            return (
                {"trainer_id": ident["trainer_id"]}
                if ident["trainer_id"] is not None
                else {}
            )

        def _flush_acks() -> None:
            """Push deferred acks NOW (drain barrier / failure / pass exit
            paths) — an acks-only get_tasks (n=0) leases nothing."""
            if not (pending_done or pending_failed):
                return
            client.call(
                "get_tasks", n=0, done_ids=list(pending_done),
                failed_ids=list(pending_failed), **_id_kw(),
            )
            pending_done.clear()
            pending_failed.clear()

        hb: Optional[_Heartbeater] = None
        try:
            if register:
                resp = client.call("register", role="reader")
                if "trainer_id" in resp:
                    ident["trainer_id"] = resp["trainer_id"]
                    ident["lease_s"] = float(resp.get("lease_s", 10.0))
                    hb = _Heartbeater(
                        master_address, ident, client_kw=client_kw
                    ).start()
                    # visible to a co-resident trainer's drain barrier, which
                    # acks on our behalf while it holds our consumer thread
                    # (see _service_reader_drains)
                    with _READER_IDENTS_LOCK:
                        _READER_IDENTS.append(ident)
            while True:
                # between-task boundary: no task leased to us right now, so
                # joining a resize drain barrier here keeps the master's
                # todo/pending/done books untouched. Flush deferred acks
                # FIRST when an epoch is announced — the lease must hold no
                # half-acked task across the barrier.
                if ident.get("resize") is not None:
                    _flush_acks()
                _maybe_drain(client, ident)
                resp = client.call(
                    "get_tasks", n=max(1, int(lease_batch)),
                    done_ids=list(pending_done),
                    failed_ids=list(pending_failed), **_id_kw(),
                )
                pending_done.clear()
                pending_failed.clear()
                if client.wire_framed:
                    # signal the heartbeat thread that data-plane traffic is
                    # carrying the lease (note_seen) + the resize piggyback
                    ident["last_rpc"] = client.last_rpc
                if resp.get("pass_finished"):
                    return
                tasks = resp.get("tasks") or []
                if not tasks:
                    time.sleep(poll_interval)
                    continue
                for t in tasks:
                    task_id, shards = t["task_id"], t["shards"]
                    try:
                        yield from recordio.read_shards(shards, deserialize)
                    except BaseException:
                        # the failure ack itself can fail (master died too) —
                        # it must never mask the original shard-read error;
                        # the lease timeout replays the task either way.
                        # Unconsumed tasks from this batch replay the same
                        # way (crash semantics).
                        pending_failed.append(task_id)
                        try:
                            _flush_acks()
                        except ConnectionError as ack_err:
                            stats.FT_EVENTS.incr("task_ack_failed")
                            log.warning(
                                "failure ack for task %d lost (%s); the task "
                                "replays after its lease times out",
                                task_id, ack_err,
                            )
                            # drop them: the finally-flush would only repeat
                            # the terminal retry loop against a dead master
                            pending_done.clear()
                            pending_failed.clear()
                        raise
                    # the done ack rides the NEXT get_tasks request — one
                    # round trip per lease_batch tasks, not one per ack
                    pending_done.append(task_id)
        finally:
            if hb is not None:
                hb.stop()
            with _READER_IDENTS_LOCK:
                _READER_IDENTS[:] = [
                    d for d in _READER_IDENTS if d is not ident
                ]
            try:
                _flush_acks()
            except ConnectionError as ack_err:
                stats.FT_EVENTS.incr("task_ack_failed")
                log.warning(
                    "final ack flush of %d task(s) failed (%s); they replay "
                    "after their leases time out — records from them will be "
                    "delivered again", len(pending_done), ack_err,
                )
            if ident["trainer_id"] is not None:
                try:
                    client.call("deregister", trainer_id=ident["trainer_id"])
                except ConnectionError:
                    pass  # lease will simply expire
            client.close()

    return reader


if __name__ == "__main__":
    import sys

    sys.exit(_main())
