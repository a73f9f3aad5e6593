"""Goodput-driven autoscaler: one resource plane for training and serving
(the port's copy of `paddle_tpu/runtime/autoscaler.py`).

It closes the loop between signals the fleet already reports (the
master's fleet aggregate and resize-epoch info, the router's queue-wait /
shed / deadline-miss view) and levers it already has (planned replica
drain, elastic resize epochs, spawning a replica), so training borrows
chips from an idle serving fleet and hands them back under load.

Three pieces, separable on purpose:

  * `ScaleDecider` — the PURE decision engine. No RPCs, no clock reads, no
    threads: every input (including `now`) is passed in, so hysteresis,
    cooldown, flap suppression and backoff are deterministic, and one
    synthetic signal stream gives the JAX package's actions at the same
    ticks.
  * `ReplicaSpawner` — the serving GROW lever: launches a real
    `python -m paddle_tpu_torch serve --router_endpoints ...` subprocess
    that registers itself with the router (fire-and-forget: the controller
    never blocks on a spawn).
  * `AutoscalerController` — the reconcile loop: observe → decide →
    actuate, once per tick, on its own thread.

Robustness contract:

  * STATELESS-RECONCILING: the controller journals nothing. Desired state
    is re-derived every tick from OBSERVED state — the router's replica
    views, the master's resize-epoch info (whose `world` IS the current
    training world, seeded via `MasterServer(initial_world=)`). A restarted
    controller adopts an in-flight epoch from `stats()["resize"]` and
    starts from a conservative post-start quiet period.
  * HEARTBEAT PIGGYBACK: the controller adds no RPC to a hot path. It polls
    the two existing `stats` endpoints once a tick, and every lever it
    pulls (drain / resize / spawn) is a per-DECISION call, rate-limited by
    cooldowns.
  * DEGRADED MODE IS TODAY'S STATIC FLEET: an unreachable router or master
    leaves the last snapshot cached and suppresses actuation; a dead
    controller simply stops pulling levers (the seeded `controller_kill` /
    `scale_decision_stall` fault sites drill exactly that).
  * BACKOFF, NOT HOT RETRY: a resize the master rejects (an epoch already
    in flight) or that times out backs the train lever off exponentially;
    a completed epoch resets the backoff.

CLI:
  python -m paddle_tpu_torch.runtime.autoscaler serve \
      --router HOST:PORT --master HOST:PORT --chips 8 [--tick_s 1.0] ...
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from paddle_tpu_torch.core import faults
from paddle_tpu_torch.core import stats as core_stats
from paddle_tpu_torch.obs import metrics as obs_metrics
from paddle_tpu_torch.obs import trace
from paddle_tpu_torch.runtime.election import mint_instance_token, watch_primary
from paddle_tpu_torch.runtime.master import EndpointsLike, MasterClient

import logging

log = logging.getLogger("paddle_tpu_torch.runtime.autoscaler")


class ScaleConfig:
    """Thresholds and rate limits for the decision engine. Everything is a
    plain attribute so tests and the CLI can pin exact values."""

    def __init__(
        self,
        *,
        chips_total: int = 8,
        chips_per_replica: int = 1,
        min_replicas: int = 1,
        max_replicas: int = 8,
        train_min_world: int = 0,
        train_max_world: int = 8,
        # hysteresis band on the router's fleet queue-wait estimate, plus
        # shed/deadline-miss deltas (any shed tick counts as pressure)
        high_wait_s: float = 0.5,
        low_wait_s: float = 0.05,
        high_ticks: int = 2,
        low_ticks: int = 4,
        # per-lever cooldowns: minimum spacing between two actions on the
        # same lever ('serving' = spawn/drain, 'train' = resize)
        serving_cooldown_s: float = 8.0,
        train_cooldown_s: float = 10.0,
        # flap suppressor: an action REVERSING the lever's previous
        # direction inside this window is suppressed outright — oscillating
        # load cannot thrash resize epochs faster than the window
        flap_window_s: float = 20.0,
        # post-start quiet period: a (re)started controller observes for
        # this long before its first action — the stateless-reconcile
        # discipline's substitute for a journal of recent actions
        startup_quiet_s: float = 2.0,
        # backoff after a rejected/timed-out resize: base doubling, capped
        backoff_base_s: float = 5.0,
        backoff_max_s: float = 120.0,
        resize_timeout_s: float = 60.0,
        drain_deadline_s: float = 30.0,
    ):
        self.chips_total = int(chips_total)
        self.chips_per_replica = int(chips_per_replica)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.train_min_world = int(train_min_world)
        self.train_max_world = int(train_max_world)
        self.high_wait_s = float(high_wait_s)
        self.low_wait_s = float(low_wait_s)
        self.high_ticks = int(high_ticks)
        self.low_ticks = int(low_ticks)
        self.serving_cooldown_s = float(serving_cooldown_s)
        self.train_cooldown_s = float(train_cooldown_s)
        self.flap_window_s = float(flap_window_s)
        self.startup_quiet_s = float(startup_quiet_s)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.resize_timeout_s = float(resize_timeout_s)
        self.drain_deadline_s = float(drain_deadline_s)

    def cooldown_s(self, lever: str) -> float:
        return (self.train_cooldown_s if lever == "train"
                else self.serving_cooldown_s)


class Action:
    """One lever pull the decider wants: lever is 'serving' or 'train',
    direction 'grow' or 'shrink', payload the lever-specific argument
    (target world for train, nothing for serving — the controller picks
    the drain victim from observed state)."""

    __slots__ = ("lever", "direction", "payload")

    def __init__(self, lever: str, direction: str, payload: Optional[dict] = None):
        self.lever = lever
        self.direction = direction
        self.payload = payload or {}

    def __repr__(self):
        return f"Action({self.lever}:{self.direction} {self.payload})"


class Signals:
    """One tick's observed fleet state, assembled by the controller from
    CACHED snapshots (never fetched inside decide). Tests build these by
    hand — plain attributes, no clocks, no sockets."""

    __slots__ = (
        "queue_wait_s", "shed_delta", "miss_delta",
        "live_replicas", "draining_replicas",
        "train_world", "resize_busy",
    )

    def __init__(
        self,
        queue_wait_s: float = 0.0,
        shed_delta: int = 0,
        miss_delta: int = 0,
        live_replicas: int = 0,
        draining_replicas: int = 0,
        train_world: int = 0,
        resize_busy: bool = False,
    ):
        self.queue_wait_s = float(queue_wait_s)
        self.shed_delta = int(shed_delta)
        self.miss_delta = int(miss_delta)
        self.live_replicas = int(live_replicas)
        self.draining_replicas = int(draining_replicas)
        self.train_world = int(train_world)
        self.resize_busy = bool(resize_busy)


class ScaleDecider:
    """The pure decision engine: hysteresis + per-lever cooldowns + flap
    suppression + resize backoff. At most ONE action per tick — sequencing
    (shrink training, wait for the freed chip to show up in observed state,
    then spawn) emerges from reconciliation instead of a multi-step plan
    that a crash could orphan.

    All state here is advisory rate-limiting (streak counters, last-action
    stamps, backoff): losing it on a controller restart is SAFE — the fresh
    instance starts conservative (startup_quiet_s) and re-derives desired
    state from the signals alone."""

    def __init__(self, config: Optional[ScaleConfig] = None):
        self.cfg = config or ScaleConfig()
        self._high_streak = 0
        self._low_streak = 0
        self._started_at: Optional[float] = None
        # lever -> (direction, monotonic stamp) of the last ADMITTED action
        self._last_action: Dict[str, Tuple[str, float]] = {}
        self._resize_failures = 0
        self._backoff_until = 0.0
        self.suppressed: Dict[str, int] = {}
        self.decisions = 0

    # -- backoff feedback (controller calls these from actuation results) ---
    def note_resize_rejected(self, now: float) -> float:
        """A resize the master rejected (epoch in flight) or that timed
        out: back the train lever off exponentially instead of retrying
        hot. Returns the backoff horizon."""
        self._resize_failures += 1
        delay = min(
            self.cfg.backoff_base_s * (2.0 ** (self._resize_failures - 1)),
            self.cfg.backoff_max_s,
        )
        self._backoff_until = max(self._backoff_until, now + delay)
        return self._backoff_until

    def note_resize_ok(self) -> None:
        self._resize_failures = 0
        self._backoff_until = 0.0

    @property
    def resize_failures(self) -> int:
        return self._resize_failures

    # -- the decision -------------------------------------------------------
    def _suppress(self, reason: str) -> List[Action]:
        self.suppressed[reason] = self.suppressed.get(reason, 0) + 1
        obs_metrics.observe_scale_suppressed(reason)
        return []

    def _admit(self, action: Action, now: float) -> List[Action]:
        """Rate-limit gate: startup quiet period, per-lever cooldown, flap
        window, train-lever backoff. An admitted action resets BOTH streaks
        (one action per pressure episode; the next episode re-accumulates)."""
        if now - (self._started_at or now) < self.cfg.startup_quiet_s:
            return self._suppress("startup")
        if action.lever == "train" and now < self._backoff_until:
            return self._suppress("backoff")
        last = self._last_action.get(action.lever)
        if last is not None:
            last_dir, last_ts = last
            if now - last_ts < self.cfg.cooldown_s(action.lever):
                return self._suppress("cooldown")
            if (last_dir != action.direction
                    and now - last_ts < self.cfg.flap_window_s):
                return self._suppress("flap")
        self._last_action[action.lever] = (action.direction, now)
        self._high_streak = 0
        self._low_streak = 0
        self.decisions += 1
        obs_metrics.observe_scale_decision(action.lever, action.direction)
        return [action]

    def decide(self, sig: Signals, now: float) -> List[Action]:
        """One tick: classify pressure, accumulate hysteresis streaks, and
        emit at most one admitted action. Pure — no RPCs, no clock reads
        (`now` is the controller's once-per-tick stamp); the hot-loop lint
        is pinned by the JAX package's hot-loop lint)."""
        cfg = self.cfg
        if self._started_at is None:
            self._started_at = now
        high = (
            sig.queue_wait_s > cfg.high_wait_s
            or sig.shed_delta > 0
            or sig.miss_delta > 0
        )
        low = (
            sig.queue_wait_s < cfg.low_wait_s
            and sig.shed_delta == 0
            and sig.miss_delta == 0
        )
        self._high_streak = self._high_streak + 1 if high else 0
        self._low_streak = self._low_streak + 1 if low else 0

        # chip ledger from OBSERVED state only; a draining replica still
        # holds its chip until it leaves the fleet view
        serving_chips = (
            (sig.live_replicas + sig.draining_replicas)
            * cfg.chips_per_replica
        )
        free_chips = cfg.chips_total - serving_chips - sig.train_world

        if self._high_streak >= cfg.high_ticks:
            # serving under pressure: get a replica up. Spawn when a chip
            # is free; otherwise reclaim one from training first — the
            # spawn happens on a later tick once the shrunk world is
            # observed (reconciliation, not a journaled plan)
            if (sig.live_replicas + sig.draining_replicas < cfg.max_replicas
                    and free_chips >= cfg.chips_per_replica):
                return self._admit(Action("serving", "grow"), now)
            if (sig.train_world > cfg.train_min_world
                    and not sig.resize_busy):
                return self._admit(
                    Action("train", "shrink",
                           {"world": sig.train_world - 1}), now,
                )
            return []
        if self._low_streak >= cfg.low_ticks:
            # serving idle: hand a chip to training. Drain first; grow the
            # training world only out of chips already observed free
            if sig.live_replicas > cfg.min_replicas:
                if sig.draining_replicas == 0:
                    return self._admit(Action("serving", "shrink"), now)
                return []  # a drain is already in flight; let it land
            if (free_chips >= 1 and sig.train_world < cfg.train_max_world
                    and not sig.resize_busy):
                return self._admit(
                    Action("train", "grow",
                           {"world": sig.train_world + 1}), now,
                )
        return []


class ReplicaSpawner:
    """Default serving GROW lever: launch a `python -m paddle_tpu_torch
    serve` subprocess pointed at the router. Fire-and-forget — the child
    warms up, registers itself with the router, and appears in the next
    observed snapshot; the controller never blocks on it. `extra_args`
    carries the model/engine flags of the deployment (the controller has no
    opinion on what a replica serves). With `log_dir`, child n's stdout and
    stderr go to `replica_<n>.out` / `.err` there (its final stats line
    included); without it they are discarded, as in the JAX package."""

    def __init__(
        self,
        router_endpoints: EndpointsLike,
        extra_args: Sequence[str] = ("--demo",),
        env: Optional[Dict[str, str]] = None,
        log_dir: Optional[str] = None,
    ):
        eps = router_endpoints
        if isinstance(eps, (list, tuple)) and eps and not isinstance(
            eps[0], (list, tuple)
        ):
            eps = [eps]  # one (host, port) pair
        self.router_arg = ",".join(f"{h}:{p}" for h, p in eps)
        self.extra_args = list(extra_args)
        self.env = env
        self.log_dir = log_dir
        self._procs: List[Any] = []
        self.spawned = 0

    def spawn(self):
        import os
        import subprocess
        import sys

        cmd = [
            sys.executable, "-m", "paddle_tpu_torch", "serve",
            "--port", "0", "--router_endpoints", self.router_arg,
            "--exit_on_drain",
        ] + self.extra_args
        env = dict(os.environ)
        if self.env:
            env.update(self.env)
        out = err = subprocess.DEVNULL
        if self.log_dir is not None:
            os.makedirs(self.log_dir, exist_ok=True)
            base = os.path.join(self.log_dir, f"replica_{self.spawned}")
            out, err = open(base + ".out", "w"), open(base + ".err", "w")
        try:
            proc = subprocess.Popen(cmd, env=env, stdout=out, stderr=err)
        finally:
            if self.log_dir is not None:
                out.close()
                err.close()
        self._procs.append(proc)
        self.spawned += 1
        log.warning("spawned serving replica (pid %d)", proc.pid)
        return proc

    def reap(self) -> int:
        """Drop exited children from the ledger; returns live child count."""
        self._procs = [p for p in self._procs if p.poll() is None]
        return len(self._procs)

    def stop_all(self) -> None:
        for p in self._procs:
            if p.poll() is None:
                p.terminate()
        for p in self._procs:
            try:
                p.wait(timeout=10.0)
            except Exception:
                p.kill()
        self._procs = []


class AutoscalerController:
    """The reconcile loop: observe (cached `stats` polls) → decide (pure)
    → actuate (per-decision lever RPCs), once per `tick_s`.

    Clients speak the shared line-JSON RPC protocol (MasterClient works
    against both the router and the master). Either endpoint may be absent:
    no router disables the serving lever, no master disables the train
    lever — the controller degrades, it never blocks. Drills inject
    in-process client stand-ins through `router_client`/`master_client`
    (anything with .call/.close)."""

    def __init__(
        self,
        router_endpoints: Optional[EndpointsLike] = None,
        master_endpoints: Optional[EndpointsLike] = None,
        *,
        config: Optional[ScaleConfig] = None,
        spawner: Optional[Any] = None,
        tick_s: float = 1.0,
        client_kw: Optional[dict] = None,
        router_client: Optional[Any] = None,
        master_client: Optional[Any] = None,
        liveness_port: Optional[int] = None,
        liveness_host: str = "127.0.0.1",
    ):
        kw = client_kw or {"timeout": 5.0, "retries": 2}
        self.cfg = config or ScaleConfig()
        self.decider = ScaleDecider(self.cfg)
        self.spawner = spawner
        self.tick_s = float(tick_s)
        self._router = router_client or (
            MasterClient(router_endpoints, **kw)
            if router_endpoints is not None else None
        )
        self._master = master_client or (
            MasterClient(master_endpoints, **kw)
            if master_endpoints is not None else None
        )
        # cached snapshots: observation failures reuse the last good view
        # (and suppress actuation) — the controller NEVER blocks a decision
        # on a live round trip beyond the tick's one cold-path stats poll
        self._router_snap: Optional[Dict[str, Any]] = None
        self._master_snap: Optional[Dict[str, Any]] = None
        self._prev_shed: Optional[int] = None
        self._prev_miss: Optional[int] = None
        # (instance, epoch, deadline) of the resize this controller
        # announced and is watching for completion/timeout
        self._resize_inflight: Optional[Tuple[str, int, float]] = None
        self.ticks = 0
        self.observe_failures = 0
        self.actions: List[str] = []
        self.dead = False
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # incarnation identity: a standby that takes this
        # controller's place overwrites it with its election token
        self.instance = mint_instance_token()
        # liveness port: the controller has no RPC surface of
        # its own, so an AutoscalerStandby needs SOMETHING to probe. This
        # bare accept-and-close listener is held open exactly as long as
        # the reconcile loop is healthy — closed when the loop exits for
        # ANY reason, including the controller_kill chaos site — so a TCP
        # probe against it answers "is the primary controller alive".
        self.liveness_address: Optional[Tuple[str, int]] = None
        self._liveness_sock = None
        if liveness_port is not None:
            import socket

            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind((liveness_host, int(liveness_port)))
            s.listen(8)
            self._liveness_sock = s
            self.liveness_address = s.getsockname()
            threading.Thread(
                target=self._liveness_accept, name="autoscaler-liveness",
                daemon=True,
            ).start()

    def _liveness_accept(self) -> None:
        """Accept-and-close loop for the liveness port; exits when the
        socket is closed (loop death or stop())."""
        sock = self._liveness_sock  # _close_liveness nulls the attr
        while True:
            try:
                conn, _ = sock.accept()
                conn.close()
            except OSError:
                return

    def _close_liveness(self) -> None:
        import socket

        s, self._liveness_sock = self._liveness_sock, None
        if s is not None:
            try:
                # shutdown() first: close() alone does not wake a thread
                # blocked in accept() — the in-flight syscall pins the
                # socket open and the port would accept one more probe
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass

    # -- observation (cold path: one stats poll per endpoint per tick) ------
    def _observe(self, now: float) -> Optional[Signals]:
        stale = False
        if self._router is not None:
            try:
                # rpc-ok: once-per-tick cold-path poll of the router's
                # piggyback-fed stats — never on a dispatch/decode path
                self._router_snap = self._router.call("stats")
            except ConnectionError:
                self.observe_failures += 1
                stale = True
        if self._master is not None:
            try:
                # rpc-ok: once-per-tick cold-path poll of the master's
                # TTL'd fleet aggregate + resize-epoch info
                self._master_snap = self._master.call("stats")
            except ConnectionError:
                self.observe_failures += 1
                stale = True
        if stale or (self._router_snap is None and self._master_snap is None):
            # degrade to static fleet: observed state is stale, so no
            # action this tick — serving/training liveness is unaffected
            return None

        rs = self._router_snap or {}
        reps = rs.get("replicas", [])
        live = [r for r in reps if r.get("state") == "live"]
        draining = [r for r in reps if r.get("state") == "draining"]
        # fleet-wide shed/deadline-miss: the router's own fleet-wide sheds
        # plus every live replica's piggybacked counters (fleet.LOAD_KEYS)
        shed = int(rs.get("shed", 0) or 0) + sum(
            int(r.get("load", {}).get("shed", 0) or 0) for r in live
        )
        miss = sum(
            int(r.get("load", {}).get("deadline_misses", 0) or 0)
            for r in live
        )
        # replica churn makes the fleet sums non-monotonic (a drained
        # replica's counters leave the view): clamp deltas at zero
        shed_delta = max(0, shed - (self._prev_shed
                                    if self._prev_shed is not None else shed))
        miss_delta = max(0, miss - (self._prev_miss
                                    if self._prev_miss is not None else miss))
        self._prev_shed, self._prev_miss = shed, miss

        ms = self._master_snap or {}
        rz = ms.get("resize", {}) or {}
        return Signals(
            queue_wait_s=float(rs.get("estimated_queue_wait_s", 0.0) or 0.0),
            shed_delta=shed_delta,
            miss_delta=miss_delta,
            live_replicas=len(live),
            draining_replicas=len(draining),
            # the resize plane's world IS the current training world
            # (seeded via MasterServer(initial_world=)) — the stateless
            # reconcile source a restarted controller adopts
            train_world=int(rz.get("world", 0) or 0),
            resize_busy=rz.get("state", "idle") != "idle",
        )

    # -- actuation (per-DECISION lever calls, cooldown-rate-limited) --------
    def _drain_victim(self) -> Optional[str]:
        """Least-loaded LIVE replica from the cached snapshot — the one
        whose in-flight work is cheapest to let finish."""
        reps = [
            r for r in (self._router_snap or {}).get("replicas", [])
            if r.get("state") == "live"
        ]
        if not reps:
            return None
        reps.sort(key=lambda r: (
            int(r.get("outstanding", 0) or 0)
            + int(r.get("load", {}).get("queue_depth", 0) or 0),
            r.get("replica_id", ""),
        ))
        return reps[0]["replica_id"]

    def _actuate(self, actions: List[Action], now: float) -> None:
        for act in actions:
            with trace.span("autoscaler.actuate", decisions=1):
                if act.lever == "serving" and act.direction == "grow":
                    if self.spawner is not None:
                        self.spawner.spawn()
                        self.actions.append("spawn")
                elif act.lever == "serving" and act.direction == "shrink":
                    victim = self._drain_victim()
                    if victim is not None and self._router is not None:
                        try:
                            # rpc-ok: one drain order per admitted decision
                            self._router.call(
                                "drain", replica_id=victim,
                                deadline_s=self.cfg.drain_deadline_s,
                            )
                            self.actions.append(f"drain:{victim}")
                        except ConnectionError:
                            self.observe_failures += 1
                elif act.lever == "train" and self._master is not None:
                    world = int(act.payload["world"])
                    try:
                        # rpc-ok: one resize announce per admitted decision
                        resp = self._master.call("resize", world=world)
                    except ConnectionError:
                        self.observe_failures += 1
                        continue
                    if "err" in resp:
                        # epoch already in flight (or malformed order):
                        # back off instead of retrying hot
                        self.decider.note_resize_rejected(now)
                        obs_metrics.observe_scale_rejected("train")
                        self.actions.append("resize_rejected")
                    else:
                        self._resize_inflight = (
                            resp.get("instance", ""),
                            int(resp.get("epoch", 0)),
                            now + self.cfg.resize_timeout_s,
                        )
                        self.actions.append(f"resize:{world}")

    def _watch_resize(self, now: float) -> None:
        """Settle the resize this controller announced: a completed epoch
        resets the backoff; one stuck past resize_timeout_s counts as a
        rejection (backoff) and is abandoned to the master's own drain
        timeout — the controller never force-completes an epoch."""
        if self._resize_inflight is None:
            return
        instance, epoch, deadline = self._resize_inflight
        rz = (self._master_snap or {}).get("resize", {}) or {}
        same = (rz.get("instance") == instance
                and int(rz.get("epoch", -1) or -1) == epoch)
        if same and rz.get("state") == "idle":
            self.decider.note_resize_ok()
            self._resize_inflight = None
        elif rz.get("state") == "idle" and not same:
            # a failed-over master restarted the epoch counter: the epoch
            # we watched no longer exists — reconcile from scratch
            self._resize_inflight = None
        elif now > deadline:
            self.decider.note_resize_rejected(now)
            obs_metrics.observe_scale_rejected("train_timeout")
            self._resize_inflight = None

    # -- the tick -----------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> List[Action]:
        """One observe→decide→actuate pass. Public so drills and tests can
        drive the controller without its thread."""
        # seeded chaos sites: controller death (the loop thread exits and
        # the fleet degrades to static) and a wedged decision pass (which
        # must stall only THIS controller, never serving/training)
        faults.get().maybe_raise("controller_kill")
        faults.maybe_stall(
            "scale_decision_stall", env="PADDLE_TPU_SCALE_STALL_S",
            default_s=300.0,
        )
        if now is None:
            # clock-ok: the ONE wall-clock read per controller tick — every
            # cooldown/flap/backoff comparison inside decide() uses this
            # stamp
            now = time.monotonic()
        self.ticks += 1
        sig = self._observe(now)
        if sig is None:
            return []
        self._watch_resize(now)
        actions = self.decider.decide(sig, now)
        self._actuate(actions, now)
        if self.spawner is not None and hasattr(self.spawner, "reap"):
            self.spawner.reap()
        return actions

    def _loop(self) -> None:
        try:
            while not self._stop_evt.wait(self.tick_s):
                try:
                    self.tick()
                except faults.InjectedFault:
                    # the controller_kill drill: this controller is dead;
                    # the fleet it was steering keeps running statically
                    self.dead = True
                    core_stats.FT_EVENTS.incr("autoscaler_controller_killed")
                    log.warning("autoscaler controller killed (chaos "
                                "site); fleet degrades to static")
                    return
                except Exception:
                    # an unexpected tick failure must not take the loop
                    # down — the next tick re-observes from scratch
                    self.observe_failures += 1
                    log.exception("autoscaler tick failed; continuing")
        finally:
            # liveness port tracks the LOOP, not the process: any exit —
            # stop(), controller_kill, an escape we didn't foresee — drops
            # it so a watching standby sees the death
            self._close_liveness()

    def start(self) -> "AutoscalerController":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="autoscaler", daemon=True
            )
            self._thread.start()
        return self

    @property
    def alive(self) -> bool:
        return (self._thread is not None and self._thread.is_alive()
                and not self.dead)

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        self._close_liveness()
        for c in (self._router, self._master):
            if c is not None:
                try:
                    c.close()
                except Exception:
                    pass

    def stats(self) -> Dict[str, Any]:
        return {
            "ticks": self.ticks,
            "decisions": self.decider.decisions,
            "suppressed": dict(self.decider.suppressed),
            "resize_failures": self.decider.resize_failures,
            "observe_failures": self.observe_failures,
            "actions": list(self.actions),
            "alive": self.alive,
            "dead": self.dead,
            "instance": self.instance,
        }


class AutoscalerStandby:
    """Warm standby for the autoscaler, on the shared election
    primitive — and the degenerate, zero-extra-state consumer of it: the
    controller is ALREADY stateless-reconciling (desired state re-derived
    every tick from observed router/master stats; an in-flight resize epoch
    adopted from `stats()["resize"]`), so takeover is just "watch the
    primary's liveness port, then build a fresh controller". No sweep, no
    books, nothing to rebuild.

    `factory` is a zero-arg callable returning an UNSTARTED
    AutoscalerController — the standby cannot hold live clients/spawners
    for a controller that may never exist."""

    def __init__(self, primary: EndpointsLike,
                 factory: Callable[[], "AutoscalerController"],
                 poll_s: float = 0.2, confirm_failures: int = 2,
                 max_wait_s: Optional[float] = None,
                 stop_evt: Optional[threading.Event] = None):
        self.primary = primary
        self.factory = factory
        self.poll_s = float(poll_s)
        self.confirm_failures = int(confirm_failures)
        self.max_wait_s = max_wait_s
        self.stop_evt = stop_evt

    def run(self) -> Optional["AutoscalerController"]:
        """Block watching the primary's liveness port; on confirmed death
        return a STARTED controller whose `instance` is the election token.
        None when stopped or timed out with the primary still alive."""
        token = watch_primary(
            self.primary, plane="autoscaler", poll_s=self.poll_s,
            confirm_failures=self.confirm_failures,
            max_wait_s=self.max_wait_s, stop_evt=self.stop_evt,
        )
        if token is None:
            return None
        ctl = self.factory()
        ctl.instance = token
        log.warning("autoscaler standby (incarnation %s) taking over",
                    token)
        return ctl.start()


def _parse_endpoint(s: str) -> Tuple[str, int]:
    host, _, port = s.rpartition(":")
    return (host or "127.0.0.1", int(port))


def _main(argv: Optional[List[str]] = None) -> int:
    """`python -m paddle_tpu_torch.runtime.autoscaler serve` — the controller as
    its own (expendable) process. Killing it at any moment leaves the fleet
    static; restarting it reconciles from observed state."""
    import argparse
    import json
    import signal as _signal

    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.runtime.autoscaler",
        description="goodput-driven autoscaler controller",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    # the controller flags, shared by `serve` (the primary) and `standby`
    # (which builds an IDENTICAL controller if and when it takes over)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--router", default=None,
                        help="router host:port (serving spawn/drain lever)")
    common.add_argument("--master", default=None,
                        help="master host:port (training resize lever)")
    common.add_argument("--tick_s", type=float, default=1.0)
    common.add_argument("--chips", type=int, default=8,
                        help="total chip budget arbitrated across both "
                             "fleets")
    common.add_argument("--chips_per_replica", type=int, default=1)
    common.add_argument("--min_replicas", type=int, default=1)
    common.add_argument("--max_replicas", type=int, default=8)
    common.add_argument("--train_min_world", type=int, default=0)
    common.add_argument("--train_max_world", type=int, default=8)
    common.add_argument("--high_wait_s", type=float, default=0.5)
    common.add_argument("--low_wait_s", type=float, default=0.05)
    common.add_argument("--serving_cooldown_s", type=float, default=8.0)
    common.add_argument("--train_cooldown_s", type=float, default=10.0)
    common.add_argument("--flap_window_s", type=float, default=20.0)
    common.add_argument("--drain_deadline_s", type=float, default=30.0)
    common.add_argument("--spawn_arg", action="append", default=None,
                        help="repeatable: extra argv for spawned replicas "
                             "(default: --demo)")
    common.add_argument("--liveness_port", type=int, default=None,
                        help="bind a liveness port a standby can watch "
                             "(closed when the reconcile loop dies)")
    sv = sub.add_parser("serve", parents=[common],
                        help="run the reconcile loop")
    sb = sub.add_parser(
        "standby", parents=[common],
        help="watch a primary controller's liveness port; run an identical "
             "controller when it dies",
    )
    sb.add_argument("--primary", required=True,
                    help="primary controller's liveness host:port")
    sb.add_argument("--poll_s", type=float, default=0.2)
    sb.add_argument("--max_wait_s", type=float, default=None,
                    help="give up after this long with the primary healthy")
    args = ap.parse_args(argv)

    if args.router is None and args.master is None:
        ap.error("need --router and/or --master")
    router_ep = _parse_endpoint(args.router) if args.router else None
    cfg = ScaleConfig(
        chips_total=args.chips, chips_per_replica=args.chips_per_replica,
        min_replicas=args.min_replicas, max_replicas=args.max_replicas,
        train_min_world=args.train_min_world,
        train_max_world=args.train_max_world,
        high_wait_s=args.high_wait_s, low_wait_s=args.low_wait_s,
        serving_cooldown_s=args.serving_cooldown_s,
        train_cooldown_s=args.train_cooldown_s,
        flap_window_s=args.flap_window_s,
        drain_deadline_s=args.drain_deadline_s,
    )

    def _build() -> AutoscalerController:
        spawner = (
            ReplicaSpawner(
                router_ep,
                extra_args=(args.spawn_arg
                            if args.spawn_arg is not None else ["--demo"]),
            )
            if router_ep is not None else None
        )
        return AutoscalerController(
            router_endpoints=router_ep,
            master_endpoints=(
                _parse_endpoint(args.master) if args.master else None
            ),
            config=cfg, spawner=spawner, tick_s=args.tick_s,
            liveness_port=args.liveness_port,
        )

    if args.cmd == "standby":
        stop_evt = threading.Event()
        _signal.signal(_signal.SIGTERM, lambda *_: stop_evt.set())
        _signal.signal(_signal.SIGINT, lambda *_: stop_evt.set())
        ctl = AutoscalerStandby(
            args.primary, _build, poll_s=args.poll_s,
            max_wait_s=args.max_wait_s, stop_evt=stop_evt,
        ).run()
        if ctl is None:
            print(json.dumps({"role": "autoscaler_standby",
                              "takeover": False}), flush=True)
            return 3
        print(json.dumps({"role": "autoscaler_standby", "takeover": True,
                          "instance": ctl.instance}), flush=True)
    else:
        ctl = _build().start()
    _signal.signal(_signal.SIGTERM, lambda *_: ctl.stop())
    _signal.signal(_signal.SIGINT, lambda *_: ctl.stop())
    if args.cmd == "serve":
        print(json.dumps({
            "role": "autoscaler", "tick_s": args.tick_s,
            "liveness": (list(ctl.liveness_address)
                         if ctl.liveness_address else None),
        }), flush=True)
    while ctl._thread is not None and ctl._thread.is_alive():
        time.sleep(0.05)
    if ctl.spawner is not None:
        ctl.spawner.stop_all()
    print(json.dumps({"role": "autoscaler", "final": ctl.stats()}),
          flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(_main())
