"""The port's autoscaler (`paddle_tpu_torch/runtime/autoscaler.py`), held to
the JAX package's: the twins of tests/test_autoscaler.py (all but the
nightly fleet drill) and of the autoscaler standby tests of
tests/test_ha.py, a parity test of the pure decision engine, and the
router's `serve --autoscale` flags.

  * `ScaleDecider` — hysteresis streaks, per-lever cooldowns, the flap
    window, backoff after a rejected resize, the startup quiet period and
    the chip ledger, pinned with a fake clock; one synthetic signal stream
    through both packages' deciders gives the same actions at the same
    ticks;
  * `AutoscalerController.tick(now=...)` against in-process client
    stand-ins: spawn under pressure, drain the least-loaded replica, announce
    and settle a resize, back off a rejected or timed-out one, degrade to
    static on stale observations, reconcile after a restart, and the
    `controller_kill` site;
  * `AutoscalerStandby` takes over when the controller's liveness port
    drops; the controller CLI and the router's `--autoscale` start and stop
    clean."""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from paddle_tpu_torch.core import faults
from paddle_tpu_torch.runtime.autoscaler import (
    Action,
    AutoscalerController,
    ScaleConfig,
    ScaleDecider,
    Signals,
)

pytestmark = [pytest.mark.autoscale]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cfg(**kw):
    base = dict(
        chips_total=4, chips_per_replica=1,
        min_replicas=1, max_replicas=3,
        train_min_world=1, train_max_world=2,
        high_wait_s=1.0, low_wait_s=0.1,
        high_ticks=2, low_ticks=3,
        serving_cooldown_s=10.0, train_cooldown_s=10.0,
        flap_window_s=30.0, startup_quiet_s=0.0,
        backoff_base_s=5.0, backoff_max_s=40.0,
        resize_timeout_s=60.0, drain_deadline_s=30.0,
    )
    base.update(kw)
    return ScaleConfig(**base)


def sig(**kw):
    base = dict(queue_wait_s=0.5, live_replicas=1, train_world=1)
    base.update(kw)
    return Signals(**base)


HIGH = dict(queue_wait_s=5.0)
LOW = dict(queue_wait_s=0.01)


# ---------------------------------------------------------------------------
# hysteresis
# ---------------------------------------------------------------------------

def test_high_pressure_needs_a_streak_not_a_spike():
    d = ScaleDecider(cfg(high_ticks=3))
    assert d.decide(sig(**HIGH), 1.0) == []
    assert d.decide(sig(**HIGH), 2.0) == []
    acts = d.decide(sig(**HIGH), 3.0)
    assert len(acts) == 1 and acts[0].lever == "serving"
    assert acts[0].direction == "grow"


def test_low_pressure_needs_a_streak_not_a_dip():
    d = ScaleDecider(cfg(low_ticks=3))
    assert d.decide(sig(live_replicas=2, **LOW), 1.0) == []
    assert d.decide(sig(live_replicas=2, **LOW), 2.0) == []
    acts = d.decide(sig(live_replicas=2, **LOW), 3.0)
    assert len(acts) == 1 and acts[0].lever == "serving"
    assert acts[0].direction == "shrink"


def test_band_between_thresholds_resets_both_streaks():
    d = ScaleDecider(cfg(high_ticks=2, low_ticks=2))
    d.decide(sig(**HIGH), 1.0)
    # mid-band tick: neither high nor low — the streak must restart
    d.decide(sig(queue_wait_s=0.5), 2.0)
    assert d.decide(sig(**HIGH), 3.0) == []
    assert d.decide(sig(**HIGH), 4.0) != []


def test_shed_and_miss_deltas_count_as_pressure():
    for kw in ({"shed_delta": 1}, {"miss_delta": 1}):
        d = ScaleDecider(cfg(high_ticks=2))
        assert d.decide(sig(queue_wait_s=0.0, **kw), 1.0) == []
        acts = d.decide(sig(queue_wait_s=0.0, **kw), 2.0)
        assert acts and acts[0].direction == "grow"
        # ...and a shed tick also disqualifies "low" even at zero wait
        d2 = ScaleDecider(cfg(low_ticks=1))
        assert d2.decide(sig(live_replicas=2, queue_wait_s=0.0, **kw),
                         1.0) == []


# ---------------------------------------------------------------------------
# the chip ledger
# ---------------------------------------------------------------------------

def test_no_free_chips_reclaims_from_training_first():
    # 4 chips: 2 serving + 2 training -> a grow must shrink the world first
    d = ScaleDecider(cfg())
    s = sig(live_replicas=2, train_world=2, **HIGH)
    d.decide(s, 1.0)
    acts = d.decide(s, 2.0)
    assert len(acts) == 1 and acts[0].lever == "train"
    assert acts[0].direction == "shrink"
    assert acts[0].payload["world"] == 1


def test_training_at_floor_cannot_be_reclaimed():
    # serving at max AND training at min: pressure has nowhere to go
    d = ScaleDecider(cfg())
    s = sig(live_replicas=3, train_world=1, **HIGH)
    d.decide(s, 1.0)
    assert d.decide(s, 2.0) == []


def test_draining_replica_still_holds_its_chip():
    # 2 live + 1 draining + world 1 = 4 chips: no room to spawn, so the
    # decider reclaims from training instead of over-committing
    d = ScaleDecider(cfg(train_max_world=3))
    s = sig(live_replicas=2, draining_replicas=1, train_world=1, **HIGH)
    d.decide(s, 1.0)
    assert d.decide(s, 2.0) == []  # world already at train_min_world


def test_idle_drains_before_lending_and_one_drain_at_a_time():
    d = ScaleDecider(cfg(low_ticks=1))
    acts = d.decide(sig(live_replicas=3, **LOW), 1.0)
    assert acts and acts[0].lever == "serving" and acts[0].direction == "shrink"
    # with the drain still in flight, no second drain is stacked on top
    assert d.decide(sig(live_replicas=2, draining_replicas=1, **LOW),
                    100.0) == []


def test_idle_at_min_fleet_lends_free_chips_to_training():
    d = ScaleDecider(cfg(low_ticks=1))
    acts = d.decide(sig(live_replicas=1, train_world=1, **LOW), 1.0)
    assert len(acts) == 1 and acts[0].lever == "train"
    assert acts[0].direction == "grow" and acts[0].payload["world"] == 2


def test_resize_busy_blocks_the_train_lever_both_ways():
    d = ScaleDecider(cfg(low_ticks=1))
    assert d.decide(sig(live_replicas=1, train_world=1, resize_busy=True,
                        **LOW), 1.0) == []
    d2 = ScaleDecider(cfg())
    s = sig(live_replicas=2, train_world=2, resize_busy=True, **HIGH)
    d2.decide(s, 1.0)
    assert d2.decide(s, 2.0) == []


# ---------------------------------------------------------------------------
# cooldowns, flap suppression, startup quiet
# ---------------------------------------------------------------------------

def test_cooldown_spaces_actions_on_the_same_lever():
    d = ScaleDecider(cfg(high_ticks=1, serving_cooldown_s=10.0))
    assert d.decide(sig(**HIGH), 1.0) != []
    # pressure persists, but the lever is cooling down
    assert d.decide(sig(**HIGH), 5.0) == []
    assert d.suppressed.get("cooldown", 0) >= 1
    # ...until the cooldown elapses
    assert d.decide(sig(**HIGH), 12.0) != []


def test_startup_quiet_period_suppresses_first_action():
    d = ScaleDecider(cfg(high_ticks=1, startup_quiet_s=5.0))
    assert d.decide(sig(**HIGH), 1.0) == []
    assert d.suppressed.get("startup", 0) == 1
    assert d.decide(sig(**HIGH), 7.0) != []


def test_square_wave_load_cannot_thrash_the_train_lever():
    """A square wave faster than the cooldown yields AT MOST one train
    action per cooldown window — the flap suppressor plus cooldown turn an
    oscillating signal into a slow, damped response."""
    c = cfg(high_ticks=1, low_ticks=1, train_cooldown_s=10.0,
            flap_window_s=10.0, serving_cooldown_s=10.0,
            max_replicas=1)  # serving pinned: every action is train-lever
    d = ScaleDecider(c)
    stamps = []
    world = 1
    t = 0.0
    for cycle in range(40):  # 2s period square wave for 80s
        for s in (sig(live_replicas=1, train_world=world, **HIGH),
                  sig(live_replicas=1, train_world=world, **LOW)):
            t += 1.0
            for a in d.decide(s, t):
                assert a.lever == "train"
                stamps.append(t)
                world = a.payload["world"]
    assert stamps, "square wave never produced a single action?"
    for a, b in zip(stamps, stamps[1:]):
        assert b - a >= c.train_cooldown_s, (
            f"two train actions {b - a:.1f}s apart beats the "
            f"{c.train_cooldown_s}s cooldown: {stamps}"
        )
    assert d.suppressed.get("cooldown", 0) + d.suppressed.get("flap", 0) > 0


def test_flap_window_blocks_direction_reversal_after_cooldown():
    # cooldown shorter than the flap window: a same-direction action is
    # admitted after the cooldown, but a REVERSAL still waits the window out
    c = cfg(high_ticks=1, low_ticks=1, serving_cooldown_s=2.0,
            flap_window_s=20.0)
    d = ScaleDecider(c)
    assert d.decide(sig(live_replicas=1, **HIGH), 1.0) != []   # grow
    acts = d.decide(sig(live_replicas=2, **LOW), 5.0)          # reversal
    assert acts == [] and d.suppressed.get("flap", 0) == 1
    assert d.decide(sig(live_replicas=2, **LOW), 22.0) != []   # window over


# ---------------------------------------------------------------------------
# resize backoff
# ---------------------------------------------------------------------------

def test_backoff_after_rejected_resize_is_exponential_and_resets():
    d = ScaleDecider(cfg(low_ticks=1, backoff_base_s=5.0, backoff_max_s=40.0))
    grow = sig(live_replicas=1, train_world=1, **LOW)
    assert d.decide(grow, 1.0) != []
    h1 = d.note_resize_rejected(1.0)
    assert h1 == pytest.approx(6.0)  # 1.0 + base
    # inside the horizon the train lever is suppressed outright
    assert d.decide(grow, 4.0) == []
    assert d.suppressed.get("backoff", 0) == 1
    # second rejection doubles the delay...
    h2 = d.note_resize_rejected(10.0)
    assert h2 == pytest.approx(20.0)
    # ...and the cap holds no matter how many failures pile up
    for i in range(10):
        d.note_resize_rejected(100.0)
    assert d.resize_failures == 12
    assert d.note_resize_rejected(100.0) <= 100.0 + 40.0
    # a completed epoch clears everything
    d.note_resize_ok()
    assert d.resize_failures == 0
    assert d.decide(grow, 200.0) != []


def test_backoff_does_not_gate_the_serving_lever():
    d = ScaleDecider(cfg(high_ticks=1))
    d.note_resize_rejected(0.0)
    assert d.decide(sig(**HIGH), 1.0) != []  # spawn is still allowed


# ---------------------------------------------------------------------------
# controller: observe -> decide -> actuate against fake clients
# ---------------------------------------------------------------------------

class FakeClient:
    """In-process stand-in for the line-JSON RPC client: canned per-method
    responses, a call journal, optional injected ConnectionError."""

    def __init__(self, responses):
        self.responses = responses
        self.calls = []
        self.fail = False

    def call(self, method, **kw):
        if self.fail:
            raise ConnectionError("injected")
        self.calls.append((method, kw))
        resp = self.responses[method]
        return resp(kw) if callable(resp) else resp

    def close(self):
        pass


class FakeSpawner:
    def __init__(self):
        self.spawned = 0

    def spawn(self):
        self.spawned += 1

    def reap(self):
        return 0

    def stop_all(self):
        pass


def replica(rid, state="live", **load):
    ld = {"queue_depth": 0, "shed": 0, "deadline_misses": 0}
    ld.update(load)
    return {"replica_id": rid, "state": state, "outstanding": 0, "load": ld}


def router_stats(wait, replicas, shed=0):
    return {"estimated_queue_wait_s": wait, "shed": shed,
            "replicas": replicas}


def master_stats(world, state="idle", instance="m0", epoch=0):
    return {"resize": {"world": world, "state": state,
                       "instance": instance, "epoch": epoch}}


def make_controller(router_resp, master_resp, c=None, spawner=None):
    return AutoscalerController(
        config=c or cfg(),
        spawner=spawner,
        router_client=FakeClient(router_resp),
        master_client=FakeClient(master_resp),
    )


def test_controller_spawns_under_pressure_and_reaps():
    sp = FakeSpawner()
    ctl = make_controller(
        {"stats": router_stats(5.0, [replica("r0")])},
        {"stats": master_stats(1)},
        c=cfg(high_ticks=2), spawner=sp,
    )
    assert ctl.tick(now=1.0) == []
    acts = ctl.tick(now=2.0)
    assert [a.direction for a in acts] == ["grow"]
    assert sp.spawned == 1 and ctl.actions == ["spawn"]


def test_controller_drains_least_loaded_replica_when_idle():
    router = FakeClient({
        "stats": router_stats(0.0, [
            replica("r-busy", queue_depth=7),
            replica("r-idle", queue_depth=0),
        ]),
        "drain": {"ok": True},
    })
    ctl = AutoscalerController(
        config=cfg(low_ticks=2), router_client=router,
        master_client=FakeClient({"stats": master_stats(1)}),
    )
    ctl.tick(now=1.0)
    ctl.tick(now=2.0)
    drains = [kw for m, kw in router.calls if m == "drain"]
    assert len(drains) == 1 and drains[0]["replica_id"] == "r-idle"
    assert ctl.actions == ["drain:r-idle"]


def test_controller_announces_resize_and_settles_it():
    state = {"world": 1, "state": "idle", "instance": "m0", "epoch": 0}

    def on_resize(kw):
        state.update(world=kw["world"], state="draining", epoch=1)
        return {"instance": "m0", "epoch": 1, "world": kw["world"]}

    master = FakeClient({"stats": lambda kw: {"resize": dict(state)},
                         "resize": on_resize})
    ctl = AutoscalerController(
        config=cfg(low_ticks=2),
        router_client=FakeClient(
            {"stats": router_stats(0.0, [replica("r0")])}),
        master_client=master,
    )
    ctl.tick(now=1.0)
    acts = ctl.tick(now=2.0)  # low streak -> train grow 1 -> 2
    assert [a.lever for a in acts] == ["train"]
    assert ctl.actions == ["resize:2"]
    assert ctl._resize_inflight is not None
    # while the epoch is in flight, resize_busy blocks further train pulls
    assert ctl.tick(now=30.0) == []
    # the epoch completes: the next tick's watch settles it
    state.update(state="idle")
    ctl.tick(now=31.0)
    assert ctl._resize_inflight is None
    assert ctl.decider.resize_failures == 0


def test_controller_rejected_resize_backs_off():
    master = FakeClient({"stats": master_stats(1),
                         "resize": {"err": "epoch 3 still draining"}})
    ctl = AutoscalerController(
        config=cfg(low_ticks=1, backoff_base_s=50.0),
        router_client=FakeClient(
            {"stats": router_stats(0.0, [replica("r0")])}),
        master_client=master,
    )
    ctl.tick(now=1.0)
    assert ctl.actions == ["resize_rejected"]
    assert ctl.decider.resize_failures == 1
    # pressure persists but the train lever is in backoff
    ctl.tick(now=20.0)
    assert ctl.actions == ["resize_rejected"]  # no second announce
    assert ctl.decider.suppressed.get("backoff", 0) >= 1


def test_controller_resize_timeout_counts_as_rejection():
    state = {"world": 1, "state": "idle", "instance": "m0", "epoch": 0}

    def on_resize(kw):
        state.update(state="draining", epoch=1)  # wedges there forever
        return {"instance": "m0", "epoch": 1, "world": kw["world"]}

    ctl = AutoscalerController(
        config=cfg(low_ticks=1, resize_timeout_s=10.0),
        router_client=FakeClient(
            {"stats": router_stats(0.0, [replica("r0")])}),
        master_client=FakeClient(
            {"stats": lambda kw: {"resize": dict(state)},
             "resize": on_resize}),
    )
    ctl.tick(now=1.0)
    assert ctl.actions == ["resize:2"]
    ctl.tick(now=20.0)  # past the 10s resize timeout
    assert ctl._resize_inflight is None
    assert ctl.decider.resize_failures == 1


def test_controller_stale_observation_degrades_to_static():
    sp = FakeSpawner()
    router = FakeClient({"stats": router_stats(5.0, [replica("r0")])})
    ctl = AutoscalerController(
        config=cfg(high_ticks=1), spawner=sp, router_client=router,
        master_client=FakeClient({"stats": master_stats(1)}),
    )
    router.fail = True
    for t in (1.0, 2.0, 3.0):
        assert ctl.tick(now=t) == []
    assert sp.spawned == 0 and ctl.observe_failures == 3
    # the endpoint heals: the very next tick observes and acts again
    router.fail = False
    assert ctl.tick(now=4.0) != []
    assert sp.spawned == 1


def test_restarted_controller_reconciles_from_observed_state():
    """Crash -> restart re-derives desired state: a FRESH controller given
    only the fleet's observable stats adopts the in-flight world/fleet and
    continues — no journal, no handoff from its predecessor."""
    responses = (
        {"stats": router_stats(5.0, [replica("r0"), replica("r1")])},
        {"stats": master_stats(2),
         "resize": {"instance": "m0", "epoch": 1, "world": 1}},
    )
    c = cfg(high_ticks=2, startup_quiet_s=0.0)
    ctl1 = make_controller(*responses, c=c, spawner=FakeSpawner())
    ctl1.tick(now=1.0)
    # ctl1 dies here.  ctl2 starts cold, sees 2 live + world 2 = 4 chips
    # (no free chips), and correctly reclaims from training rather than
    # spawning a 5th chip that the budget does not have.
    ctl2 = make_controller(*responses, c=cfg(high_ticks=2),
                           spawner=FakeSpawner())
    ctl2.tick(now=10.0)
    acts = ctl2.tick(now=11.0)
    assert [(a.lever, a.direction) for a in acts] == [("train", "shrink")]
    assert acts[0].payload["world"] == 1


def test_controller_kill_site_fires_and_loop_degrades():
    ctl = make_controller(
        {"stats": router_stats(0.0, [replica("r0")])},
        {"stats": master_stats(1)},
    )
    with faults.inject("controller_kill:step=0"):
        with pytest.raises(faults.InjectedFault):
            ctl.tick(now=1.0)
    # through the loop thread the same fault marks the controller dead
    # (fleet degrades to static) instead of propagating
    ctl2 = make_controller(
        {"stats": router_stats(0.0, [replica("r0")])},
        {"stats": master_stats(1)},
    )
    ctl2.tick_s = 0.01
    with faults.inject("controller_kill:step=0"):
        ctl2.start()
        deadline = time.time() + 5.0
        while not ctl2.dead and time.time() < deadline:
            time.sleep(0.01)
    assert ctl2.dead and not ctl2.alive
    ctl2.stop()


def test_decider_emits_at_most_one_action_per_tick():
    d = ScaleDecider(cfg(high_ticks=1, low_ticks=1))
    for t in range(1, 50):
        s = sig(live_replicas=(t % 3) + 1, train_world=1,
                queue_wait_s=(5.0 if t % 2 else 0.01))
        assert len(d.decide(s, float(t))) <= 1



# ---------------------------------------------------------------------------
# parity: one synthetic signal stream through both packages' deciders
# ---------------------------------------------------------------------------

def _stream(seed, n=160):
    """Signals with runs of pressure and idleness, replica churn, resize
    epochs in flight, and a rejected resize now and then."""
    import numpy as np

    rs = np.random.RandomState(seed)
    wait, live, draining, world, busy = 0.01, 1, 0, 1, False
    out = []
    for t in range(n):
        if rs.rand() < 0.15:
            wait = float(rs.choice([0.01, 0.3, 0.7, 5.0]))
        if rs.rand() < 0.1:
            live = int(rs.randint(1, 4))
        draining = int(rs.rand() < 0.1)
        if rs.rand() < 0.1:
            world = int(rs.randint(0, 3))
        busy = bool(rs.rand() < 0.15) if rs.rand() < 0.3 else busy
        out.append((dict(queue_wait_s=wait, shed_delta=int(rs.rand() < 0.05),
                         miss_delta=int(rs.rand() < 0.05), live_replicas=live,
                         draining_replicas=draining, train_world=world,
                         resize_busy=busy),
                    bool(rs.rand() < 0.05), bool(rs.rand() < 0.03)))
    return out


@pytest.mark.parametrize("seed,overrides", [
    (0, {}),
    (1, dict(high_ticks=1, low_ticks=1, flap_window_s=5.0)),
    (2, dict(serving_cooldown_s=2.0, train_cooldown_s=3.0, startup_quiet_s=4.0)),
    (3, dict(chips_total=8, max_replicas=6, train_max_world=4, backoff_base_s=2.0)),
])
def test_decider_matches_the_jax_package_tick_for_tick(seed, overrides):
    from paddle_tpu.runtime import autoscaler as jax_autoscaler

    base = dict(
        chips_total=4, chips_per_replica=1, min_replicas=1, max_replicas=3,
        train_min_world=0, train_max_world=2, high_wait_s=0.5, low_wait_s=0.05,
        high_ticks=2, low_ticks=3, serving_cooldown_s=6.0, train_cooldown_s=8.0,
        flap_window_s=15.0, startup_quiet_s=1.0, backoff_base_s=5.0,
        backoff_max_s=40.0)
    base.update(overrides)
    logs = []
    for mod in (sys.modules[ScaleDecider.__module__], jax_autoscaler):
        d = mod.ScaleDecider(mod.ScaleConfig(**base))
        log = []
        for t, (s, rejected, ok) in enumerate(_stream(seed)):
            now = 0.5 * t
            for a in d.decide(mod.Signals(**s), now):
                log.append((t, a.lever, a.direction, dict(a.payload)))
            if rejected:
                log.append((t, "backoff_until", d.note_resize_rejected(now)))
            if ok:
                d.note_resize_ok()
        logs.append((log, dict(d.suppressed), d.decisions, d.resize_failures))
    assert logs[0][0], "the stream admitted no action at all"
    assert logs[0] == logs[1]


# ---------------------------------------------------------------------------
# the controller's warm standby (tests/test_ha.py's autoscaler part)
# ---------------------------------------------------------------------------

class _StubStats:
    """Minimal .call/.close endpoint stand-in for controller observation."""

    def call(self, method, **kw):
        return {"replicas": [], "estimated_queue_wait_s": 0.0, "shed": 0}

    def close(self):
        pass


def _wait(cond, timeout_s):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


@pytest.mark.timeout(60)
def test_autoscaler_standby_takes_over_on_controller_kill():
    import threading

    from paddle_tpu_torch.core.stats import FT_EVENTS
    from paddle_tpu_torch.runtime.autoscaler import AutoscalerStandby

    before = FT_EVENTS.get("autoscaler_takeover")
    with faults.inject("controller_kill:step=3"):
        ctl = AutoscalerController(router_client=_StubStats(), tick_s=0.05,
                                   liveness_port=0).start()
        assert ctl.liveness_address is not None
        box = {}
        standby = AutoscalerStandby(
            ctl.liveness_address,
            lambda: AutoscalerController(router_client=_StubStats(), tick_s=0.05),
            poll_s=0.05)
        t = threading.Thread(target=lambda: box.update(ctl=standby.run()), daemon=True)
        t.start()
        time.sleep(0.2)
        assert t.is_alive(), "the standby must not usurp a live controller"
        assert _wait(lambda: ctl.dead, 15.0)
        t.join(timeout=20.0)
        assert not t.is_alive() and box.get("ctl") is not None
    new = box["ctl"]
    try:
        assert new.alive and len(new.instance) == 8
        assert new.instance != ctl.instance
        assert FT_EVENTS.get("autoscaler_takeover") == before + 1
        assert _wait(lambda: new.ticks >= 2, 15.0)
    finally:
        new.stop()
        ctl.stop()


@pytest.mark.timeout(60)
def test_autoscaler_stop_drops_liveness_port():
    import socket

    ctl = AutoscalerController(router_client=_StubStats(), tick_s=0.05,
                               liveness_port=0).start()
    addr = ctl.liveness_address
    socket.create_connection(addr, timeout=2.0).close()
    ctl.stop()
    with pytest.raises(OSError):
        socket.create_connection(addr, timeout=2.0).close()


# ---------------------------------------------------------------------------
# the controller and the router's --autoscale as processes
# ---------------------------------------------------------------------------

@pytest.mark.timeout(120)
def test_cli_serve_starts_and_stops_clean():
    from paddle_tpu_torch.serving.router import RouterServer

    router = RouterServer(lease_s=1.0, poll_interval_s=0.05).start()
    try:
        host, port = router.address
        env = dict(os.environ, PYTHONPATH=REPO)
        proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.runtime.autoscaler",
             "serve", "--router", f"{host}:{port}", "--tick_s", "0.05"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env)
        try:
            assert json.loads(proc.stdout.readline())["role"] == "autoscaler"
            time.sleep(1.0)
            proc.send_signal(signal.SIGTERM)
            out, _ = proc.communicate(timeout=30)
            final = json.loads(out.strip().splitlines()[-1])
            assert final["final"]["ticks"] >= 1 and final["final"]["dead"] is False
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
    finally:
        router.stop()
