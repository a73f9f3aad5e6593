"""The master side of elastic resize in the port (`_ResizeEpoch`,
`ResizeClient`, `cluster_reader`'s drain, `_Membership`'s roles), the twins
of the master-side half of tests/test_resize.py, plus what the port's
mesh-less trainer does with a resize epoch (ROADMAP §3 fault 21: it takes
the request and ignores it, as the JAX package's trainer without a mesh
does, and trains on).

  * the epoch state machine: announce → a drain barrier piggybacked on
    heartbeats → go → idle; eviction and the drain / go timeouts recompute
    the barrier; membership-triggered epochs count trainer leases only and
    re-announce parked churn;
  * `ResizeClient`: the heartbeat watcher parks the order keyed on (master
    instance, epoch), and its barrier returns the decided world (or the
    announced one, alone, when the master is gone);
  * a registered `cluster_reader` acks between tasks; task accounting stays
    exactly once across the epoch;
  * a mesh-less port trainer pulling tasks through `cluster_reader` trains
    through an epoch with every record consumed once, and its costs are
    those of a run without one."""

import threading
import time

import numpy as np
import pytest

from paddle_tpu_torch.core import faults, preempt, stats

pytestmark = [pytest.mark.chaos]


@pytest.fixture(autouse=True)
def _fresh():
    preempt.reset()
    stats.FT_EVENTS.reset()
    yield
    preempt.reset()


@pytest.mark.timeout(60)
def test_epoch_barrier_all_members_ack():
    from paddle_tpu_torch.runtime.master import MasterClient, MasterServer, TaskMaster

    srv = MasterServer(TaskMaster(), lease_s=5.0).start()
    try:
        c = MasterClient(srv.address)
        t1 = c.call("register")["trainer_id"]
        t2 = c.call("register")["trainer_id"]
        # malformed orders get an err REPLY on a surviving connection, not
        # a severed handler
        assert "err" in c.call("resize")
        assert "err" in c.call("resize", world="many")
        assert "err" in c.call("resize", world=0)
        ann = c.call("resize", world=4)
        assert ann["state"] == "draining" and ann["barrier"] == 2
        # a second announce while one is active is rejected with a reason
        assert "err" in c.call("resize", world=8)
        # a garbled epoch in the barrier RPCs replies status-only
        assert c.call("resize_drained", trainer_id=t1, epoch="x")["drained"] == 0
        # heartbeat piggybacks the drain signal, stamped with the resize
        # plane's instance token (epoch identity = instance + number)
        hb = c.call("heartbeat", trainer_id=t1)
        assert hb["resize"]["instance"]
        assert {
            k: hb["resize"][k] for k in ("state", "epoch", "world")
        } == {"state": "draining", "epoch": 1, "world": 4}
        mid = c.call("resize_drained", trainer_id=t1, epoch=1)
        assert mid["state"] == "draining" and mid["drained"] == 1
        go = c.call("resize_drained", trainer_id=t2, epoch=1)
        assert go["state"] == "go"
        # status polls double as resumed acks; epoch closes after both
        c.call("resize_status", trainer_id=t1, epoch=1)
        end = c.call("resize_status", trainer_id=t2, epoch=1)
        assert end["state"] == "idle" and end["completed"] == 1
        assert end["last"]["world"] == 4 and end["last"]["drain_s"] >= 0
        # idle → no piggyback
        assert "resize" not in c.call("heartbeat", trainer_id=t1)
        st = c.call("stats")
        assert st["resize"]["completed"] == 1
        c.close()
    finally:
        srv.stop()


@pytest.mark.timeout(60)
def test_epoch_completes_when_member_dies_in_barrier():
    """Lease eviction recomputes the drain barrier: a member killed mid-drain
    (no heartbeats) cannot wedge the epoch."""
    from paddle_tpu_torch.runtime.master import MasterClient, MasterServer, TaskMaster

    srv = MasterServer(TaskMaster(), lease_s=0.6).start()
    try:
        c = MasterClient(srv.address)
        t1 = c.call("register")["trainer_id"]
        c.call("register")  # t2 registers then dies silently
        c.call("resize", world=2)
        info = c.call("resize_drained", trainer_id=t1, epoch=1)
        assert info["state"] == "draining"  # waiting on the dead member
        deadline = time.time() + 20
        while time.time() < deadline and info["state"] == "draining":
            time.sleep(0.1)
            info = c.call("resize_status", trainer_id=t1, epoch=1)
        assert info["state"] == "idle", info
        assert info["last"]["evicted_during"] >= 1
        assert stats.FT_EVENTS.get("resize_barrier_evicted") >= 1
        c.close()
    finally:
        srv.stop()


@pytest.mark.timeout(60)
def test_epoch_times_out_wedged_but_heartbeating_member():
    """A wedged member whose heartbeat thread is still alive holds its lease
    forever — the drain-barrier TIMEOUT is the liveness guard that drops it
    from the barrier so survivors proceed."""
    from paddle_tpu_torch.runtime.master import MasterClient, MasterServer, TaskMaster

    srv = MasterServer(
        TaskMaster(), lease_s=5.0, resize_drain_timeout_s=0.8
    ).start()
    try:
        c = MasterClient(srv.address)
        t1 = c.call("register")["trainer_id"]
        t2 = c.call("register")["trainer_id"]
        c.call("resize", world=2)
        info = c.call("resize_drained", trainer_id=t1, epoch=1)
        assert info["state"] == "draining"
        deadline = time.time() + 20
        while time.time() < deadline and info["state"] == "draining":
            # t2 keeps heart-beating (wedged, not dead) yet never acks
            c.call("heartbeat", trainer_id=t2)
            time.sleep(0.1)
            info = c.call("resize_status", trainer_id=t1, epoch=1)
        assert info["state"] == "idle", info
        assert info["last"]["timed_out"] == 1
        # the woken straggler adopts the decided world from the idle epoch
        late = c.call("resize_drained", trainer_id=t2, epoch=1)
        assert late["state"] == "idle" and late["world"] == 2
        c.close()
    finally:
        srv.stop()


@pytest.mark.timeout(90)
def test_cluster_reader_drains_between_tasks(tmp_path):
    """A registered cluster_reader is a drain-barrier member: it acks between
    task acks (holding no lease on any task) and resumes pulling afterwards —
    task accounting stays exactly-once across the epoch."""
    from paddle_tpu_torch.runtime import recordio
    from paddle_tpu_torch.runtime.master import (
        MasterClient, MasterServer, TaskMaster, cluster_reader,
    )

    shards = recordio.convert(
        str(tmp_path / "ds"), lambda: ({"sid": i} for i in range(24)),
        records_per_file=2,
    )
    srv = MasterServer(TaskMaster(timeout_s=30.0), lease_s=0.45).start()
    try:
        boot = MasterClient(srv.address)
        boot.call("set_dataset", shards=shards, chunks_per_task=1)
        got = []

        def consume():
            for s in cluster_reader(srv.address, poll_interval=0.05)():
                got.append(s["sid"])
                time.sleep(0.05)

        th = threading.Thread(target=consume, daemon=True)
        th.start()
        deadline = time.time() + 20
        while time.time() < deadline:
            if boot.call("stats").get("live_leases", 0) >= 1:
                break
            time.sleep(0.05)
        ann = boot.call("resize", world=2)
        assert ann["state"] == "draining"
        th.join(timeout=60)
        assert not th.is_alive()
        st = boot.call("stats")
        assert st["done"] == 12 and st["discarded"] == 0  # exactly-once
        assert sorted(got) == list(range(24))
        assert st["resize"]["completed"] == 1
        assert stats.FT_EVENTS.get("reader_resize_drain") == 1
        boot.close()
    finally:
        srv.stop()


@pytest.mark.timeout(60)
def test_resize_with_no_trainers_completes_immediately():
    """An announce with an empty live set must complete instantly, not wedge
    `draining` (and reject later resizes) until the drain timeout."""
    from paddle_tpu_torch.runtime.master import MasterClient, MasterServer, TaskMaster

    srv = MasterServer(TaskMaster(), lease_s=5.0).start()
    try:
        c = MasterClient(srv.address)
        info = c.call("resize", world=4)
        assert info["state"] == "idle" and info["completed"] == 1, info
        # the control plane is immediately free for the next epoch
        assert c.call("resize", world=2)["state"] == "idle"
        c.close()
    finally:
        srv.stop()


@pytest.mark.timeout(60)
def test_resize_on_membership_announces_on_join():
    from paddle_tpu_torch.runtime.master import MasterClient, MasterServer, TaskMaster

    srv = MasterServer(
        TaskMaster(), lease_s=5.0, resize_on_membership=True
    ).start()
    try:
        c = MasterClient(srv.address)
        c.call("register")  # first join: nothing to re-shape yet
        assert c.call("stats")["resize"]["state"] == "idle"
        c.call("register")  # second join announces world=2
        info = c.call("stats")["resize"]
        assert info["state"] == "draining" and info["world"] == 2
        c.close()
    finally:
        srv.stop()


def test_observe_resize_lands_in_snapshot():
    from paddle_tpu_torch.obs import metrics as obs_metrics

    before = obs_metrics.snapshot().get("paddle_tpu_resize_epochs_total", 0.0)
    obs_metrics.observe_resize(
        {"drain": 0.25, "reshard": 0.5, "resume": 0.125}
    )
    snap = obs_metrics.snapshot()
    assert snap["paddle_tpu_resize_epochs_total"] == before + 1
    assert (
        snap["paddle_tpu_resize_latency_seconds_total{phase=drain}"] >= 0.25
    )
    # counters sum exactly across fleet heartbeat snapshots
    agg = obs_metrics.aggregate_snapshots([snap, snap])
    assert agg["paddle_tpu_resize_epochs_total"] == 2 * (before + 1)


@pytest.mark.timeout(60)
def test_epoch_go_phase_times_out_wedged_resharder():
    """A member that acks the drain and then wedges INSIDE its re-shard —
    heartbeat thread still renewing the lease, never polling resize_status —
    must not pin the epoch in `go` forever (which would reject every future
    announce). The go phase carries the same timeout guard as the drain."""
    from paddle_tpu_torch.runtime.master import MasterClient, MasterServer, TaskMaster

    srv = MasterServer(
        TaskMaster(), lease_s=5.0, resize_drain_timeout_s=0.8
    ).start()
    try:
        c = MasterClient(srv.address)
        t1 = c.call("register")["trainer_id"]
        t2 = c.call("register")["trainer_id"]
        c.call("resize", world=2)
        c.call("resize_drained", trainer_id=t1, epoch=1)
        go = c.call("resize_drained", trainer_id=t2, epoch=1)
        assert go["state"] == "go"
        # t1 resumes; t2 wedges mid-re-shard but keeps heart-beating
        info = c.call("resize_status", trainer_id=t1, epoch=1)
        deadline = time.time() + 20
        while time.time() < deadline and info["state"] == "go":
            c.call("heartbeat", trainer_id=t2)
            time.sleep(0.1)
            info = c.call("resize_status", trainer_id=t1, epoch=1)
        assert info["state"] == "idle", info
        assert info["completed"] == 1
        assert info["last"]["timed_out"] == 1
        # the epoch is not pinned: a new announce is accepted
        assert c.call("resize", world=2)["state"] == "draining"
        c.close()
    finally:
        srv.stop()


@pytest.mark.timeout(90)
def test_membership_churn_during_epoch_reannounces():
    """Churn that lands while an epoch is in flight must not be dropped:
    the rejected evict-triggered announce parks, and the reaper re-announces
    against the CURRENT membership once the epoch completes — the fleet
    never settles at a stale world size."""
    from paddle_tpu_torch.runtime.master import MasterClient, MasterServer, TaskMaster

    srv = MasterServer(
        TaskMaster(), lease_s=0.6, resize_on_membership=True,
        resize_drain_timeout_s=30.0,
    ).start()
    try:
        c = MasterClient(srv.address)
        t1 = c.call("register")["trainer_id"]
        t2 = c.call("register")["trainer_id"]  # join-epoch 1: world=2
        c.call("resize_drained", trainer_id=t1, epoch=1)
        c.call("resize_drained", trainer_id=t2, epoch=1)
        c.call("resize_status", trainer_id=t1, epoch=1)
        info = c.call("resize_status", trainer_id=t2, epoch=1)
        assert info["state"] == "idle" and info["completed"] == 1

        t3 = c.call("register")["trainer_id"]  # join-epoch 2: world=3
        # t2 dies silently while epoch 2 drains; t1/t3 heartbeat but hold
        # their acks so the eviction lands mid-epoch
        info = c.call("resize_status", epoch=2)
        deadline = time.time() + 20
        while time.time() < deadline and info["barrier"] > 2:
            c.call("heartbeat", trainer_id=t1)
            c.call("heartbeat", trainer_id=t3)
            time.sleep(0.1)
            info = c.call("resize_status", epoch=2)
        assert info["barrier"] == 2, info  # t2 evicted from the barrier
        # epoch 2 completes at its (now stale) world=3
        c.call("resize_drained", trainer_id=t1, epoch=2)
        c.call("resize_drained", trainer_id=t3, epoch=2)
        c.call("resize_status", trainer_id=t1, epoch=2)
        c.call("resize_status", trainer_id=t3, epoch=2)
        # the parked churn re-announces epoch 3 with the live count (2)
        st = c.call("stats")["resize"]
        deadline = time.time() + 20
        while time.time() < deadline and st["epoch"] < 3:
            c.call("heartbeat", trainer_id=t1)
            c.call("heartbeat", trainer_id=t3)
            time.sleep(0.1)
            st = c.call("stats")["resize"]
        assert st["epoch"] == 3 and st["state"] == "draining", st
        assert st["world"] == 2, st
        c.call("resize_drained", trainer_id=t1, epoch=3)
        c.call("resize_drained", trainer_id=t3, epoch=3)
        c.call("resize_status", trainer_id=t1, epoch=3)
        end = c.call("resize_status", trainer_id=t3, epoch=3)
        assert end["state"] == "idle" and end["last"]["world"] == 2
        c.close()
    finally:
        srv.stop()


@pytest.mark.timeout(90)
def test_reader_leases_join_barrier_but_not_world():
    """A process may hold a reader lease besides its trainer lease. The
    announced WORLD counts trainer-role leases only (double-counting would
    shard the data axis to a size no real trainer backs) while the drain
    BARRIER spans every lease — and a reader joining/leaving triggers no
    membership epoch at all."""
    from paddle_tpu_torch.runtime.master import MasterClient, MasterServer, TaskMaster

    srv = MasterServer(
        TaskMaster(), lease_s=5.0, resize_on_membership=True,
    ).start()
    try:
        c = MasterClient(srv.address)
        t1 = c.call("register")["trainer_id"]
        r1 = c.call("register", role="reader")["trainer_id"]
        # a reader lease joining changes no world size: still idle
        assert c.call("stats")["resize"]["state"] == "idle"
        t2 = c.call("register")["trainer_id"]  # join-epoch: world=2, not 3
        st = c.call("stats")["resize"]
        assert st["state"] == "draining" and st["world"] == 2, st
        assert st["barrier"] == 3, st  # ...but ALL three leases must drain
        for tid in (t1, r1, t2):
            c.call("resize_drained", trainer_id=tid, epoch=st["epoch"])
        for tid in (t1, r1, t2):
            end = c.call("resize_status", trainer_id=tid, epoch=st["epoch"])
        assert end["state"] == "idle" and end["last"]["world"] == 2
        c.close()
    finally:
        srv.stop()


@pytest.mark.timeout(60)
def test_watcher_claims_colliding_epoch_from_restarted_master():
    """Epoch numbers are per-master-instance counters: a promoted standby
    counts from 1 again, so its first epoch can COLLIDE with (or sit below)
    a number this trainer already claimed from the dead primary. The
    watcher's replay guard keys on (instance, epoch), so the new master's
    epoch still drains this trainer — a bare-number guard would silently
    exempt it from every resize the new master runs."""
    from paddle_tpu_torch.runtime.master import MasterClient, MasterServer, ResizeClient, TaskMaster

    srv = MasterServer(TaskMaster(), lease_s=0.6).start()
    rc = None
    try:
        rc = ResizeClient(srv.address)
        # as if epoch 1 (and a later epoch 7) were claimed pre-failover
        # from a master instance that no longer exists
        rc._seen = ("dead-primary", 1)
        # ...with the primary's epoch-7 order still parked, unclaimed
        assert preempt.get().request_resize(
            8, epoch=7, instance="dead-primary", reason="stale primary"
        )
        c = MasterClient(srv.address)
        ann = c.call("resize", world=2)
        assert ann["epoch"] == 1  # fresh master numbering restarts
        deadline = time.time() + 15
        req = None
        while time.time() < deadline:
            req = preempt.get().resize_request()
            if req is not None and req.epoch == 1:
                break
            time.sleep(0.05)
        req = preempt.get().take_resize()
        assert req is not None, "watcher never parked the epoch-1 order"
        # the live master's epoch 1 SUPERSEDED the dead primary's parked 7:
        # different instance outranks a higher stale number
        assert req.world == 2 and req.epoch == 1
        assert req.instance == ann["instance"] != "dead-primary"
        c.close()
    finally:
        if rc is not None:
            rc.close()
        srv.stop()


def test_resurrected_reader_lease_keeps_its_role():
    """An evicted reader whose next get_task/task_done resurrects the lease
    (note_seen carries no role) must keep its reader role — defaulting back
    to "trainer" would inflate the next membership-triggered world size."""
    from paddle_tpu_torch.runtime.master import _Membership

    m = _Membership(lease_s=0.01)
    m.register("trainer")
    rid = m.register("reader")
    assert m.live_trainers == 1
    m.drop(rid)  # eviction path
    assert m.live_trainers == 1
    m.note_seen(rid)  # role-less RPC resurrects the lease
    assert m.live == 2
    assert m.live_trainers == 1  # still a reader, not a default trainer
    assert m.role(rid) == "reader"


def test_request_resize_instance_supersede_rules():
    """The parked-order channel: local epoch-0 never clobbers anything
    parked, same-instance duplicates/stale epochs are ignored, a later
    same-instance epoch and ANY different-instance epoch supersede."""
    g = preempt.get()
    assert g.request_resize(2)  # local order parks
    assert not g.request_resize(4)  # second local order ignored
    assert g.request_resize(4, epoch=3, instance="m1")  # master beats local
    assert not g.request_resize(8, epoch=3, instance="m1")  # duplicate
    assert not g.request_resize(8, epoch=2, instance="m1")  # stale
    assert not g.request_resize(8)  # local never clobbers a parked master's
    assert g.request_resize(8, epoch=4, instance="m1")  # later epoch wins
    assert g.request_resize(2, epoch=1, instance="m2")  # failover wins
    req = g.take_resize()
    assert (req.world, req.epoch, req.instance) == (2, 1, "m2")


@pytest.mark.timeout(60)
def test_drain_barrier_proceeds_alone_when_master_dies():
    """A dead master mid-epoch must trigger the documented proceed-alone
    fallback (announced world), not crash the training pass with an
    unhandled ConnectionError from the barrier polls."""
    import socket as socket_mod

    from paddle_tpu_torch.runtime.master import MasterClient, _drain_barrier

    s = socket_mod.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()  # nothing listens here: every call exhausts retries
    c = MasterClient(
        ("127.0.0.1", port), timeout=2.0, retries=2, backoff_base=0.01
    )
    world = _drain_barrier(
        c, "t-gone", epoch=3, fallback_world=4, poll_s=0.01, max_wait_s=10.0
    )
    assert world == 4
    assert stats.FT_EVENTS.get("resize_barrier_master_lost") >= 1
    c.close()


@pytest.mark.timeout(60)
def test_resize_client_parks_the_order_and_its_barrier_returns_the_world():
    """The trainer-side hook on its own: the heartbeat watcher parks the
    announced epoch on the preempt guard, and `barrier` acks the drain,
    waits for go and returns the decided world."""
    from paddle_tpu_torch.runtime.master import MasterClient, MasterServer, ResizeClient, TaskMaster

    srv = MasterServer(TaskMaster(), lease_s=0.45).start()
    rc = None
    try:
        rc = ResizeClient(srv.address, poll_s=0.02)
        boot = MasterClient(srv.address)
        ann = boot.call("resize", world=4)
        assert ann["state"] == "draining" and ann["barrier"] == 1
        deadline = time.time() + 15
        while time.time() < deadline and preempt.get().resize_request() is None:
            time.sleep(0.02)
        req = preempt.get().take_resize()
        assert req is not None and (req.world, req.epoch) == (4, 1)
        assert req.instance == ann["instance"]
        assert rc.barrier(req, 0, 3) == 4
        st = boot.call("stats")["resize"]
        assert st["state"] == "idle" and st["completed"] == 1, st
        assert st["last"]["timed_out"] == 0
        boot.close()
    finally:
        if rc is not None:
            rc.close()
        srv.stop()


@pytest.mark.timeout(60)
def test_resize_drain_stall_site_wedges_the_barrier_until_the_timeout(monkeypatch):
    """`resize_drain_stall` wedges a member inside the barrier without an
    ack; the master's drain timeout drops it and the epoch completes."""
    from paddle_tpu_torch.runtime.master import (
        MasterClient, MasterServer, TaskMaster, _drain_barrier,
    )

    monkeypatch.setenv("PADDLE_TPU_RESIZE_STALL_S", "1.2")
    srv = MasterServer(TaskMaster(), lease_s=5.0, resize_drain_timeout_s=0.4).start()
    try:
        c = MasterClient(srv.address)
        tid = c.call("register")["trainer_id"]
        c.call("resize", world=3)
        with faults.inject("resize_drain_stall:step=0") as inj:
            world = _drain_barrier(c, tid, epoch=1, fallback_world=3, poll_s=0.02)
            assert inj.fired["resize_drain_stall"] == 1
        assert world == 3
        st = c.call("stats")["resize"]
        assert st["state"] == "idle" and st["last"]["timed_out"] == 1, st
        c.close()
    finally:
        srv.stop()


def _toy_batches(n, batch=8, dim=12, seed=1):
    rs = np.random.RandomState(seed)
    for _ in range(n):
        x = rs.randn(batch, dim).astype(np.float32)
        yield {"x": x, "label": (x.sum(-1) > 0).astype(np.int32)}


def _toy_trainer():
    from paddle_tpu_torch.nn import costs as C
    from paddle_tpu_torch.nn import layers as L
    from paddle_tpu_torch.nn.graph import reset_name_scope
    from paddle_tpu_torch.optim import SGD
    from paddle_tpu_torch.trainer import SGDTrainer

    reset_name_scope()
    x = L.Data("x", shape=(12,))
    lbl = L.Data("label", shape=())
    cost = C.ClassificationCost(L.Fc(L.Fc(x, 16, act="relu"), 2, act=None), lbl)
    return SGDTrainer(cost, SGD(learning_rate=0.125), seed=3, device="cpu")


@pytest.mark.timeout(90)
def test_mesh_less_trainer_trains_through_a_resize_epoch(tmp_path):
    """Fault 21's path: a port trainer whose data come from a registered
    cluster_reader (one batch a task) sees an epoch announced mid-pass.
    Its reader lease acks between tasks, the epoch completes with no member
    timed out, a resize order parked on the trainer is taken and ignored,
    and the run's costs and parameters are those of a run without the
    epoch; every task is done exactly once."""
    from paddle_tpu_torch.runtime import recordio
    from paddle_tpu_torch.runtime.master import (
        MasterClient, MasterServer, TaskMaster, cluster_reader,
    )
    from paddle_tpu_torch.trainer.events import EndIteration

    shards = recordio.convert(str(tmp_path / "ds"), lambda: _toy_batches(8),
                              records_per_file=1)
    want = _toy_trainer()
    want_costs = []
    want.train(lambda: _toy_batches(8), num_passes=1, log_period=0,
               event_handler=lambda e: isinstance(e, EndIteration)
               and want_costs.append(float(e.cost)))
    srv = MasterServer(TaskMaster(timeout_s=30.0), lease_s=0.45,
                       resize_drain_timeout_s=30.0).start()
    try:
        boot = MasterClient(srv.address)
        boot.call("set_dataset", shards=shards, chunks_per_task=1)
        tr = _toy_trainer()
        costs, announced = [], []

        def handler(ev):
            if isinstance(ev, EndIteration):
                costs.append(float(ev.cost))
                time.sleep(0.1)  # a heartbeat lands inside the pass
                if ev.batch_id == 2 and not announced:
                    announced.append(boot.call("resize", world=2))
                    preempt.get().request_resize(2, reason="local order")

        tr.train(cluster_reader(srv.address, poll_interval=0.05), num_passes=1,
                 event_handler=handler, log_period=0)
        assert announced and announced[0]["state"] == "draining"
        assert not preempt.resize_requested()  # taken and ignored
        deadline = time.time() + 10
        st = boot.call("stats")
        while time.time() < deadline and st["resize"]["state"] != "idle":
            time.sleep(0.05)
            st = boot.call("stats")
        assert st["resize"]["completed"] == 1 and st["resize"]["last"]["timed_out"] == 0, st
        assert st["done"] == 8 and st["discarded"] == 0
        assert stats.FT_EVENTS.get("reader_resize_drain") == 1
        np.testing.assert_allclose(costs, want_costs, rtol=1e-6)
        for k, v in want.state["params"].items():
            np.testing.assert_allclose(tr.state["params"][k].numpy(), v.numpy(), rtol=1e-6)
        boot.close()
    finally:
        srv.stop()
