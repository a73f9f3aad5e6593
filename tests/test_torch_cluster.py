"""The port's task plane (`paddle_tpu_torch/runtime/master.py`), held to the
JAX package's: the twins of tests/test_cluster.py's master tests, and mixed
pairs across the two packages.

  * failover — a real master process dies to the seeded `master_kill`
    fault mid-pass; a warm standby on the same snapshot takes over; two
    `cluster_reader` consumers fail over through their endpoint list; every
    task is done exactly once (done == ntasks, discarded == 0) and every
    record is consumed. Parametrised over the packages of the primary, the
    standby and the readers: the port alone, a JAX primary with a port
    standby feeding port readers, and a port primary with a JAX standby
    feeding JAX readers (the snapshot and the wire are one format);
  * leases — an evicted trainer's task is re-queued at once, deregister is
    not an eviction, the master aggregates the metric snapshots riding on
    a real reader's heartbeats;
  * partitions — seeded client RSTs cost reconnects, never records;
  * mixed wires — a JAX `MasterClient` against a port `MasterServer` and
    the other way round, framed and line JSON, give the same replies."""

import os
import socket
import subprocess
import sys
import threading
import time

import pytest

from paddle_tpu_torch.core import faults, preempt, stats
from paddle_tpu_torch.runtime import recordio
from paddle_tpu_torch.runtime.master import (
    KILLED_EXIT,
    MasterClient,
    MasterServer,
    TaskMaster,
    cluster_reader,
    parse_endpoints,
    standby_master,
)

pytestmark = [pytest.mark.chaos, pytest.mark.timeout(120)]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh():
    stats.FT_EVENTS.reset()
    preempt.reset()
    yield
    preempt.reset()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait_port(port: int, deadline_s: float = 60.0) -> None:
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        try:
            socket.create_connection(("127.0.0.1", port), 0.5).close()
            return
        except OSError:
            time.sleep(0.05)
    raise TimeoutError(f"port {port} never came up")


def _child_env() -> dict:
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    return env


def _package(name: str):
    """(standby_master, cluster_reader, FT_EVENTS) of one package, with the
    counters reset."""
    if name == "torch":
        return standby_master, cluster_reader, stats.FT_EVENTS
    from paddle_tpu.core import stats as jstats
    from paddle_tpu.runtime import master as jmaster

    jstats.FT_EVENTS.reset()
    return jmaster.standby_master, jmaster.cluster_reader, jstats.FT_EVENTS


def test_parse_endpoints_forms():
    assert parse_endpoints(("h", 1)) == [("h", 1)]
    assert parse_endpoints("h:1") == [("h", 1)]
    assert parse_endpoints("a:1,b:2") == [("a", 1), ("b", 2)]
    assert parse_endpoints([("a", 1), "b:2"]) == [("a", 1), ("b", 2)]
    with pytest.raises(ValueError):
        parse_endpoints("noport")
    with pytest.raises(ValueError):
        parse_endpoints("")


@pytest.mark.parametrize("primary,standby,readers", [
    ("torch", "torch", "torch"),
    ("paddle_tpu", "torch", "torch"),
    ("torch", "paddle_tpu", "paddle_tpu"),
])
def test_master_kill_standby_failover_exactly_once(tmp_path, primary, standby, readers):
    nrec, per_task = 48, 4
    shards = recordio.convert(
        str(tmp_path / "ds"), lambda: ({"sid": i} for i in range(nrec)),
        records_per_file=per_task,
    )
    ntasks = len(shards)
    p1, p2 = _free_port(), _free_port()
    snap = str(tmp_path / "m.snap")
    module = "paddle_tpu_torch" if primary == "torch" else "paddle_tpu"
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{module}.runtime.master", "serve",
         "--port", str(p1), "--snapshot", snap, "--lease_s", "2",
         "--timeout_s", "30", "--failure_max", "10",
         "--faults", "master_kill:step=9", "--faults_seed", "0"],
        env=_child_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True,
    )
    sb_master, _, sb_events = _package(standby)
    _, reader_fn, ft = _package(readers)
    holder = {}
    try:
        _wait_port(p1)
        boot = MasterClient(("127.0.0.1", p1))
        boot.call("set_dataset", shards=shards, chunks_per_task=1)
        boot.close()

        def run_standby():
            holder["srv"] = sb_master(
                ("127.0.0.1", p1), port=p2, snapshot_path=snap,
                poll_s=0.1, max_wait_s=90, lease_s=2.0,
            )

        threading.Thread(target=run_standby, daemon=True).start()
        endpoints = [("127.0.0.1", p1), ("127.0.0.1", p2)]
        consumed, errs = [[], []], []

        def consume(i):
            try:
                for s in reader_fn(endpoints, client_kw={"retries": 40, "timeout": 5})():
                    consumed[i].append(s["sid"])
                    time.sleep(0.01)  # keep both consumers in the pass
            except Exception as e:  # surfaced below
                errs.append(e)

        threads = [threading.Thread(target=consume, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=90)
        assert not any(t.is_alive() for t in threads), "consumers hung"
        assert not errs, errs
        proc.wait(timeout=10)
        assert proc.returncode == KILLED_EXIT
        assert holder.get("srv") is not None, "standby never took over"
        post = MasterClient(("127.0.0.1", p2))
        st = post.call("stats")
        post.close()
        assert st["done"] == ntasks and st["discarded"] == 0, st
        assert set(consumed[0] + consumed[1]) == set(range(nrec))
        assert consumed[0] and consumed[1]
        assert ft.get("master_failover") > 0
        assert sb_events.get("master_takeover") == 1
    finally:
        if proc.poll() is None:
            proc.kill()
        if holder.get("srv") is not None:
            holder["srv"].stop()


def test_trainer_lease_eviction_eagerly_requeues():
    server = MasterServer(TaskMaster(timeout_s=120.0, failure_max=5), lease_s=0.3).start()
    try:
        ca = MasterClient(server.address)
        ca.call("set_dataset", shards=["a", "b", "c", "d"])
        tid_a = ca.call("register")["trainer_id"]
        lost = ca.call("get_task", trainer_id=tid_a)
        assert "task_id" in lost
        ca.close()  # trainer A dies silently, task in hand

        cb = MasterClient(server.address)
        tid_b = cb.call("register")["trainer_id"]
        got, t0 = [], time.time()
        while time.time() < t0 + 10:
            resp = cb.call("get_task", trainer_id=tid_b)
            if "task_id" in resp:
                got.append(resp["task_id"])
                if lost["task_id"] in got:
                    break
            else:
                time.sleep(0.05)
        assert lost["task_id"] in got, "the evicted trainer's task never came back"
        assert time.time() - t0 < 10  # far below the 120 s task timeout
        st = cb.call("stats")
        assert st["evicted_trainers"] == 1 and st["live_trainers"] == 1
        assert stats.FT_EVENTS.get("trainer_evicted") == 1
        cb.close()
    finally:
        server.stop()
    assert server.master.closed
    server.stop()  # idempotent


def test_fleet_metrics_aggregated_from_real_process_heartbeats(tmp_path):
    nrec = 32
    shards = recordio.convert(
        str(tmp_path / "ds"), lambda: ({"sid": i} for i in range(nrec)),
        records_per_file=4,
    )
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.runtime.master", "serve",
         "--port", str(port), "--lease_s", "0.6"],
        env=_child_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        _wait_port(port)
        boot = MasterClient(("127.0.0.1", port))
        boot.call("set_dataset", shards=shards, chunks_per_task=1)
        stats.FT_EVENTS.incr("fleet_probe", 3)
        consumed, errs = [], []

        def consume():
            try:
                for s in cluster_reader(("127.0.0.1", port), client_kw={"retries": 20})():
                    consumed.append(s["sid"])
                    time.sleep(0.05)  # stretch the pass past a few heartbeats
            except Exception as e:
                errs.append(e)

        t = threading.Thread(target=consume)
        t.start()
        fleet, deadline = None, time.time() + 30
        while time.time() < deadline:
            fleet = boot.call("stats").get("fleet")
            if fleet and fleet.get("reporting_trainers", 0) >= 1 and any(
                    "fleet_probe" in k for k in fleet.get("counters", {})):
                break
            time.sleep(0.1)
        t.join(timeout=60)
        assert not t.is_alive() and not errs, errs
        key = next(k for k in fleet["counters"] if "fleet_probe" in k)
        assert fleet["counters"][key] >= 3.0
        assert sorted(consumed) == list(range(nrec))
        text = boot.call("metrics")["text"]
        assert "paddle_tpu_fleet_reporting_trainers" in text
        boot.close()
    finally:
        if proc.poll() is None:
            proc.terminate()
        proc.wait(timeout=15)


def test_deregister_releases_lease_without_eviction():
    server = MasterServer(TaskMaster(), lease_s=30.0).start()
    try:
        c = MasterClient(server.address)
        tid = c.call("register")["trainer_id"]
        assert c.call("stats")["live_trainers"] == 1
        assert c.call("deregister", trainer_id=tid)["ok"]
        st = c.call("stats")
        assert st["live_trainers"] == 0 and st["evicted_trainers"] == 0
        c.close()
    finally:
        server.stop()


def test_conn_reset_partition_absorbed(tmp_path):
    nrec = 24
    shards = recordio.convert(
        str(tmp_path / "ds"), lambda: ({"sid": i} for i in range(nrec)),
        records_per_file=4,
    )
    server = MasterServer(TaskMaster(timeout_s=30, failure_max=5)).start()
    try:
        boot = MasterClient(server.address)
        boot.call("set_dataset", shards=shards, chunks_per_task=1)
        boot.close()
        with faults.inject("conn_reset:0.2", seed=2) as inj:
            got = sorted(s["sid"] for s in cluster_reader(
                server.address, client_kw={"retries": 40})())
            assert inj.fired.get("conn_reset", 0) > 0
        assert got == list(range(nrec))
        st = MasterClient(server.address).call("stats")
        assert st["done"] == len(shards) and st["discarded"] == 0
        assert stats.FT_EVENTS.get("master_reconnect") > 0
    finally:
        server.stop()


@pytest.mark.parametrize("wire", ["frames", "json"])
@pytest.mark.parametrize("server_pkg", ["torch", "paddle_tpu"])
def test_mixed_wire_replies_match(server_pkg, wire):
    """The same RPC sequence from both packages' clients against one
    server of either package gives the same replies (the snapshot blob
    included, raw on a framed connection and base64 on line JSON)."""
    from paddle_tpu.runtime import master as jmaster

    mod = sys.modules[MasterServer.__module__] if server_pkg == "torch" else jmaster
    replies = []
    for client_cls in (MasterClient, jmaster.MasterClient):
        server = mod.MasterServer(mod.TaskMaster(timeout_s=30), lease_s=30.0).start()
        try:
            c = client_cls(server.address, wire=wire)
            c.call("set_dataset", shards=["s0", "s1", "s2"], chunks_per_task=1)
            tid = c.call("register", role="reader")["trainer_id"]
            got = c.call("get_tasks", n=2, done_ids=[], failed_ids=[], trainer_id=tid)
            ids = [t["task_id"] for t in got["tasks"]]
            seq = [got, c.call("get_tasks", n=5, done_ids=ids, failed_ids=[],
                               trainer_id=tid)]
            st = c.call("stats")
            seq.append({k: st[k] for k in ("todo", "pending", "done", "discarded")})
            seq.append(c.call("resize", world=True))  # rejected: not an integer
            seq.append(c.call("deregister", trainer_id=tid))
            assert c.wire_framed == (wire == "frames")
            c.close()
            replies.append(seq)
        finally:
            server.stop()
    assert replies[0] == replies[1]


def test_snapshot_fetch_serves_the_snapshot_over_both_wires(tmp_path):
    snap = str(tmp_path / "m.snap")
    server = MasterServer(TaskMaster(), snapshot_path=snap).start()
    try:
        c = MasterClient(server.address)
        c.call("set_dataset", shards=["a", "b"])
        t = c.call("get_task")
        c.call("task_finished", task_id=t["task_id"])
        framed = c.call("snapshot_fetch")
        with open(snap, "rb") as f:
            blob = f.read()
        assert framed["bytes"] == len(blob) > 0 and framed["_bin"] == blob
        line = MasterClient(server.address, wire="json").call("snapshot_fetch")
        import base64

        assert base64.b64decode(line["bin_b64"]) == blob
    finally:
        server.stop()
