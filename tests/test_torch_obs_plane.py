"""The port's observability and chaos pieces of the task plane, held to the
JAX package's: the twins of tests/test_obs.py's metrics, fleet, profiler
and stats tests and of tests/test_faults.py's master tests, and training
parity through a master.

  * metrics — the registry absorbs the event counters and the timers;
    `aggregate_snapshots` / `FleetMetrics` sum per-trainer heartbeat
    snapshots; the master's `stats` and `metrics` RPCs answer for the
    fleet; the Prometheus text of the same samples equals the JAX
    package's;
  * `python -m paddle_tpu_torch.obs export|trace` (local, and against a
    master process whose RPC spans stitch into the caller's trace);
  * `core/stats.py` — StatSet's report order, idempotent profiler start /
    stop; `obs/profile.py` — the profile spec, the step cost report's keys
    (the JAX package's shape, torch's numbers), a pass profiler that
    captures exactly its pass;
  * the master's chaos sites — `master_drop` absorbed by the client's
    backoff, a clear terminal error, snapshot failures counted, a master
    killed with a lease out restarts from its snapshot without losing or
    repeating a sample; `h2d_delay` sleeps in the prefetcher's copy leg;
  * a JAX trainer and a port trainer, the same parameters moved by name,
    each pulling the same shards from its own package's master with
    lease_batch 1: their first 4 costs agree within 1e-5 relative."""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from paddle_tpu_torch.core import faults, stats
from paddle_tpu_torch.obs import metrics as obs_metrics
from paddle_tpu_torch.obs import trace
from paddle_tpu_torch.runtime import recordio
from paddle_tpu_torch.runtime.master import (
    MasterClient,
    MasterServer,
    TaskMaster,
    cluster_reader,
)

pytestmark = [pytest.mark.timeout(120)]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh():
    stats.FT_EVENTS.reset()
    trace.reset()
    yield
    trace.enable_tracing(False)
    trace.reset()


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
    return dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)


# -- metrics ----------------------------------------------------------------------


def test_metrics_registry_absorbs_event_counters_and_timers():
    stats.FT_EVENTS.incr("obs_test_marker", 3)
    stats.enable_timers(True)
    try:
        with stats.timer("obs_test_timer"):
            pass
    finally:
        stats.enable_timers(False)
    snap = obs_metrics.snapshot()
    assert snap["paddle_tpu_events_total{event=obs_test_marker,group=ft}"] == 3.0
    assert snap["paddle_tpu_timer_calls_total{name=obs_test_timer}"] >= 1
    text = obs_metrics.to_prometheus_text()
    assert 'paddle_tpu_events_total{event="obs_test_marker",group="ft"} 3' in text


def test_prometheus_text_with_gauges_and_fleet_matches_jax():
    from paddle_tpu.obs import metrics as jmetrics

    texts = []
    for mod in (obs_metrics, jmetrics):
        reg = mod.MetricsRegistry()
        reg.gauge("g_depth").set(7, pool="a")
        reg.gauge("g_depth").inc(2, pool="a")
        reg.counter("c_total").inc(1234567)
        reg.histogram("h_seconds", buckets=(0.1, 1.0)).observe(0.5)
        fleet = {"reporting_trainers": 2, "counters": {"steps": 12.0, 'a"b': 1.5}}
        texts.append(mod.to_prometheus_text(reg, fleet=fleet, extra={"x_up": 1}))
    assert texts[0] == texts[1]
    assert "g_depth{pool=\"a\"} 9" in texts[0] and "c_total 1234567" in texts[0]


def test_aggregate_snapshots_and_fleet_metrics():
    assert obs_metrics.aggregate_snapshots(
        [{"a": 1, "b": 2}, {"a": 4, "c": "garbage"}]) == {"a": 5.0, "b": 2.0}
    fm = obs_metrics.FleetMetrics(ttl_s=60)
    fm.update("tr-1", {"a": 1.0})
    fm.update("tr-2", {"a": 2.0, "b": 1.0})
    assert fm.aggregate() == {"reporting_trainers": 2, "counters": {"a": 3.0, "b": 1.0}}
    fm.drop("tr-1")
    assert fm.aggregate()["reporting_trainers"] == 1
    fm = obs_metrics.FleetMetrics(ttl_s=0.0)
    fm.update("tr-1", {"a": 1.0})
    time.sleep(0.01)
    assert fm.aggregate()["reporting_trainers"] == 0  # expired


def test_scale_counters_reach_the_snapshot():
    before = obs_metrics.snapshot()
    obs_metrics.observe_scale_decision("train", "grow")
    obs_metrics.observe_scale_suppressed("flap")
    obs_metrics.observe_scale_rejected("train")
    snap = obs_metrics.snapshot()
    for key in ("paddle_tpu_autoscaler_decisions_total{direction=grow,lever=train}",
                "paddle_tpu_autoscaler_suppressed_total{reason=flap}",
                "paddle_tpu_autoscaler_rejected_total{lever=train}"):
        assert snap[key] == before.get(key, 0.0) + 1


def test_master_stats_aggregates_heartbeat_metrics():
    server = MasterServer(TaskMaster(), lease_s=30.0).start()
    try:
        c = MasterClient(server.address)
        t1 = c.call("register")["trainer_id"]
        t2 = c.call("register")["trainer_id"]
        c.call("heartbeat", trainer_id=t1, metrics={"steps": 5, "x": 1})
        c.call("heartbeat", trainer_id=t2, metrics={"steps": 7})
        fleet = c.call("stats")["fleet"]
        assert fleet["reporting_trainers"] == 2 and fleet["counters"]["steps"] == 12.0
        c.call("heartbeat", trainer_id=t2, metrics={"steps": 8})  # replaces
        assert c.call("stats")["fleet"]["counters"]["steps"] == 13.0
        c.call("deregister", trainer_id=t2)
        fleet = c.call("stats")["fleet"]
        assert fleet["reporting_trainers"] == 1 and fleet["counters"]["steps"] == 5.0
        text = c.call("metrics")["text"]
        assert "paddle_tpu_fleet_reporting_trainers 1" in text
        assert 'paddle_tpu_fleet{key="steps"} 5' in text
        c.close()
    finally:
        server.stop()


# -- the operator CLI -------------------------------------------------------------


def test_obs_cli_export_and_trace_against_a_master_process(tmp_path):
    """`export` prints this process's registry without an endpoint and the
    master's text with one; `trace --endpoint` merges the master's RPC
    spans, which share the client span's trace id, into a loadable file."""
    r = subprocess.run([sys.executable, "-m", "paddle_tpu_torch.obs", "export"],
                       env=_child_env(), capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    assert "# TYPE paddle_tpu_trace_spans_recorded_total counter" in r.stdout
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.runtime.master", "serve",
         "--port", str(port), "--trace", "1"],
        env=_child_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        _wait_port(port)
        trace.enable_tracing(True)
        client = MasterClient(("127.0.0.1", port))
        client.call("set_dataset", shards=["a", "b"])
        assert "task_id" in client.call("get_task")
        remote = client.call("trace_export")["chrome_trace"]
        client.close()
        local = trace.export_chrome()

        def events(tr, side):
            return [e for e in tr["traceEvents"]
                    if e["name"] == "rpc.get_task" and e["args"].get("side") == side]

        cl, sv = events(local, "client"), events(remote, "server")
        assert len(cl) == 1 and len(sv) == 1
        assert sv[0]["args"]["trace_id"] == cl[0]["args"]["trace_id"]
        assert sv[0]["args"]["parent_id"] == cl[0]["args"]["span_id"]
        assert trace.validate_chrome(trace.merge_chrome([local, remote])) == []
        ep = f"127.0.0.1:{port}"
        r = subprocess.run([sys.executable, "-m", "paddle_tpu_torch.obs", "export",
                            "--endpoint", ep], env=_child_env(), capture_output=True,
                           text=True, timeout=60)
        assert r.returncode == 0, r.stderr
        assert "paddle_tpu_trace_spans_recorded_total 3" in r.stdout
        out = tmp_path / "t.json"
        r = subprocess.run([sys.executable, "-m", "paddle_tpu_torch.obs", "trace",
                            "--endpoint", ep, "--out", str(out)], env=_child_env(),
                           capture_output=True, text=True, timeout=60)
        assert r.returncode == 0, r.stderr
        merged = json.loads(out.read_text())
        assert any(e["name"] == "rpc.get_task" for e in merged["traceEvents"])
    finally:
        proc.terminate()
        proc.wait(timeout=15)


def test_merge_chrome_orders_events_and_sums_drops():
    a = {"traceEvents": [{"ts": 5, "name": "x"}], "otherData": {"dropped_spans": 2}}
    b = {"traceEvents": [{"ts": 1, "name": "y"}], "otherData": {"dropped_spans": 1}}
    merged = trace.merge_chrome([a, None, b])
    assert [e["name"] for e in merged["traceEvents"]] == ["y", "x"]
    assert merged["otherData"]["dropped_spans"] == 3
    assert trace.current_context() is None
    trace.enable_tracing(True)
    with trace.span("outer") as sp:
        assert trace.current_context() == (sp.trace_id, sp.span_id)


# -- core/stats.py and obs/profile.py -------------------------------------------------


def test_profiler_start_stop_idempotent(tmp_path):
    assert stats.profiler_stop() is None  # nothing active: a no-op
    stats.profiler_start(str(tmp_path / "p"))
    stats.profiler_start(str(tmp_path / "p"))  # second start: warn, no-op
    with stats.profile_region("region"):
        np.ones(3)
    assert stats.profiler_stop() is not None
    assert stats.profiler_stop() is None
    assert (tmp_path / "p" / "trace.json").exists()


def test_statset_report_percent_and_deterministic_ties():
    ss = stats.StatSet()
    ss.get("zeta").add(0.010)
    ss.get("alpha").add(0.010)
    ss.get("big").add(0.080)
    rep = ss.report()
    lines = rep.splitlines()[1:]
    assert [ln.strip().split(":")[0] for ln in lines] == ["big", "alpha", "zeta"]
    assert "80.0%" in lines[0] and "10.0%" in lines[1]
    assert ss.report() == rep
    t = stats.TimerOnce("once").start()
    t.stop()  # timers off: nothing recorded
    assert "once" not in stats.GLOBAL_STATS.as_dict()


def test_parse_profile_spec_rejects_bad_forms():
    from paddle_tpu_torch.obs.profile import parse_profile_spec

    assert parse_profile_spec("pass:0") == ("pass", 0)
    for bad in ("", "pass", "pass:x", "pass:-1", "step:3"):
        with pytest.raises(ValueError):
            parse_profile_spec(bad)


def _toy(pkg):
    """The toy classifier of tests/test_obs.py in one package, and a batch."""
    import importlib

    L = importlib.import_module(f"{pkg}.nn.layers")
    C = importlib.import_module(f"{pkg}.nn.costs")
    importlib.import_module(f"{pkg}.nn.graph").reset_name_scope()
    SGD = importlib.import_module(f"{pkg}.optim").SGD
    Trainer = importlib.import_module(f"{pkg}.trainer").SGDTrainer
    x = L.Data("x", shape=(8,))
    lbl = L.Data("label", shape=())
    cost = C.ClassificationCost(L.Fc(L.Fc(x, 16, act="relu"), 3, act=None), lbl)
    kw = {"device": "cpu"} if pkg == "paddle_tpu_torch" else {}
    return Trainer(cost, SGD(learning_rate=0.1), seed=0, **kw)


def _toy_batches(n=8, seed=0):
    rs = np.random.RandomState(seed)
    return [{"x": rs.randn(8, 8).astype(np.float32),
             "label": (np.arange(8) % 3).astype(np.int32)} for _ in range(n)]


def test_trainer_cost_report_has_the_jax_reports_shape():
    from paddle_tpu.obs import profile as jprofile

    from paddle_tpu_torch.obs import profile as obs_profile

    batch = _toy_batches(1)[0]
    tr = _toy("paddle_tpu_torch")
    tr.init_state(batch)
    before = {k: v.clone() for k, v in tr.state["params"].items()}
    report = obs_profile.trainer_cost_report(tr, batch, top_k=3)
    jt = _toy("paddle_tpu")
    jt.init_state(batch)
    jreport = jprofile.trainer_cost_report(jt, batch, top_k=3)
    assert set(report) == set(jreport)
    step, jstep = report["executables"]["train_step"], jreport["executables"]["train_step"]
    assert set(step) == set(jstep) == {"flops", "bytes_accessed", "top_buckets"}
    assert step["flops"] > 0 and step["bytes_accessed"] > 0
    assert 0 < len(step["top_buckets"]) <= 3
    assert all(set(b) == {"bucket", "value"} for b in step["top_buckets"])
    vals = [b["value"] for b in step["top_buckets"]]
    assert vals == sorted(vals, reverse=True)
    for k, v in tr.state["params"].items():  # the report ran on a copy
        assert np.array_equal(v.numpy(), before[k].numpy())


def test_pass_profiler_captures_one_pass(tmp_path):
    from paddle_tpu_torch.obs import profile as obs_profile

    tr = _toy("paddle_tpu_torch")
    batch = _toy_batches(1)[0]
    profiler = obs_profile.PassProfiler.from_spec("pass:1", logdir=str(tmp_path / "trace"))
    seen, active = [], []

    def handler(e):
        seen.append(type(e).__name__)
        active.append(stats._profiler is not None)

    tr.train(lambda: iter([batch] * 4), num_passes=3, event_handler=profiler.wrap(handler),
             log_period=100)
    assert profiler.captured and profiler.events > 0 and not profiler._active
    assert (tmp_path / "trace" / "trace.json").exists()
    # active exactly from pass 1's BeginPass to its EndPass
    per_pass = [active[i * 10:(i + 1) * 10] for i in range(3)]  # 1 + 2 x 4 + 1
    assert not any(per_pass[0]) and all(per_pass[1]) and not any(per_pass[2])
    assert "EndPass" in seen


# -- the master's chaos sites (tests/test_faults.py) ------------------------------


def test_master_drop_fault_client_backoff_completes(tmp_path):
    samples = [{"x": i} for i in range(48)]
    shards = recordio.convert(str(tmp_path / "ds"), lambda: iter(samples),
                              records_per_file=12)
    server = MasterServer(TaskMaster(timeout_s=30, failure_max=2)).start()
    try:
        with faults.inject("master_drop:0.2", seed=3) as inj:
            client = MasterClient(server.address, retries=6, backoff_base=0.01)
            assert client.call("set_dataset", shards=shards, chunks_per_task=1)["ok"]
            got = sorted(cluster_reader(server.address)(), key=lambda s: s["x"])
            client.close()
            dropped = inj.fired.get("master_drop", 0)
        assert got == samples
        assert dropped >= 1
        assert stats.FT_EVENTS.get("master_reconnect") >= dropped
    finally:
        server.stop()


def test_master_client_terminal_error_is_clear():
    dead = MasterClient(("127.0.0.1", 1), timeout=0.2, retries=2, backoff_base=0.01)
    with pytest.raises(ConnectionError, match="'get_task'.*after 2 attempts"):
        dead.call("get_task")


def test_master_snapshot_failure_logged_and_counted(tmp_path, caplog):
    bad = str(tmp_path / "no_such_dir" / "m.snap")
    server = MasterServer(TaskMaster(timeout_s=30, failure_max=2), snapshot_path=bad).start()
    try:
        client = MasterClient(server.address)
        client.call("set_dataset", shards=["s0", "s1"], chunks_per_task=1)
        with caplog.at_level("WARNING", logger="paddle_tpu_torch.master"):
            resp = client.call("get_task")
            client.call("task_finished", task_id=resp["task_id"])
        assert client.call("stats")["snapshot_failures"] >= 1
        assert server.snapshot_failures >= 1
        assert any("snapshot" in r.message for r in caplog.records)
        client.close()
    finally:
        server.stop()


def test_master_kill_restart_midpass_no_loss_no_dup(tmp_path):
    samples = list(range(40))
    shards = recordio.convert(str(tmp_path / "ds"), lambda: iter(samples),
                              records_per_file=10)
    snap = str(tmp_path / "m.snap")
    server = MasterServer(TaskMaster(timeout_s=30, failure_max=2), snapshot_path=snap).start()
    client = MasterClient(server.address)
    client.call("set_dataset", shards=shards, chunks_per_task=1)
    done = client.call("get_task")
    leased = client.call("get_task")  # lost with the server
    consumed = list(recordio.read_shards(done["shards"]))
    client.call("task_finished", task_id=done["task_id"])
    client.close()
    server.stop()
    server2 = MasterServer(TaskMaster(timeout_s=30, failure_max=2), snapshot_path=snap).start()
    try:
        rest = list(cluster_reader(server2.address)())
        assert sorted(consumed + rest) == samples
        assert all(s in rest for s in recordio.read_shards(leased["shards"]))
        st = MasterClient(server2.address).call("stats")
        assert st["todo"] == 0 and st["pending"] == 0
    finally:
        server2.stop()


def test_h2d_delay_sleeps_in_the_prefetchers_copy_leg():
    from paddle_tpu_torch.data.pipeline import DevicePrefetcher

    batches = _toy_batches(3)
    with faults.inject("h2d_delay:30ms") as inj:
        t0 = time.perf_counter()
        got = list(DevicePrefetcher(lambda: iter(batches), device="cpu")())
        dt = time.perf_counter() - t0
        assert inj.fired["h2d_delay"] == 3
    assert len(got) == 3 and dt >= 0.09
    assert np.array_equal(got[2]["x"].numpy(), batches[2]["x"])


# -- training parity through the master ---------------------------------------------


def test_master_fed_training_matches_jax(tmp_path):
    """The same shards behind a JAX master and a port master; each
    package's trainer pulls them through its own cluster_reader with
    lease_batch 1, from the same parameters (moved by name): the first 4
    costs agree within 1e-5 relative."""
    import jax.numpy as jnp
    from paddle_tpu.runtime import master as jmaster

    from paddle_tpu_torch.nn.convert import params_from_jax

    batches = _toy_batches(4, seed=5)
    shards = recordio.convert(str(tmp_path / "ds"), lambda: iter(batches),
                              records_per_file=1)
    jt = _toy("paddle_tpu")
    jt.init_state(batches[0])
    params0 = {k: np.asarray(v) for k, v in jt.state["params"].items()}
    jt.state["params"] = {k: jnp.asarray(v) for k, v in params0.items()}
    tr = _toy("paddle_tpu_torch")
    tr.init_state(batches[0])
    tr.load_params(params_from_jax(params0, device="cpu"))
    costs = []
    for mod, trainer in ((jmaster, jt), (sys.modules[MasterServer.__module__], tr)):
        srv = mod.MasterServer(mod.TaskMaster()).start()
        try:
            c = mod.MasterClient(srv.address)
            c.call("set_dataset", shards=shards, chunks_per_task=1)
            got = []

            def handler(e):
                if type(e).__name__ == "EndIteration":
                    got.append(float(e.cost))

            trainer.train(mod.cluster_reader(srv.address, lease_batch=1), num_passes=1,
                          event_handler=handler, log_period=1000)
            assert c.call("stats")["done"] == 4
            c.close()
        finally:
            srv.stop()
        costs.append(got)
    assert len(costs[1]) == 4
    np.testing.assert_allclose(costs[1], costs[0], rtol=1e-5)
