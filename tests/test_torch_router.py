"""The port's serving router and fleet (`paddle_tpu_torch/serving/router.py`,
`serving/fleet.py`), held against the JAX package: the twins of
tests/test_router.py, plus the wire between the two packages' fleets.

  * dispatch — requests route to the least-loaded live replica off
    piggybacked heartbeat state, and the fleet's tokens equal a direct JAX
    `ServingSession`'s (greedy and seed-77 sampled: the same parameters,
    moved across by name);
  * fleet-wide shed, in-flight failover (kill mid-stream: same key, same
    pinned seed, token-identical), the late winner from a healed replica
    dropped and counted, unplaceable requests failing `replica_lost`,
    hedging, planned drain, the client's shed-retry, `poll_many` tenancy,
    prefix affinity (the key hashes the prompt head exactly as the JAX
    package's does);
  * mixed fleets — port replicas behind the JAX package's RouterServer and
    JAX replicas behind the port's, each with one failover from a replica
    of one package to a replica of the other, token-identical;
  * the hot-path RPC budget — an AST scan of the named dispatch, pump and
    sweep functions: exactly the JAX package's count of blocking replica
    RPCs, and no health probe;
  * the CLI — `python -m paddle_tpu_torch.serving.router serve` and
    `python -m paddle_tpu_torch serve --router_endpoints` start, join,
    answer and stop; the `--autoscale*` flags raise naming item 7b.

Timing-sensitive tests use short leases and the deterministic wedge (the
engine parked between steps on the session's generation lock) with
`_wait(cond)` polling; every socket test carries a timeout."""

import ast
import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from paddle_tpu_torch.serving import ServableLM, ServingSession
from paddle_tpu_torch.serving.convert import params_from_jax
from paddle_tpu_torch.serving.model import LMConfig

pytestmark = [pytest.mark.serving, pytest.mark.chaos]

REPO = pathlib.Path(__file__).resolve().parent.parent
CFG = dict(vocab=96, n_layers=2, d_model=32, n_heads=2, max_len=96)
SESSION = dict(max_slots=4, page_size=8, prefill_buckets=(8, 16, 32),
               max_new_limit=16)
PROMPT = [1, 5, 9, 11]
SAMPLED = dict(seed=77, temperature=0.8, top_k=8)


def _wait(cond, timeout_s=15.0, interval_s=0.02):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval_s)
    return False


@pytest.fixture(scope="module")
def jax_pair():
    import jax

    from paddle_tpu.serving.model import LMConfig as JaxConfig
    from paddle_tpu.serving.model import ServableLM as JaxLM

    jm = JaxLM(JaxConfig(**CFG))
    return jm, jm.init_params(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def port_model(jax_pair):
    _, jp = jax_pair
    pm = ServableLM(LMConfig(**CFG), device="cpu")
    pm.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in jp.items()}))
    return pm


def jax_session(jax_pair, **kw):
    from paddle_tpu.serving.session import ServingSession as JaxSession

    jm, jp = jax_pair
    return JaxSession(jm, jp, **{**SESSION, **kw})


@pytest.fixture(scope="module")
def reference(jax_pair):
    """Oracle tokens from a direct JAX session: greedy and sampled."""
    s = jax_session(jax_pair)
    greedy = s.submit(PROMPT, 8)
    sampled = s.submit(PROMPT, 8, **SAMPLED)
    s.run_until_idle()
    return {"greedy": greedy.tokens, "sampled": sampled.tokens}


def make_session(port_model, **kw):
    return ServingSession(port_model, device="cpu", **{**SESSION, **kw})


def warm_session(sess):
    """Run one request before the replica holds a lease, then forget the
    load estimate it left (an asymmetric queue-wait estimate would flip
    the least-loaded tie-break the dispatch tests pin). A session made to
    shed everything (max_queue=0) has nothing to warm."""
    from paddle_tpu_torch.serving.quota import QuotaExceeded

    try:
        sess.submit(PROMPT, 4)
    except QuotaExceeded:
        return sess
    sess.run_until_idle()
    sess.scheduler.reset_load_estimate()
    return sess


def make_fleet(port_model, n, lease_s=3.0, stall_fence_s=5.0,
               session_kw=None, **router_kw):
    """The port's RouterServer + n port replica servers joined to it."""
    from paddle_tpu_torch.serving import ServingServer
    from paddle_tpu_torch.serving.router import RouterServer

    router_kw.setdefault("poll_interval_s", 0.02)
    router = RouterServer(lease_s=lease_s, **router_kw).start()
    servers = []
    for _ in range(n):
        sess = warm_session(make_session(port_model, **(session_kw or {})))
        srv = ServingServer(
            session=sess, router_endpoints=router.address,
            stall_fence_s=stall_fence_s,
        ).start()
        servers.append((srv, sess))
    assert _wait(lambda: len(router.fleet.live()) == n), "replicas must join"
    return router, servers


def stop_fleet(router, servers):
    for srv, _ in servers:
        srv.stop()
    router.stop()


def _wedge(session):
    """Park the engine between steps (it blocks on the generation lock
    before its next step); releasing the lock heals the replica."""
    session._gen_lock.acquire()
    return session._gen_lock


# -- dispatch -----------------------------------------------------------------


@pytest.mark.timeout(60)
def test_router_end_to_end_result_invisible(port_model, reference):
    from paddle_tpu_torch.serving import ServingClient

    router, servers = make_fleet(port_model, 2)
    try:
        c = ServingClient(router.address)
        out = c.generate(PROMPT, 8, timeout_s=30.0)
        assert out["done"] and out["tokens"] == reference["greedy"]
        out = c.generate(PROMPT, 8, timeout_s=30.0, **SAMPLED)
        assert out["tokens"] == reference["sampled"]
        st = c.stats()
        assert st["live_replicas"] == 2 and st["completed"] >= 2
        assert st["failovers"] == 0
        c.close()
    finally:
        stop_fleet(router, servers)


def test_fleet_choose_least_loaded():
    from paddle_tpu_torch.serving.fleet import FleetView

    fleet = FleetView(lease_s=30.0)
    a = fleet.register(("127.0.0.1", 1))
    b = fleet.register(("127.0.0.1", 2))
    assert fleet.choose().replica_id == a.replica_id  # idle tie -> index
    a.load = {"queue_depth": 3, "active_slots": 4, "max_slots": 4,
              "estimated_queue_wait_s": 0.5}
    b.load = {"queue_depth": 0, "active_slots": 1, "max_slots": 4,
              "estimated_queue_wait_s": 0.0}
    assert fleet.choose().replica_id == b.replica_id
    b.outstanding.update(range(8))  # the router's own books count too
    assert fleet.choose().replica_id == a.replica_id
    assert fleet.choose(exclude={a.replica_id}).replica_id == b.replica_id
    assert fleet.choose(exclude={a.replica_id, b.replica_id}) is None


@pytest.mark.timeout(60)
def test_fleet_wide_shed_tightest_hint_never_hangs(port_model):
    from paddle_tpu_torch.serving import QuotaExceeded
    from paddle_tpu_torch.serving.router import RouterServer

    router, servers = make_fleet(port_model, 2, session_kw={"max_queue": 0})
    try:
        with pytest.raises(QuotaExceeded) as ei:
            router.router.submit(PROMPT, 8)
        assert ei.value.reason == "overload"
        assert ei.value.retry_after_ms is not None
        assert ei.value.retry_after_ms >= 1
        assert router.router.shed == 1
        assert router.router.stats()["outstanding"] == 0
    finally:
        stop_fleet(router, servers)

    empty = RouterServer(lease_s=1.0).start()
    try:
        with pytest.raises(QuotaExceeded) as ei:
            empty.router.submit(PROMPT, 8)
        assert ei.value.reason == "overload"
        assert ei.value.retry_after_ms is not None
    finally:
        empty.stop()


# -- failover -----------------------------------------------------------------


@pytest.mark.timeout(60)
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_failover_replica_killed_mid_stream_token_identical(
    port_model, reference, sampled
):
    router, servers = make_fleet(
        port_model, 2, lease_s=1.0,
        session_kw={"engine_stall_timeout_s": 120.0},
    )
    try:
        lock = _wedge(servers[0][1])
        h = router.router.submit(PROMPT, 8, **(SAMPLED if sampled else {}))
        assert _wait(lambda: bool(h.assignments)), "must be assigned"
        victim_id = next(iter(h.assignments))
        assert router.fleet.get(victim_id).index == 0
        servers[0][0].kill()
        toks = h.result(timeout=30.0)
        lock.release()
        assert toks == reference["sampled" if sampled else "greedy"]
        assert h.failovers == 1
        assert h.delivered_by != victim_id
        assert router.router.failovers >= 1
    finally:
        servers[0][0].kill()
        servers[1][0].stop()
        router.stop()


@pytest.mark.timeout(60)
def test_late_winner_from_partitioned_replica_deduplicated(port_model, reference):
    from paddle_tpu_torch.obs import metrics as obs_metrics
    from paddle_tpu_torch.serving import ServingServer
    from paddle_tpu_torch.serving.router import RouterServer

    router = RouterServer(
        lease_s=0.8, poll_interval_s=0.02, late_grace_s=30.0
    ).start()
    sess_a = warm_session(make_session(port_model, engine_stall_timeout_s=120.0))
    sess_b = warm_session(make_session(port_model))
    srv_a = ServingServer(
        session=sess_a, router_endpoints=router.address, stall_fence_s=0.2
    ).start()
    srv_b = None
    try:
        assert _wait(lambda: len(router.fleet.live()) == 1)
        lock = _wedge(sess_a)
        h = router.router.submit(PROMPT, 8)
        assert _wait(lambda: bool(h.assignments))
        a_id = next(iter(h.assignments))
        srv_b = ServingServer(
            session=sess_b, router_endpoints=router.address,
            stall_fence_s=30.0,
        ).start()
        toks = h.result(timeout=30.0)
        assert toks == reference["greedy"]
        assert h.failovers == 1 and h.delivered_by != a_id
        assert router.fleet.get(a_id).state == "evicted"
        assert router.router.late_results_dropped == 0
        # heal: A completes the request the router already delivered from B
        lock.release()
        assert _wait(
            lambda: router.router.late_results_dropped == 1, timeout_s=20.0
        ), "the late winner must be dropped and counted"
        assert h.late_drops == 1
        assert h.tokens == reference["greedy"]
        snap = obs_metrics.snapshot()
        assert any(
            k.startswith("paddle_tpu_router_late_results_dropped_total")
            and v >= 1 for k, v in snap.items()
        )
        # the healed replica re-registers under a fresh lease
        assert _wait(
            lambda: any(
                r.state == "live" and r.replica_id != a_id
                and r.endpoint == router.fleet.get(a_id).endpoint
                for r in router.fleet.replicas()
            ), timeout_s=15.0,
        ), "a healed replica must rejoin under a fresh lease"
        # its takeover sweep maps the finished request for its new pump
        # too; that pump's sight of the same answer is not a second late
        # winner (the JAX package's router counts it twice: ROADMAP.md §3)
        rejoined = next(r for r in router.fleet.replicas()
                        if r.replica_id != a_id and r.endpoint == router.fleet.get(a_id).endpoint)
        assert _wait(lambda: not rejoined.rids, timeout_s=10.0)
        assert router.router.late_results_dropped == 1 and h.late_drops == 1
    finally:
        srv_a.stop()
        if srv_b is not None:
            srv_b.stop()
        router.stop()


@pytest.mark.timeout(60)
def test_unplaceable_requests_fail_named_not_hang(port_model):
    router, servers = make_fleet(
        port_model, 1, lease_s=0.6,
        session_kw={"engine_stall_timeout_s": 120.0},
        park_give_up_s=1.0,
    )
    try:
        _wedge(servers[0][1])
        h = router.router.submit(PROMPT, 8)
        assert _wait(lambda: bool(h.assignments))
        servers[0][0].kill()
        with pytest.raises(RuntimeError, match="replica_lost"):
            h.result(timeout=30.0)
        assert h.finish_reason == "replica_lost"
    finally:
        servers[0][0].kill()
        router.stop()


# -- hedging, drain, shed-retry, poll_many ---------------------------------------


@pytest.mark.timeout(60)
def test_hedge_first_token_wins_loser_cancelled(port_model, reference):
    router, servers = make_fleet(
        port_model, 2, lease_s=30.0, stall_fence_s=60.0,
        session_kw={"engine_stall_timeout_s": 120.0},
    )
    try:
        lock = _wedge(servers[0][1])
        h = router.router.submit(PROMPT, 8, hedge_ttft_s=0.2)
        assert _wait(lambda: bool(h.assignments))
        first = next(iter(h.assignments))
        assert router.fleet.get(first).index == 0
        toks = h.result(timeout=30.0)
        assert toks == reference["greedy"]
        assert h.hedged and router.router.hedges == 1
        assert h.delivered_by != first
        # the loser is cancelled on its replica while still wedged
        assert _wait(
            lambda: servers[0][1].scheduler.cancelled >= 1, timeout_s=15.0
        ), "hedge loser must be cancelled on its replica"
        lock.release()
        assert router.router.late_results_dropped == 0
    finally:
        stop_fleet(router, servers)


@pytest.mark.timeout(60)
def test_drain_stops_assignments_finishes_in_flight_deregisters(
    port_model, reference
):
    router, servers = make_fleet(port_model, 2, lease_s=5.0)
    try:
        a_id = next(
            r.replica_id for r in router.fleet.replicas() if r.index == 0
        )
        assert router.router.drain(a_id, deadline_s=30.0).get("ok")
        handles = [router.router.submit(PROMPT, 8) for _ in range(4)]
        for h in handles:
            assert h.result(timeout=30.0) == reference["greedy"]
            assert h.delivered_by != a_id, "draining replica must get nothing"
        assert _wait(
            lambda: router.fleet.get(a_id).state in ("drained", "closed"),
            timeout_s=15.0,
        )
        assert len(router.fleet.live()) == 1
        assert router.router.drains_completed == 1
        assert router.router.submit(PROMPT, 8).result(timeout=30.0) \
            == reference["greedy"]
    finally:
        stop_fleet(router, servers)


@pytest.mark.timeout(60)
def test_client_generate_honors_retry_after_ms(port_model):
    from paddle_tpu_torch.serving import Rejected, ServingClient, ServingServer

    s = make_session(port_model, max_queue=1)
    # hold the engine (serve_forever's idempotence guard) so the queue
    # stays full until the timer releases it
    s._thread = threading.Thread(target=lambda: None)
    srv = ServingServer(session=s).start()
    try:
        s.submit(PROMPT, 4)
        s.scheduler._ewma_service_s = 0.15
        c = ServingClient(srv.address)
        with pytest.raises(Rejected) as ei:
            c.generate(PROMPT, 4, max_retries=0)
        assert ei.value.retry_after_ms is not None
        assert c.shed_retries == 0

        def release():
            time.sleep(0.3)
            s._thread = None
            s.serve_forever()

        threading.Thread(target=release, daemon=True).start()
        out = c.generate(PROMPT, 4, max_retries=10, timeout_s=30.0)
        assert out["done"]
        assert c.shed_retries >= 1
        c.close()
    finally:
        srv.stop()


def test_poll_many_batches_and_scopes_tenancy(port_model):
    from paddle_tpu_torch.serving import ServingServer

    s = make_session(port_model)
    srv = ServingServer(session=s)
    try:
        r1 = srv.dispatch(
            "submit", {"prompt": PROMPT, "max_new_tokens": 4}, "t1"
        )["request_id"]
        r2 = srv.dispatch(
            "submit", {"prompt": PROMPT, "max_new_tokens": 4}, "t2"
        )["request_id"]
        s.run_until_idle()
        out = srv.dispatch("poll_many", {"items": [
            {"request_id": r1, "tenant_id": "t1"},
            {"request_id": r2, "tenant_id": "t1"},
            {"request_id": 999, "tenant_id": "t1"},
        ]}, None)["results"]
        assert out[0]["done"] and out[0]["tokens"]
        assert out[0]["request_id"] == r1
        assert out[1]["err"] == "tenant"
        assert out[2]["err"] == "unknown"
    finally:
        srv.stop()


# -- prefix affinity ------------------------------------------------------------


def _mk_fleet_view(n):
    from paddle_tpu_torch.serving.fleet import FleetView

    fv = FleetView(lease_s=30.0)
    reps = [fv.register(("127.0.0.1", 9000 + i)) for i in range(n)]
    for r in reps:
        r.load = {"max_slots": 4}
    return fv, reps


def test_fleet_choose_affinity_hint_semantics():
    from paddle_tpu_torch.serving.fleet import ReplicaState

    fv, (r0, r1) = _mk_fleet_view(2)
    assert fv.choose().replica_id == r0.replica_id
    assert fv.choose(prefer=r1.replica_id).replica_id == r1.replica_id
    r1.outstanding.add(1)  # 0.25 occupancy: exactly within the slack
    assert fv.choose(prefer=r1.replica_id).replica_id == r1.replica_id
    r1.load = {"max_slots": 4, "queue_depth": 2}
    assert fv.choose(prefer=r1.replica_id).replica_id == r0.replica_id
    r1.load = {"max_slots": 4}
    r1.outstanding.clear()
    r1.state = ReplicaState.EVICTED
    assert fv.choose(prefer=r1.replica_id).replica_id == r0.replica_id
    r1.state = ReplicaState.LIVE
    assert fv.choose(
        exclude={r1.replica_id}, prefer=r1.replica_id
    ).replica_id == r0.replica_id


def test_affinity_key_hashes_prompt_head_as_the_jax_package():
    from paddle_tpu.serving import router as jax_router
    from paddle_tpu_torch.serving.router import AFFINITY_HEAD, affinity_key

    assert AFFINITY_HEAD == jax_router.AFFINITY_HEAD
    a = affinity_key([1, 2, 3, 4])
    assert a == affinity_key([1, 2, 3, 4])
    assert a != affinity_key([9, 2, 3, 4])
    long = list(range(AFFINITY_HEAD)) + [50]
    assert affinity_key(long) == affinity_key(long[:-1] + [77])
    assert affinity_key([]) is None
    rng = np.random.RandomState(0)
    for n in (1, 4, 15, 16, 17, 40):
        p = rng.randint(0, 50257, n).tolist()
        assert affinity_key(p) == jax_router.affinity_key(p)


def test_affinity_warm_hit_rate_beats_pure_least_loaded():
    def run(affine):
        fv, _ = _mk_fleet_view(2)
        amap, last, inflight = {}, {}, []
        hits = total = 0
        used = set()
        for i in range(40):
            head = "A" if i % 2 == 0 else "B"
            rep = fv.choose(prefer=amap.get(head) if affine else None)
            if head in last:
                total += 1
                hits += rep.replica_id == last[head]
            last[head] = amap[head] = rep.replica_id
            used.add(rep.replica_id)
            rep.outstanding.add(i)
            inflight.append((rep, i))
            if len(inflight) > 2:
                old, rid = inflight.pop(0)
                old.outstanding.discard(rid)
        return hits / total, used

    warm_rate, warm_used = run(affine=True)
    cold_rate, _ = run(affine=False)
    assert warm_rate > cold_rate, (warm_rate, cold_rate)
    assert warm_rate >= 0.9
    assert len(warm_used) == 2


@pytest.mark.timeout(60)
def test_affinity_failover_when_affine_replica_dies(port_model, reference):
    from paddle_tpu_torch.serving import ServingClient

    router, servers = make_fleet(port_model, 2, lease_s=1.5)
    try:
        client = ServingClient(router.address)
        assert client.generate(PROMPT, 8)["tokens"] == reference["greedy"]
        aff = dict(router.router._affinity)
        assert len(aff) == 1
        affine_id = next(iter(aff.values()))
        rep = router.fleet.get(affine_id)
        victim = next(srv for srv, _ in servers
                      if srv.address[1] == rep.endpoint[1])
        victim.kill()
        assert _wait(lambda: len(router.fleet.live()) == 1), "eviction"
        assert client.generate(PROMPT, 8)["tokens"] == reference["greedy"]
        survivor = router.fleet.live()[0].replica_id
        assert router.router._affinity.get(next(iter(aff))) == survivor
        assert survivor != affine_id
        client.close()
    finally:
        stop_fleet(router, servers)


# -- mixed fleets: the wire between the two packages -----------------------------


def _jax_warm(sess):
    sess.submit(PROMPT, 4)
    sess.run_until_idle()
    sess.scheduler.reset_load_estimate()
    return sess


@pytest.mark.timeout(60)
@pytest.mark.parametrize("name", ["greedy", "sampled"])
@pytest.mark.parametrize("router_pkg", ["jax", "port"])
def test_mixed_fleet_fails_over_across_packages(port_model, jax_pair, reference,
                                                router_pkg, name):
    """One package's RouterServer in front of a replica of the other package
    (registered first, so the idle tie-break picks it) and one of its own:
    the first is wedged, takes the request and is killed; the request fails
    over to the second with the oracle's tokens."""
    from paddle_tpu.serving.router import RouterServer as JaxRouter
    from paddle_tpu.serving.server import ServingServer as JaxServer
    from paddle_tpu_torch.serving import ServingServer
    from paddle_tpu_torch.serving.router import RouterServer

    router = (JaxRouter if router_pkg == "jax" else RouterServer)(
        lease_s=1.0, poll_interval_s=0.02).start()

    def port_replica():
        sess = warm_session(make_session(port_model, engine_stall_timeout_s=120.0))
        return ServingServer(session=sess, router_endpoints=router.address), sess

    def jax_replica():
        sess = _jax_warm(jax_session(jax_pair, engine_stall_timeout_s=120.0))
        return JaxServer(session=sess, router_endpoints=router.address), sess

    makers = ((port_replica, jax_replica) if router_pkg == "jax"
              else (jax_replica, port_replica))
    servers = []
    try:
        for make in makers:
            srv, sess = make()
            servers.append((srv.start(), sess))
            assert _wait(lambda: len(router.fleet.live()) == len(servers))
        lock = _wedge(servers[0][1])
        h = router.router.submit(PROMPT, 8, **(SAMPLED if name == "sampled" else {}))
        assert _wait(lambda: bool(h.assignments))
        victim_id = next(iter(h.assignments))
        assert router.fleet.get(victim_id).endpoint == tuple(servers[0][0].address)
        servers[0][0].kill()
        assert h.result(timeout=30.0) == reference[name]
        assert h.failovers == 1 and h.delivered_by != victim_id
        lock.release()
    finally:
        for srv, _ in servers:
            srv.kill()
        router.stop()


# -- the hot-path RPC budget -------------------------------------------------------

# the Router methods on the dispatch, pump, reap and sweep paths
RPC_PATH = ("submit", "_try_assign", "_choose_replica", "_forward", "_pump_once",
            "_on_result", "_reap_once", "_failover_requests", "_send_cancels",
            "register_replica", "_sweep_replica")
RPC_ATTRS = ("call", "call_many", "call_stream")


def _replica_rpcs(path):
    """{method: [RPC names its blocking replica calls send]} over Router's
    RPC_PATH methods: every `.call(`, `.call_many(` and `.call_stream(` call,
    named by its first string argument (or, for a batch, each tuple's)."""
    tree = ast.parse(pathlib.Path(path).read_text())
    cls = next(n for n in ast.walk(tree)
               if isinstance(n, ast.ClassDef) and n.name == "Router")
    out = {}
    for fn in cls.body:
        if not isinstance(fn, ast.FunctionDef) or fn.name not in RPC_PATH:
            continue
        names = []
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in RPC_ATTRS):
                consts = [c.value for c in ast.walk(node.args[0])
                          if isinstance(c, ast.Constant) and isinstance(c.value, str)]
                names.append(consts[0] if consts else "?")
        out[fn.name] = names
    return out


def test_router_hot_path_rpc_budget_matches_the_jax_package():
    """Dispatch decisions read piggybacked state only: the named methods
    make exactly the JAX package's blocking replica RPCs — the submit
    forward, the pump's batch poll, the batched cancel order and the
    once-per-registration sweep — and no health probe."""
    port = _replica_rpcs(REPO / "paddle_tpu_torch" / "serving" / "router.py")
    ref = _replica_rpcs(REPO / "paddle_tpu" / "serving" / "router.py")
    assert set(port) == set(RPC_PATH) == set(ref)
    assert port == ref
    assert port["_forward"] == ["submit"]
    assert port["_pump_once"] == ["poll_many"]
    assert port["_send_cancels"] == ["cancel"]
    assert port["_sweep_replica"] == ["outstanding"]
    assert sum(map(len, port.values())) == 4
    for fn in ("submit", "_try_assign", "_choose_replica", "_on_result",
               "_reap_once", "_failover_requests", "register_replica"):
        assert port[fn] == [], fn


def test_router_metrics_share_the_jax_packages_names():
    from paddle_tpu.obs import metrics as jax_metrics
    from paddle_tpu_torch.obs import metrics

    calls = (("observe_takeover", ("router",)),
             ("observe_replica_evicted", ("lease",)),
             ("observe_replica_failover", ("lease",)),
             ("observe_router_hedge", ()),
             ("observe_late_result_dropped", ()),
             ("observe_router_shed", ("overload",)))
    for name, args in calls:
        getattr(metrics, name)(*args)
        getattr(jax_metrics, name)(*args)
    port = {k.split("{")[0] for k in metrics.snapshot()}
    ref = {k.split("{")[0] for k in jax_metrics.snapshot()}
    fleet = {k for k in ref if "router" in k or "takeover" in k}
    assert len(fleet) == 6 and fleet <= port
    text = metrics.to_prometheus_text()
    assert 'paddle_tpu_takeovers_total{plane="router"}' in text
    assert 'paddle_tpu_router_shed_total{reason="overload"}' in text


# -- the CLI ------------------------------------------------------------------------


def _spawn(args):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.Popen([sys.executable, "-m", *args], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _first_json(proc):
    line = proc.stdout.readline()
    assert line, proc.stderr.read()
    return json.loads(line)


@pytest.mark.timeout(90)
def test_cli_router_and_replica_processes_join_answer_and_stop():
    from paddle_tpu_torch.serving import ServingClient

    router = _spawn(["paddle_tpu_torch.serving.router", "serve", "--lease_s", "2"])
    replica = None
    try:
        hello = _first_json(router)
        assert hello["role"] == "router"
        host, port = hello["address"]
        replica = _spawn(["paddle_tpu_torch", "serve", "--demo", "--device", "cpu",
                          "--router_endpoints", f"{host}:{port}",
                          "--stall_fence_s", "30"])
        served = _first_json(replica)
        assert served["role"] == "serve"
        c = ServingClient((host, port), timeout=10.0)
        assert _wait(lambda: c.stats()["live_replicas"] == 1, 30.0)
        direct = ServingClient(tuple(served["address"]))
        via = c.generate(PROMPT, 6, timeout_s=30.0)
        assert via["done"] and via["tokens"] == direct.generate(PROMPT, 6)["tokens"]
        direct.close()
        replica.terminate()  # SIGTERM: a clean leave deregisters
        assert replica.wait(30) == 0
        assert "final_stats" in replica.stdout.read()
        assert _wait(lambda: c.stats()["live_replicas"] == 0, 10.0)
        c.close()
        router.terminate()
        assert router.wait(30) == 0
    finally:
        for p in (router, replica):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait(10)


def test_cli_autoscale_flags_name_item_7b(tmp_path):
    """Item 7b is ported: `serve --autoscale` runs the controller beside
    the router instead of naming the item. Its first line reports
    `"autoscale": true`; the controller observes the router and a master
    (seeded with `initial_world`) every tick, lends the idle chip to
    training through one resize epoch, and on SIGTERM the router prints the
    controller's final stats."""
    import json
    import signal
    import subprocess
    import sys

    from paddle_tpu_torch.runtime.master import MasterServer, TaskMaster

    master = MasterServer(TaskMaster(), initial_world=1).start()
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.router", "serve",
         "--autoscale", "--autoscale_master", "%s:%d" % master.address,
         "--autoscale_tick_s", "0.05", "--autoscale_chips", "2",
         "--autoscale_config", json.dumps({"startup_quiet_s": 0.0}),
         "--autoscale_spawn_log_dir", str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    try:
        first = json.loads(proc.stdout.readline())
        assert first["role"] == "router" and first["autoscale"] is True
        time.sleep(1.0)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
        assert proc.returncode == 0
        final = json.loads(out.strip().splitlines()[-1])["autoscaler"]
        assert final["ticks"] >= 2 and final["observe_failures"] == 0, final
        # an idle fleet with no replica: the free chip goes to training,
        # once (the epoch has no member to drain, so it settles at once)
        assert final["actions"] == ["resize:2"] and not final["dead"], final
        st = master.resize.info()
        assert st["state"] == "idle" and st["completed"] == 1 and st["world"] == 2
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
        master.stop()


# -- on the card ----------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.timeout(120)
def test_cuda_fleet_fails_over_token_identical():
    """Replicas on the card at the small LM behind the port's router: the
    replica the idle tie-break picks is wedged, takes a greedy request and
    is killed; then, with a fresh replica joined, the same for a sampled
    request. Each fails over with the tokens of a direct session on the
    card and on the CPU; the last survivor's decode kernel launches are its
    decode steps x n_layers, and no page leaks."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import ServingServer, make_demo_session
    from paddle_tpu_torch.serving.router import RouterServer

    kw = dict(CFG, **SESSION, prefill_chunk=8)
    want = {}
    for dev in ("cuda", "cpu"):
        s = make_demo_session(**kw, device=dev)
        hs = [s.submit(PROMPT, 8), s.submit(PROMPT, 8, **SAMPLED)]
        s.run_until_idle()
        want[dev] = [h.tokens for h in hs]
    assert want["cuda"] == want["cpu"]
    router = RouterServer(lease_s=1.0, poll_interval_s=0.01).start()
    servers = []

    def join():
        sess = warm_session(make_demo_session(**kw, engine_stall_timeout_s=120.0,
                                              device="cuda"))
        servers.append((ServingServer(sess, router_endpoints=router.address).start(),
                        sess))
        assert _wait(lambda: len(router.fleet.live()) == min(2, len(servers)))

    try:
        join()
        got = []
        for i, sampling in enumerate(({}, SAMPLED)):
            join()
            srv, sess = servers[i]  # the live replica of the lowest index
            lock = _wedge(sess)
            h = router.router.submit(PROMPT, 8, **sampling)
            assert _wait(lambda: bool(h.assignments))
            assert router.fleet.get(next(iter(h.assignments))).endpoint == \
                tuple(srv.address)
            survivor = servers[i + 1][1]
            steps0, launches0 = survivor.decode_steps, pa.LAUNCHES
            srv.kill()
            got.append(h.result(timeout=60.0))
            # read before the wedge heals: the killed replica's engine may
            # still take one step on its way out
            assert (pa.LAUNCHES - launches0
                    == (survivor.decode_steps - steps0) * CFG["n_layers"])
            lock.release()
            assert h.failovers == 1
        assert got == want["cuda"]
        assert _wait(lambda: servers[-1][1].cache.pages_in_use == 0, 10.0)
    finally:
        for srv, _ in servers:
            srv.kill()
        router.stop()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_cancelled_copy_of_a_dropped_assignment_is_not_the_answer(pkg):
    """A replica copy the router no longer counts on reports `cancelled`
    (the healed replica's sweep mapped it again, the survivor's first token
    cancelled it as a hedge loser, and the evicted registration's pump still
    polls it): the port's router keeps the request running on its live
    assignment; the JAX package's delivers the cancellation (ROADMAP.md §3)."""
    if pkg == "jax":
        from paddle_tpu.serving.fleet import ReplicaState
        from paddle_tpu.serving.router import Router, RouterHandle
    else:
        from paddle_tpu_torch.serving.fleet import ReplicaState
        from paddle_tpu_torch.serving.router import Router, RouterHandle

    r = Router(lease_s=30.0)
    old = r.fleet.register(("127.0.0.1", 1))
    live = r.fleet.register(("127.0.0.1", 2))
    old.state = ReplicaState.EVICTED
    h = RouterHandle(0, "default", PROMPT, 8, "k", seed=0, now=time.monotonic())
    h._router = r
    r._handles[0] = h
    h.assignments[live.replica_id] = 5
    live.rids[0] = 5
    live.outstanding.add(0)
    old.rids[0] = 7
    r._on_result(old, 0, {"request_id": 7, "done": True, "cancelled": True,
                          "finish_reason": "cancelled", "tokens": [3]},
                 time.monotonic())
    if pkg == "jax":
        assert h.done and h.finish_reason == "cancelled"
        return
    assert not h.done and h.assignments == {live.replica_id: 5} and not old.rids
    r._on_result(live, 0, {"request_id": 5, "done": True, "finish_reason": "length",
                           "tokens": list(range(8))}, time.monotonic())
    assert h.done and h.status == h.DONE and h.tokens == list(range(8))
    assert r.late_results_dropped == 0


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_a_dropped_copys_tokens_do_not_cancel_the_live_assignments(pkg):
    """The evicted registration's pump sees its copy's first tokens while
    the request runs on two live assignments (a hedge, or a survivor and
    the healed replica's re-adopted copy): the port's router grows the
    mirror and keeps both; the JAX package's makes the dropped copy the
    winner and cancels every assignment it counts on (ROADMAP.md §3)."""
    if pkg == "jax":
        from paddle_tpu.serving.fleet import ReplicaState
        from paddle_tpu.serving.router import Router, RouterHandle
    else:
        from paddle_tpu_torch.serving.fleet import ReplicaState
        from paddle_tpu_torch.serving.router import Router, RouterHandle

    r = Router(lease_s=30.0, replica_client_kw={"timeout": 0.5, "retries": 1})
    old = r.fleet.register(("127.0.0.1", 1))
    a = r.fleet.register(("127.0.0.1", 2))
    b = r.fleet.register(("127.0.0.1", 3))
    old.state = ReplicaState.EVICTED
    h = RouterHandle(0, "default", PROMPT, 8, "k", seed=0, now=time.monotonic())
    h._router = r
    r._handles[0] = h
    h.assignments.update({a.replica_id: 5, b.replica_id: 6})
    a.rids[0], b.rids[0], old.rids[0] = 5, 6, 7
    r._on_result(old, 0, {"request_id": 7, "done": False, "tokens": [3, 4],
                          "from": 0, "tokens_so_far": 2}, time.monotonic())
    assert h.tokens == [3, 4]
    if pkg == "jax":
        assert h.assignments == {}
        return
    assert h.assignments == {a.replica_id: 5, b.replica_id: 6}
    assert a.rids == {0: 5} and b.rids == {0: 6}
