"""The port's router HA (`paddle_tpu_torch/runtime/election.py`, the router's
takeover sweep, the replica agent's fencing), held against the JAX package:
the twins of the router and agent tests of tests/test_ha.py.

  * election — one watch / strike / confirm loop: a dead primary is
    confirmed before takeover, a live one is never usurped, and stop() /
    max_wait_s end a watch with no takeover;
  * takeover sweep — a freshly elected router rebuilds its in-flight and
    dedup books from each re-registering replica's `outstanding` reply
    (original keys and pinned seeds), so polls resolve by key, results
    deliver exactly once, and a second failure re-executes token-identically
    or fails named (`replica_lost`);
  * agent fencing — control hints are honoured only from the router
    incarnation the agent registered with, unless that one is provably gone;
  * client self-healing — ServingClient carries an endpoint list; generate
    re-submits under the same key and pinned seed when a new router forgot
    its request id, and stream() reattaches at the delivered-token cursor;
  * the CLI standby role exits 3 when the primary stays alive.

Every token list is held to a direct JAX `ServingSession` (greedy and
seed-77 sampled) on the same parameters, moved across by name."""

import json
import os
import pathlib
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from paddle_tpu_torch.core.stats import FT_EVENTS
from paddle_tpu_torch.serving import ServableLM, ServingSession
from paddle_tpu_torch.serving.convert import params_from_jax
from paddle_tpu_torch.serving.model import LMConfig

pytestmark = [pytest.mark.serving, pytest.mark.chaos, pytest.mark.ha]

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


def _free_port() -> int:
    """Reserve a port for a standby that binds it only at takeover."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


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


@pytest.fixture(scope="module")
def reference(jax_pair):
    """Oracle tokens from a direct JAX session: greedy and sampled."""
    from paddle_tpu.serving.session import ServingSession as JaxSession

    jm, jp = jax_pair
    s = JaxSession(jm, jp, **SESSION)
    greedy = s.submit(PROMPT, 8)
    sampled = s.submit(PROMPT, 8, **SAMPLED)
    s.run_until_idle()
    return {"greedy": greedy.tokens, "sampled": sampled.tokens}


def make_session(port_model, **kw):
    return ServingSession(port_model, device="cpu", **{**SESSION, **kw})


def warm_session(sess):
    sess.submit(PROMPT, 4)
    sess.run_until_idle()
    sess.scheduler.reset_load_estimate()
    return sess


# -- election primitive -------------------------------------------------------


@pytest.mark.timeout(30)
def test_watcher_takes_over_only_when_primary_dies():
    from paddle_tpu_torch.runtime.election import StandbyWatcher

    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(4)
    w = StandbyWatcher(lst.getsockname(), plane="router", poll_s=0.05)
    before = FT_EVENTS.get("router_takeover")
    box = {}
    t = threading.Thread(target=lambda: box.update(token=w.wait_for_takeover()),
                         daemon=True)
    t.start()
    time.sleep(0.5)
    assert t.is_alive(), "a live primary must never be usurped"
    assert w.misses == 0.0 and w.probes >= 3
    lst.close()
    t.join(timeout=20.0)
    assert not t.is_alive()
    assert isinstance(box["token"], str) and len(box["token"]) == 8
    assert FT_EVENTS.get("router_takeover") == before + 1


@pytest.mark.timeout(30)
def test_watcher_stop_and_max_wait_end_without_takeover():
    from paddle_tpu_torch.runtime.election import StandbyWatcher, watch_primary

    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(4)
    try:
        assert watch_primary(lst.getsockname(), plane="router", poll_s=0.05,
                             max_wait_s=0.3) is None
        w = StandbyWatcher(("127.0.0.1", _free_port()), plane="router",
                           poll_s=0.05)
        w.stop()
        assert w.wait_for_takeover() is None
    finally:
        lst.close()


def test_instance_tokens_are_per_incarnation():
    from paddle_tpu_torch.runtime.election import mint_instance_token

    a, b = mint_instance_token(), mint_instance_token()
    assert a != b and len(a) == len(b) == 8


# -- replica agent: rotation and instance-token fencing (no sockets) -------------


def _bare_agent(n_eps=2):
    from paddle_tpu_torch.serving.fleet import ReplicaAgent

    agent = ReplicaAgent(
        [("127.0.0.1", 1), ("127.0.0.1", 2)][:n_eps], session=None,
        advertise=("127.0.0.1", 9),
    )
    calls = []
    agent._register = lambda: calls.append("register") or True
    agent.replica_id = "r-0"
    agent.router_instance = "aaaa0000"
    agent._reg_ep = 0
    return agent, calls


def test_agent_honors_hint_from_own_incarnation():
    agent, calls = _bare_agent()
    out = agent._handle_reply(
        {"ok": False, "reregister": True, "instance": "aaaa0000"})
    assert out is None and calls == ["register"]
    assert agent.replica_id is None and agent.stale_replies == 0


def test_agent_fences_stale_foreign_reply_and_goes_home():
    agent, calls = _bare_agent()
    agent._cur = 1
    agent._conn_failures = 0
    before = FT_EVENTS.get("replica_stale_router_reply")
    out = agent._handle_reply(
        {"ok": False, "reregister": True, "instance": "bbbb1111"})
    assert out is None and calls == []
    assert agent.replica_id == "r-0", "stale hint must not drop the lease"
    assert agent.stale_replies == 1
    assert FT_EVENTS.get("replica_stale_router_reply") == before + 1
    assert agent._cur == agent._reg_ep, "fenced agent rotates back home"


def test_agent_honors_foreign_reply_when_home_rebound():
    agent, calls = _bare_agent()
    agent._cur = agent._reg_ep = 0
    agent._handle_reply({"ok": False, "reregister": True, "instance": "cccc2222"})
    assert calls == ["register"] and agent.replica_id is None


def test_agent_honors_foreign_reply_when_home_unreachable():
    agent, calls = _bare_agent()
    agent._cur = 1
    agent._conn_failures = agent.ROTATE_AFTER
    agent._handle_reply({"ok": False, "reregister": True, "instance": "dddd3333"})
    assert calls == ["register"] and agent.replica_id is None


def test_agent_rotates_after_threshold_only_when_registered():
    agent, _ = _bare_agent()
    agent._note_conn_failure()
    assert agent.rotations == 0 and agent._cur == 0
    agent._note_conn_failure()
    assert agent.rotations == 1 and agent._cur == 1
    fresh, _ = _bare_agent()
    fresh.replica_id = None
    fresh._note_conn_failure()
    assert fresh.rotations == 1


def test_agent_single_endpoint_rotation_is_a_noop():
    agent, _ = _bare_agent(n_eps=1)
    agent._note_conn_failure()
    agent._note_conn_failure()
    assert agent.rotations == 0 and agent._cur == 0


# -- the sweep source: the replica's `outstanding` reply ----------------------


@pytest.mark.timeout(60)
def test_outstanding_reports_resubmission_identity(port_model):
    from paddle_tpu_torch.runtime.master import MasterClient
    from paddle_tpu_torch.serving import ServingClient, ServingServer

    sess = warm_session(make_session(port_model))
    srv = ServingServer(session=sess).start()
    client = ServingClient(srv.address)
    probe = MasterClient(srv.address)
    try:
        with sess._gen_lock:  # wedge: the request stays in flight
            rid = client.submit(PROMPT, 6, client_req_id="k-ha-1", **SAMPLED)
            items = probe.call("outstanding")["requests"]
            (item,) = [i for i in items if i["client_req_id"] == "k-ha-1"]
            assert item["request_id"] == rid
            assert item["prompt"] == PROMPT, "the sweep needs the prompt back"
            assert item["seed"] == 77 and item["max_new_tokens"] == 6
            assert item["temperature"] == pytest.approx(0.8)
            assert item["top_k"] == 8
            assert not item["done"]
        assert _wait(lambda: client.poll(rid).get("done"), 30.0)
        done = [i for i in probe.call("outstanding")["requests"]
                if i["client_req_id"] == "k-ha-1"]
        assert done and done[0]["done"] and done[0]["tokens_so_far"] == 6
    finally:
        probe.close()
        client.close()
        srv.stop()


@pytest.mark.timeout(60)
def test_outstanding_replies_equal_the_jax_servers(port_model, jax_pair):
    """The sweep's wire: the port's `outstanding` reply has the JAX server's
    keys and values for the same wedged requests (request ids aside)."""
    from paddle_tpu.serving.server import ServingServer as JaxServer
    from paddle_tpu.serving.session import ServingSession as JaxSession
    from paddle_tpu_torch.runtime.master import MasterClient
    from paddle_tpu_torch.serving import ServingServer

    jm, jp = jax_pair
    replies = []
    for srv in (ServingServer(session=make_session(port_model)),
                JaxServer(session=JaxSession(jm, jp, **SESSION))):
        sess = srv.session
        srv.start()
        probe = MasterClient(srv.address)
        try:
            with sess._gen_lock:
                probe.call("submit", prompt=PROMPT, max_new_tokens=6,
                           client_req_id="k", **SAMPLED)
                probe.call("submit", prompt=PROMPT[:2], max_new_tokens=4,
                           client_req_id="g", tenant_id="t1")
                replies.append(sorted(probe.call("outstanding")["requests"],
                                      key=lambda i: i["client_req_id"]))
        finally:
            probe.close()
            srv.stop()
    for item in replies[0] + replies[1]:
        item.pop("request_id")
    assert replies[0] == replies[1]


# -- takeover sweep: a fresh router adopts replica state ----------------------


@pytest.mark.timeout(60)
def test_fresh_router_sweep_adopts_and_delivers(port_model, reference):
    from paddle_tpu_torch.serving import ServingClient, ServingServer
    from paddle_tpu_torch.serving.router import RouterServer

    sess = warm_session(make_session(port_model))
    srv = ServingServer(session=sess).start()
    direct = ServingClient(srv.address)
    router = RouterServer(lease_s=3.0).start()
    try:
        with sess._gen_lock:
            direct.submit(PROMPT, 8, client_req_id="k-greedy")
            direct.submit(PROMPT, 8, client_req_id="k-sampled", **SAMPLED)
            router.router.register_replica(list(srv.address))
            assert router.router.adopted == 2
            hg = router.router.get_by_key("default", "k-greedy")
            hs = router.router.get_by_key("default", "k-sampled")
            assert hg is not None and hs is not None
            assert hs.seed == 77 and hs.top_k == 8
            assert hs.temperature == pytest.approx(0.8)
            assert not hg.done
        assert hg.result(timeout=30.0) == reference["greedy"]
        assert hs.result(timeout=30.0) == reference["sampled"]
        via = ServingClient(router.address)
        resp = via.poll(999_999, client_req_id="k-sampled")
        assert resp["done"] and resp["tokens"] == reference["sampled"]
        via.close()
        assert router.router.stats()["adopted_requests"] == 2
    finally:
        direct.close()
        srv.stop()
        router.stop()


@pytest.mark.timeout(60)
def test_adopted_request_fails_named_when_its_replica_dies(port_model):
    from paddle_tpu_torch.serving import FinishReason, ServingClient, ServingServer
    from paddle_tpu_torch.serving.router import RouterServer

    sess = warm_session(make_session(port_model))
    srv = ServingServer(session=sess).start()
    direct = ServingClient(srv.address)
    router = RouterServer(
        lease_s=1.0, park_give_up_s=1.0, poll_interval_s=0.02,
        replica_client_kw={"timeout": 2.0, "retries": 1},
    ).start()
    gate = sess._gen_lock
    gate.acquire()
    try:
        direct.submit(PROMPT, 8, client_req_id="k-doomed")
        router.router.register_replica(list(srv.address))
        h = router.router.get_by_key("default", "k-doomed")
        assert h is not None and not h.done
        srv.kill()  # the only holder dies, still wedged
        assert _wait(lambda: h.done, 30.0), "parked request must expire"
        assert h.finish_reason == FinishReason.REPLICA_LOST
        with pytest.raises(RuntimeError, match="replica_lost"):
            h.result(timeout=1.0)
    finally:
        gate.release()
        direct.close()
        router.stop()


# -- end to end: router killed mid-flight, standby takes over -----------------


def _ha_fleet(port_model, n, lease_s=2.0, **router_kw):
    """A primary RouterServer, an armed RouterStandby watching it from a
    reserved port, and n replicas carrying both endpoints."""
    from paddle_tpu_torch.serving import ServingServer
    from paddle_tpu_torch.serving.router import RouterServer
    from paddle_tpu_torch.serving.router import RouterStandby

    router_kw.setdefault("poll_interval_s", 0.02)
    primary = RouterServer(lease_s=lease_s, **router_kw).start()
    sb_port = _free_port()
    box = {}
    standby = RouterStandby(primary.address, port=sb_port, poll_s=0.1,
                            lease_s=lease_s, **router_kw)
    threading.Thread(target=lambda: box.update(srv=standby.run()),
                     daemon=True).start()
    endpoints = [list(primary.address), ["127.0.0.1", sb_port]]
    servers = []
    for _ in range(n):
        sess = warm_session(make_session(port_model))
        srv = ServingServer(session=sess, router_endpoints=endpoints,
                            stall_fence_s=30.0).start()
        servers.append((srv, sess))
    assert _wait(lambda: len(primary.fleet.live()) == n), "replicas must join"
    return primary, box, endpoints, servers


def _teardown(servers, box):
    for srv, _ in servers:
        srv.stop()
    if box.get("srv") is not None:
        box["srv"].stop()


@pytest.mark.timeout(60)
def test_router_takeover_reconciles_inflight(port_model, reference):
    from paddle_tpu_torch.serving import ServingClient

    primary, box, endpoints, servers = _ha_fleet(port_model, 2)
    gates = [sess._gen_lock for _, sess in servers]
    for g in gates:
        g.acquire()
    released = False
    results = {}

    def gen(name, **kw):
        c = ServingClient(endpoints, timeout=3.0)  # one client per thread
        try:
            results[name] = c.generate(PROMPT, 8, timeout_s=60.0, **kw)
        finally:
            c.close()

    threads = [threading.Thread(target=gen, args=("greedy",), daemon=True),
               threading.Thread(target=gen, args=("sampled",), kwargs=SAMPLED,
                                daemon=True)]
    try:
        before = FT_EVENTS.get("router_takeover")
        for t in threads:
            t.start()
        assert _wait(lambda: sum(
            len(srv.dispatch("outstanding", {}, None)["requests"])
            for srv, _ in servers) >= 2, 30.0)
        primary.kill()
        assert _wait(lambda: box.get("srv") is not None, 30.0), \
            "standby must take over"
        new = box["srv"]
        assert FT_EVENTS.get("router_takeover") == before + 1
        assert _wait(lambda: len(new.fleet.live()) == 2, 30.0)
        assert _wait(lambda: new.router.adopted >= 1, 30.0)
        for g in gates:
            g.release()
        released = True
        for t in threads:
            t.join(timeout=60.0)
            assert not t.is_alive()
        assert results["greedy"]["tokens"] == reference["greedy"]
        assert results["sampled"]["tokens"] == reference["sampled"]
        assert new.router.completed >= 1
    finally:
        if not released:
            for g in gates:
                g.release()
        _teardown(servers, box)


@pytest.mark.timeout(60)
def test_exactly_once_across_router_and_replica_death(port_model, reference):
    from paddle_tpu_torch.serving import ServingClient

    primary, box, endpoints, servers = _ha_fleet(port_model, 2)
    gates = {id(sess): sess._gen_lock for _, sess in servers}
    for g in gates.values():
        g.acquire()
    released = set()
    results = {}

    def gen(name, **kw):
        c = ServingClient(endpoints, timeout=3.0)
        try:
            results[name] = c.generate(PROMPT, 8, timeout_s=60.0, **kw)
        finally:
            c.close()

    threads = [threading.Thread(target=gen, args=("greedy",), daemon=True),
               threading.Thread(target=gen, args=("sampled",), kwargs=SAMPLED,
                                daemon=True)]
    try:
        for t in threads:
            t.start()
        assert _wait(lambda: sum(
            len(srv.dispatch("outstanding", {}, None)["requests"])
            for srv, _ in servers) >= 2, 30.0)
        primary.kill()
        assert _wait(lambda: box.get("srv") is not None, 30.0)
        new = box["srv"]
        assert _wait(lambda: len(new.fleet.live()) == 2, 30.0)
        assert _wait(lambda: new.router.adopted >= 1, 30.0)
        # kill whichever replica holds adopted work, still wedged
        with new.router._lock:
            held = {rep_id for h in new.router._handles.values() if not h.done
                    for rep_id in h.assignments}
        victim_idx = next(
            i for i, (srv, _) in enumerate(servers)
            for r in new.fleet.replicas()
            if r.replica_id in held and tuple(r.endpoint) == tuple(srv.address)
        )
        servers[victim_idx][0].kill()
        for i, (_, sess) in enumerate(servers):
            if i != victim_idx:
                gates[id(sess)].release()
                released.add(id(sess))
        for t in threads:
            t.join(timeout=60.0)
            assert not t.is_alive()
        assert results["greedy"]["tokens"] == reference["greedy"]
        assert results["sampled"]["tokens"] == reference["sampled"]
    finally:
        for _, sess in servers:
            if id(sess) not in released:
                gates[id(sess)].release()
        _teardown(servers, box)


@pytest.mark.timeout(60)
def test_stream_reattaches_by_cursor_across_takeover(port_model, reference):
    from paddle_tpu_torch.serving import ServingClient

    primary, box, endpoints, servers = _ha_fleet(port_model, 1)
    client = ServingClient(endpoints, timeout=3.0)
    srv0, sess0 = servers[0]
    gate = sess0._gen_lock
    gate.acquire()  # the stream must still be mid-flight at the kill
    released = False
    got, err = [], []
    done_evt = threading.Event()

    def consume():
        try:
            for frame in client.stream(PROMPT, 8, reattach_retries=30):
                got.extend(frame["tokens"])
                if frame.get("done"):
                    break
        except Exception as e:  # surfaced by the main thread's assert
            err.append(e)
        finally:
            done_evt.set()

    try:
        threading.Thread(target=consume, daemon=True).start()
        assert _wait(lambda: len(
            srv0.dispatch("outstanding", {}, None)["requests"]) >= 1, 30.0)
        primary.kill()
        assert _wait(lambda: box.get("srv") is not None, 30.0)
        assert _wait(lambda: len(box["srv"].fleet.live()) == 1, 30.0)
        gate.release()
        released = True
        assert done_evt.wait(60.0), "stream consumer must finish"
        assert not err, f"stream consumer raised: {err!r}"
        assert got == reference["greedy"], \
            "a reattached stream delivers every token exactly once"
        assert client.stream_reattaches >= 1
    finally:
        if not released:
            gate.release()
        client.close()
        _teardown(servers, box)


# -- client endpoint lists ----------------------------------------------------


@pytest.mark.timeout(60)
def test_client_endpoint_list_fails_over(port_model, reference):
    from paddle_tpu_torch.serving import ServingClient, ServingServer

    srv = ServingServer(session=warm_session(make_session(port_model))).start()
    client = ServingClient([("127.0.0.1", _free_port()), tuple(srv.address)],
                           timeout=2.0)
    try:
        assert client.generate(PROMPT, 8)["tokens"] == reference["greedy"]
    finally:
        client.close()
        srv.stop()


# -- the CLI standby role -------------------------------------------------------


@pytest.mark.timeout(60)
def test_cli_standby_role_exits_3_without_takeover():
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(4)
    primary = "127.0.0.1:%d" % lst.getsockname()[1]
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.serving.router", "standby",
             "--primary", primary, "--max_wait_s", "1.0", "--poll_s", "0.2"],
            capture_output=True, text=True, timeout=60, cwd=REPO,
            env=dict(os.environ, PYTHONPATH=str(REPO)),
        )
        assert proc.returncode == 3, proc.stderr
        assert json.loads(proc.stdout.strip().splitlines()[-1])["takeover"] is False
    finally:
        lst.close()
