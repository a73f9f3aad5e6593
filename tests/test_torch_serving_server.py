"""The port's ServingServer and ServingClient, and the wire between the two
packages.

  * tenancy — register/heartbeat leases; a fabricated tenant id does not
    pass `require_register`; a lapsed lease evicts the tenant and cancels
    its QUEUED requests; idempotency keys reattach a resent submit;
  * quotas — rejections reach the client as `Rejected` naming the reason;
  * streaming — push frames carry deltas from the client's cursor, a
    reattach resumes mid-request, delta polls reassemble the full list;
  * `generate_config` on a server without a generation session answers
    a named error (its generation: tests/test_torch_generation_serving.py);
  * the wire both ways — the JAX package's `ServingClient` gets from the
    port's `ServingServer` the greedy tokens the JAX server gives it, and
    the port's client gets them from the JAX server, on the framed and the
    legacy line-JSON wire (same parameters, moved across by name; ids in
    [0, vocab), which the port enforces where the reference clamps).

Every server binds 127.0.0.1 port 0; every test carries a timeout."""

import threading
import time

import numpy as np
import pytest

from paddle_tpu_torch.serving import (
    Rejected,
    ServableLM,
    ServingClient,
    ServingServer,
    ServingSession,
)
from paddle_tpu_torch.serving.convert import params_from_jax
from paddle_tpu_torch.serving.model import LMConfig

pytestmark = [pytest.mark.serving, pytest.mark.timeout(60)]

CFG = dict(vocab=96, n_layers=2, d_model=32, n_heads=2, max_len=96)
SESSION = dict(max_slots=4, page_size=8, prefill_buckets=(8, 16, 32),
               max_new_limit=16)
PROMPTS = [
    [1, 5, 9, 11],
    [1, 7],
    [1, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14],
    [1, 40, 41, 42, 43, 44, 45, 46],
]


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


def make_session(port_model, **kw):
    return ServingSession(port_model, device="cpu", **{**SESSION, **kw})


@pytest.fixture(scope="module")
def port_server(port_model):
    srv = ServingServer(make_session(port_model), port=0).start()
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def jax_server(jax_pair):
    from paddle_tpu.serving.server import ServingServer as JaxServer
    from paddle_tpu.serving.session import ServingSession as JaxSession

    jm, jp = jax_pair
    srv = JaxServer(session=JaxSession(jm, jp, **SESSION)).start()
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def jax_tokens(jax_server):
    """Greedy tokens the JAX client gets from the JAX server."""
    from paddle_tpu.serving.server import ServingClient as JaxClient

    c = JaxClient(jax_server.address)
    try:
        return [c.generate(p, 8, timeout_s=30.0)["tokens"] for p in PROMPTS]
    finally:
        c.close()


# -- the wire both ways -------------------------------------------------------------


@pytest.mark.parametrize("wire", ["frames", "json"])
def test_jax_client_against_port_server(port_server, jax_tokens, wire):
    from paddle_tpu.serving.server import ServingClient as JaxClient

    c = JaxClient(port_server.address, wire=wire)
    try:
        got = [c.generate(p, 8, timeout_s=30.0)["tokens"] for p in PROMPTS]
        assert got == jax_tokens
        assert c.wire_framed == (wire == "frames")
        streamed = [t for fr in c.stream(PROMPTS[0], 8) for t in fr["tokens"]]
        assert streamed == jax_tokens[0]
    finally:
        c.close()


@pytest.mark.parametrize("wire", ["frames", "json"])
def test_port_client_against_jax_server(jax_server, jax_tokens, wire):
    c = ServingClient(jax_server.address, wire=wire)
    try:
        got = [c.generate(p, 8, timeout_s=30.0)["tokens"] for p in PROMPTS]
        assert got == jax_tokens
        assert c.wire_framed == (wire == "frames")
        streamed = [t for fr in c.stream(PROMPTS[0], 8) for t in fr["tokens"]]
        assert streamed == jax_tokens[0]
    finally:
        c.close()


@pytest.mark.parametrize("wire", ["frames", "json"])
def test_port_client_against_port_server(port_server, jax_tokens, wire):
    c = ServingClient(port_server.address, wire=wire)
    try:
        got = [c.generate(p, 8, timeout_s=30.0)["tokens"] for p in PROMPTS]
        assert got == jax_tokens
    finally:
        c.close()


# -- tenancy ------------------------------------------------------------------------


def test_register_heartbeat_and_lease_eviction(port_model, jax_tokens):
    from paddle_tpu_torch.serving.quota import TenantQuotas

    s = make_session(port_model, quotas=TenantQuotas(max_concurrent=8))
    srv = ServingServer(s, lease_s=1.0, require_register=True).start()
    try:
        c = ServingClient(srv.address)
        with pytest.raises(Rejected) as ei:
            c.generate(PROMPTS[0], 4)  # unregistered
        assert ei.value.reason == "unregistered"
        c.tenant_id = "tr-forged-999"
        with pytest.raises(Rejected):
            c.generate(PROMPTS[0], 4)
        c.tenant_id = None
        tid = c.register()
        assert tid and c.lease_s == 1.0
        assert c.heartbeat() == {"ok": True}
        r = c.generate(PROMPTS[0], 8)
        assert r["done"] and r["tokens"] == jax_tokens[0]
        rid = c.submit(PROMPTS[1], 4)
        for _ in range(500):
            p = c.poll(rid)
            if p.get("done"):
                break
            time.sleep(0.01)
        assert p["done"] and p["finish_reason"] in ("length", "eos")
        st = c.stats()
        assert st["live_tenants"] >= 1 and st["completed"] >= 2
        # a resent submit with the same idempotency key reattaches
        r1 = srv.dispatch("submit", {"prompt": PROMPTS[1], "max_new_tokens": 2,
                                     "client_req_id": "k1"}, tid)
        r2 = srv.dispatch("submit", {"prompt": PROMPTS[1], "max_new_tokens": 2,
                                     "client_req_id": "k1"}, tid)
        assert r1["request_id"] == r2["request_id"]
        c.close()

        # eviction: stop the engine so a queued request cannot start, let
        # the lease lapse, and the reaper cancels the tenant's queued work
        s.stop()
        c2 = ServingClient(srv.address)
        t2 = c2.register()
        rid2 = c2.submit(PROMPTS[0], 4)
        c2.close()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            with srv._handles_lock:
                h2 = srv._handles.get(rid2)
            if h2 is not None and h2.done:
                break
            time.sleep(0.05)
        assert h2 is not None and h2.status == h2.CANCELLED
        assert srv.membership.evicted >= 1 and t2 != tid
    finally:
        srv.stop()


def test_quota_rejections_name_the_reason(port_model):
    from paddle_tpu_torch.serving.quota import TenantQuotas

    quotas = TenantQuotas(token_capacity=40, tokens_per_s=0.0, max_concurrent=2)
    s = make_session(port_model, quotas=quotas)
    s._thread = threading.Thread(target=lambda: None)  # hold the engine
    srv = ServingServer(s, port=0).start()
    try:
        c = ServingClient(srv.address)
        c.submit(PROMPTS[0], 16)  # 4 + 16 = 20 tokens of the 40
        c.submit(PROMPTS[0], 16)
        with pytest.raises(Rejected) as ei:
            c.submit(PROMPTS[0], 16)
        assert ei.value.reason in ("tokens", "concurrency")
        assert "rejected" in str(ei.value)
        other = ServingClient(srv.address)
        other.register()  # a tenant of its own: its bucket is untouched
        assert other.submit(PROMPTS[1], 4) >= 0
        other.close()
        c.close()
    finally:
        s._thread = None
        srv.stop()


# -- streaming with cursors ---------------------------------------------------------


def test_stream_cursor_reattach_and_delta_poll(port_model, jax_tokens):
    s = make_session(port_model)
    srv = ServingServer(s, port=0).start()
    try:
        c = ServingClient(srv.address)
        frames = list(c.stream(PROMPTS[2], 8))
        assert frames[-1]["done"] and frames[-1]["finish_reason"] == "length"
        got = []
        for fr in frames:
            assert fr["from"] == len(got)  # each delta starts at the cursor
            got += fr["tokens"]
        assert got == jax_tokens[2]
        assert c.stats()["stream_frames_pushed"] >= 1

        # reattach by the submit's idempotency key: the stream resumes and
        # ends with the request; the server clamps a cursor into range
        rid = c.submit(PROMPTS[3], 8, client_req_id="k-reattach")
        while not c.poll(rid)["done"]:
            time.sleep(0.01)
        tail = list(c.stream(request_id=rid, client_req_id="k-reattach"))
        assert tail[-1]["done"]
        assert [t for fr in tail for t in fr["tokens"]] == jax_tokens[3]
        for cur, want in ((5, 5), (-3, 0), (99, 8), ("x", 0)):
            resp = srv.dispatch("stream", {"request_id": rid, "from": cur}, None)
            assert resp["from"] == want and resp["stream"] is True
        # delta poll: the suffix from the cursor, full list once done
        p = c.poll(rid, from_=3)
        assert p["done"] and p["tokens"] == jax_tokens[3]
        c.close()
    finally:
        srv.stop()


def test_poll_many_and_unknown_ids(port_server, jax_tokens):
    c = ServingClient(port_server.address)
    try:
        rid = c.submit(PROMPTS[0], 8)
        deadline = time.monotonic() + 20
        while not c.poll(rid)["done"] and time.monotonic() < deadline:
            time.sleep(0.01)
        out = c._client.call("poll_many", items=[
            {"request_id": rid}, {"request_id": 10**6}, {"bad": 1}])
        res = out["results"]
        assert res[0]["done"] and res[0]["tokens"] == jax_tokens[0]
        assert res[1]["err"] == "unknown" and res[2]["err"] == "bad request_id"
        assert "err" in c.poll(10**6)
    finally:
        c.close()


def test_metrics_and_trace_export(port_server):
    c = ServingClient(port_server.address)
    try:
        c.generate(PROMPTS[1], 2)
        assert "paddle_tpu_serving" in c.metrics()
        assert "traceEvents" in c.trace_export()
        totals = c.wire_totals()
        assert totals["bytes_in"] > 0 and totals["round_trips"] >= 2
    finally:
        c.close()


def test_generate_config_answers_named_error(port_server):
    c = ServingClient(port_server.address)
    try:
        resp = c._client.call("generate_config", batch={})
        assert resp == {"err": "no --config generation session on this server"}
        with pytest.raises(Rejected, match="no --config generation session"):
            c.generate_config({})
        assert "unknown method" in c._client.call("no_such_method")["err"]
        # the router's takeover sweep is a method of the server now
        assert "requests" in c._client.call("outstanding")
    finally:
        c.close()


def test_bad_requests_answer_errors_not_hangs(port_server):
    c = ServingClient(port_server.address)
    try:
        with pytest.raises(Rejected, match="token ids"):
            c.submit([1, CFG["vocab"]], 4)
        with pytest.raises(Rejected, match="empty prompt"):
            c.submit([], 4)
        assert c.stats()["decode_shape_signatures"] <= 1
    finally:
        c.close()


# -- the closed-loop workload ------------------------------------------------------


@pytest.mark.parametrize("concurrency", [1, 3])
def test_closed_loop_in_process_and_over_the_wire(port_model, jax_tokens,
                                                  concurrency):
    """`workload.run_closed_loop` (in process) and `run_closed_loop_rpc`
    (push streams through the server) deliver the same greedy tokens, the
    JAX server's, at any concurrency; the RPC report times TTFT."""
    from paddle_tpu_torch.serving.workload import (
        make_prompts,
        make_repetitive_prompts,
        run_closed_loop,
        run_closed_loop_rpc,
    )

    inproc = run_closed_loop(make_session(port_model), PROMPTS, 8, concurrency)
    assert inproc["results"] == jax_tokens and inproc["tokens"] == 32
    srv = ServingServer(make_session(port_model), port=0).start()
    try:
        rpc = run_closed_loop_rpc(lambda: ServingClient(srv.address),
                                  PROMPTS, 8, concurrency)
    finally:
        srv.stop()
    assert rpc["results"] == jax_tokens and rpc["tokens"] == 32
    assert rpc["ttft_p50_ms"] > 0 and rpc["tokens_per_sec"] > 0
    prompts = make_prompts(5, (4, 9), CFG["vocab"], 1, seed=3)
    assert [len(p) for p in prompts] == [4, 9, 4, 9, 4] and prompts[0][0] == 1
    rep = make_repetitive_prompts(2, 3, 4, CFG["vocab"], 1, seed=4)
    assert len(rep[0]) == 13 and rep[0][1:4] == rep[0][4:7]


# -- on the card ------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.timeout(60)
def test_cuda_server_answers_a_client():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import make_demo_session

    kw = dict(CFG, **SESSION, prefill_chunk=8)
    cpu = make_demo_session(**kw, device="cpu")
    want = [cpu.submit(p, 8) for p in PROMPTS]
    cpu.run_until_idle()
    sess = make_demo_session(**kw, device="cuda")
    srv = ServingServer(sess, port=0).start()
    try:
        before = pa.LAUNCHES
        c = ServingClient(srv.address, wire="frames")
        got = [c.generate(p, 8, timeout_s=60.0)["tokens"] for p in PROMPTS]
        c.close()
        assert got == [h.tokens for h in want]
        st = sess.stats()
        assert st["decode_graph_captures"] == 1
        assert pa.LAUNCHES - before == st["decode_steps"] * CFG["n_layers"]
    finally:
        srv.stop()
