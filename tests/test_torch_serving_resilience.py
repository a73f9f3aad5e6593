"""Serving resilience on the port: twins of tests/test_serving_resilience.py.

The JAX model's parameters move across by name; the claims are the
reference's, asserted on the port's session and server:

  * deadlines — a request past its deadline is cancelled with the NAMED
    reason 'deadline' queued or mid-decode, its pages recycled that step;
    TTFT misses are counted, never fatal;
  * shedding — admission rejects a doomed request ('overload', with a
    `retry_after_ms` hint) and a full queue ('queue');
  * poll and cancel over RPC;
  * crash recovery — for each seeded site (decode_raise, engine_stall,
    page_exhaust) the supervisor restarts the engine, re-initialises the
    pools IN PLACE (same storage: the card's decode graph holds their
    pointers) and replays in-flight prompts: tokens equal an unfaulted run
    AND the JAX session's greedy tokens, zero page leak; past the restart
    budget every outstanding request fails with the engine's error;
  * hedged generate executes exactly once.

Every test that starts a thread or a server carries a timeout marker and
binds port 0. The `cuda` tests run on the card only."""

import threading
import time

import numpy as np
import pytest

from paddle_tpu_torch.core import faults
from paddle_tpu_torch.serving import ServableLM, ServingSession
from paddle_tpu_torch.serving.convert import params_from_jax
from paddle_tpu_torch.serving.model import LMConfig

pytestmark = pytest.mark.serving

CFG = dict(vocab=96, n_layers=2, d_model=32, n_heads=2, max_len=96)
SESSION = dict(max_slots=4, page_size=8, prefill_buckets=(8, 16, 32),
               max_new_limit=16)
NAMED_REASONS = {
    "eos", "length", "deadline", "cancelled", "client_timeout",
    "engine_error",
}
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


@pytest.fixture(scope="module")
def jax_greedy(jax_pair):
    """The JAX session's greedy tokens for PROMPTS, 8 new tokens each."""
    from paddle_tpu.serving.session import ServingSession as JaxSession

    jm, jp = jax_pair
    s = JaxSession(jm, jp, **SESSION)
    hs = [s.submit(p, 8) for p in PROMPTS]
    s.run_until_idle()
    return [h.tokens for h in hs]


def make_session(port_model, **kw):
    return ServingSession(port_model, device="cpu", **{**SESSION, **kw})


# -- deadlines ------------------------------------------------------------------


def test_deadline_expires_in_queue(port_model):
    s = make_session(port_model)
    total_free = s.cache.free_pages
    h = s.submit(PROMPTS[0], 8, deadline_s=5.0)
    misses0 = s.scheduler.deadline_misses
    s.step(h.t_deadline + 0.001)
    assert h.done and h.status == h.CANCELLED
    assert h.finish_reason == "deadline"
    assert s.scheduler.deadline_misses == misses0 + 1
    assert s.cache.free_pages == total_free
    with pytest.raises(RuntimeError, match="deadline"):
        h.result()


def test_deadline_expires_mid_decode_recycles_pages(port_model):
    s = make_session(port_model)
    total_free = s.cache.free_pages
    h = s.submit(PROMPTS[2], 16, deadline_s=30.0)
    s.step()
    assert h.status == h.RUNNING and s.cache.free_pages < total_free
    recycled0 = s.scheduler.pages_recycled_on_cancel
    s.step(h.t_deadline + 0.001)
    assert h.done and h.finish_reason == "deadline"
    assert len(h.tokens) < 16
    assert s.cache.free_pages == total_free
    assert s.scheduler.pages_recycled_on_cancel > recycled0


def test_ttft_deadline_miss_counted_not_fatal(port_model):
    from paddle_tpu_torch.serving.session import SERVING_EVENTS

    s = make_session(port_model)
    before = SERVING_EVENTS.get("serving_ttft_deadline_missed")
    h = s.submit(PROMPTS[0], 4, ttft_deadline_s=1e-9)
    s.run_until_idle()
    assert h.done and h.status == h.DONE
    assert h.finish_reason in ("length", "eos")
    assert SERVING_EVENTS.get("serving_ttft_deadline_missed") == before + 1


# -- shedding -------------------------------------------------------------------


def test_admission_sheds_doomed_request_with_retry_hint(port_model):
    from paddle_tpu_torch.serving.quota import QuotaExceeded

    s = make_session(port_model)
    s.scheduler._ewma_service_s = 1.0
    shed0 = s.scheduler.shed
    with pytest.raises(QuotaExceeded) as ei:
        s.submit(PROMPTS[0], 8, deadline_s=0.5)
    assert ei.value.reason == "overload"
    assert ei.value.retry_after_ms >= 500
    assert s.scheduler.shed == shed0 + 1
    with pytest.raises(QuotaExceeded) as ei:
        s.submit(PROMPTS[0], 8, deadline_s=0.0)
    assert ei.value.reason == "deadline"
    h = s.submit(PROMPTS[0], 8)
    assert h.status == h.QUEUED
    h.cancel()


def test_queue_bound_shed_carries_retry_hint(port_model):
    from paddle_tpu_torch.serving.quota import QuotaExceeded

    s = make_session(port_model, max_queue=2)
    s.scheduler.submit([1, 2], 2, "x")
    s.scheduler.submit([1, 2], 2, "x")
    with pytest.raises(QuotaExceeded) as ei:
        s.scheduler.submit([1, 2], 2, "x")
    assert ei.value.reason == "queue"
    assert ei.value.retry_after_ms is not None and ei.value.retry_after_ms >= 1


@pytest.mark.timeout(60)
def test_shed_reaches_the_client_as_named_rejection(port_model):
    """Over RPC a shed is an error reply naming the reason, with the retry
    hint, which `ServingClient` raises as `Rejected`."""
    from paddle_tpu_torch.serving import Rejected, ServingClient, ServingServer

    s = make_session(port_model)
    s.scheduler._ewma_service_s = 1.0
    s._thread = threading.Thread(target=lambda: None)  # hold the engine
    srv = ServingServer(s, port=0).start()
    try:
        c = ServingClient(srv.address)
        with pytest.raises(Rejected) as ei:
            c.submit(PROMPTS[0], 8, deadline_s=0.5)
        assert ei.value.reason == "overload"
        assert ei.value.retry_after_ms >= 500
        c.close()
    finally:
        s._thread = None
        srv.stop()


# -- poll and cancel over RPC -------------------------------------------------------


@pytest.mark.timeout(60)
def test_poll_returns_tokens_so_far(port_model):
    from paddle_tpu_torch.serving import ServingServer

    s = make_session(port_model)
    srv = ServingServer(s)
    try:
        rid = srv.dispatch(
            "submit", {"prompt": PROMPTS[0], "max_new_tokens": 6}, None
        )["request_id"]
        s.step()
        p1 = srv.dispatch("poll", {"request_id": rid}, None)
        assert not p1["done"]
        assert p1["tokens"] and len(p1["tokens"]) == p1["tokens_so_far"]
        s.step()
        p2 = srv.dispatch("poll", {"request_id": rid}, None)
        assert len(p2["tokens"]) > len(p1["tokens"])
        assert p2["tokens"][: len(p1["tokens"])] == p1["tokens"]
        s.run_until_idle()
        done = srv.dispatch("poll", {"request_id": rid}, None)
        assert done["done"] and done["finish_reason"] in ("length", "eos")
        assert done["tokens"][: len(p2["tokens"])] == p2["tokens"]
    finally:
        srv.stop()


@pytest.mark.timeout(60)
def test_cancel_rpc(port_model):
    from paddle_tpu_torch.serving import ServingServer

    s = make_session(port_model)
    srv = ServingServer(s)
    try:
        rid = srv.dispatch(
            "submit", {"prompt": PROMPTS[0], "max_new_tokens": 6}, None
        )["request_id"]
        r = srv.dispatch("cancel", {"request_id": rid}, None)
        assert r["cancelled"] is True
        p = srv.dispatch("poll", {"request_id": rid}, None)
        assert p["done"] and p["cancelled"] and p["finish_reason"] == "cancelled"
        again = srv.dispatch("cancel", {"request_id": rid}, None)
        assert again["cancelled"] is False and again["done"] is True
    finally:
        srv.stop()


# -- engine crash recovery -------------------------------------------------------


@pytest.mark.timeout(60)
@pytest.mark.parametrize(
    "site,spec",
    [
        ("decode_raise", "decode_raise:step=3"),
        ("engine_stall", "engine_stall:step=2"),
        ("page_exhaust", "page_exhaust:step=0"),
    ],
)
def test_engine_recovery_result_transparent_zero_leak(
    port_model, jax_greedy, site, spec, monkeypatch
):
    monkeypatch.setenv("PADDLE_TPU_SERVING_STALL_S", "1")
    s = make_session(port_model, engine_stall_timeout_s=0.3,
                     engine_restart_max=5)
    total_free = s.cache.free_pages
    pools = (s.k_pages.data_ptr(), s.v_pages.data_ptr())
    with faults.inject(spec, seed=0) as inj:
        s.serve_forever()
        handles = [s.submit(p, 8, deadline_s=60.0) for p in PROMPTS]
        deadline = time.monotonic() + 45
        for h in handles:
            assert h._event.wait(max(0.1, deadline - time.monotonic())), (
                f"request {h.request_id} never completed after {site}"
            )
        fired = dict(inj.fired)
    s.stop()
    assert fired.get(site, 0) >= 1, "the seeded fault must actually fire"
    assert s.engine_restarts >= 1
    assert all(h.finish_reason in NAMED_REASONS for h in handles)
    assert [h.tokens for h in handles] == jax_greedy
    assert s.cache.free_pages == total_free, "zero page leak after recovery"
    # recovery re-initialised the pools in place: same storage
    assert (s.k_pages.data_ptr(), s.v_pages.data_ptr()) == pools
    assert not s._device_reset_pending


@pytest.mark.timeout(60)
def test_recovery_zeroes_the_pools_in_place(port_model):
    """`_reset_device_state` (run by the new engine thread) zeroes the
    pools without re-allocating them; the allocator reset leaves every page
    free and the table empty."""
    s = make_session(port_model)
    s.submit(PROMPTS[2], 4)
    s.step()
    assert s.k_pages.abs().sum() > 0 and s.cache.pages_in_use > 0
    ptr = s.k_pages.data_ptr()
    s.scheduler.requeue_active()
    s.cache.reset()
    s._reset_device_state()
    assert s.k_pages.data_ptr() == ptr
    assert float(s.k_pages.abs().sum()) == 0 == float(s.v_pages.abs().sum())
    assert s.cache.pages_in_use == 0 and not s.cache.block_table().any()
    s.run_until_idle()  # the requeued request replays to completion
    assert s.scheduler.completed == 1 and s.cache.pages_in_use == 0


@pytest.mark.timeout(60)
def test_restart_budget_exhausted_fails_engine_error(port_model):
    s = make_session(port_model, engine_restart_max=1)
    total_free = s.cache.free_pages
    with faults.inject("decode_raise:1.0", seed=0):
        s.serve_forever()
        h = s.submit(PROMPTS[0], 8)
        assert h._event.wait(30)
    assert h.status == h.CANCELLED and h.finish_reason == "engine_error"
    assert s.engine_restarts == 1
    assert s.cache.free_pages == total_free
    assert "decode_raise" in str(s.engine_error)
    with pytest.raises(RuntimeError, match="died"):
        s.submit(PROMPTS[1], 4)
    s.stop()


# -- hedged retry / dedup -----------------------------------------------------------


@pytest.mark.timeout(60)
def test_hedged_generate_exactly_one_execution(port_model, jax_greedy):
    from paddle_tpu_torch.serving import ServingClient, ServingServer

    s = make_session(port_model)
    # hold the engine: a placeholder thread makes start() treat it as
    # running, so nothing decodes until it starts for real below
    s._thread = threading.Thread(target=lambda: None)
    srv = ServingServer(s, port=0).start()
    try:
        c = ServingClient(srv.address)
        out = {}

        def run():
            out["resp"] = c.generate(
                PROMPTS[0], 8, hedge_ttft_s=0.1, timeout_s=30.0
            )

        t = threading.Thread(target=run, daemon=True)
        t.start()
        deadline = time.monotonic() + 10
        while c.hedges == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert c.hedges == 1, "TTFT miss must have triggered the hedge"
        s._thread = None
        s.serve_forever()
        t.join(30)
        assert not t.is_alive() and out["resp"]["done"]
        assert out["resp"]["tokens"] == jax_greedy[0]
        assert s.scheduler.completed == 1
        with srv._handles_lock:
            assert len(srv._handles) == 1
        c.close()
    finally:
        srv.stop()


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.timeout(60)
def test_cuda_recovery_recaptures_and_replay_matches_eager(cuda):
    """A decode_raise mid-run on the card: the new engine zeroes the pools
    in place (same storage), re-captures the decode graph, and the tokens
    equal a fault-free run; a replay afterwards matches the eager step."""
    import torch

    from paddle_tpu_torch.serving import make_demo_session

    kw = dict(CFG, **SESSION, prefill_chunk=8, device="cuda")
    clean = make_demo_session(**kw)
    want = [clean.submit(p, 8) for p in PROMPTS]
    clean.run_until_idle()
    s = make_demo_session(**kw, engine_restart_max=2)
    pools = (s.k_pages.data_ptr(), s.v_pages.data_ptr())
    with faults.inject("decode_raise:step=3", seed=0) as inj:
        s.serve_forever()
        hs = [s.submit(p, 8) for p in PROMPTS]
        assert all(h._event.wait(60) for h in hs)
        assert inj.fired["decode_raise"] == 1
    s.stop()
    assert s.engine_restarts == 1 and s.decode_graph_captures == 2
    assert [h.tokens for h in hs] == [h.tokens for h in want]
    assert (s.k_pages.data_ptr(), s.v_pages.data_ptr()) == pools
    g = s._decode_graph
    n, p = g.block_table.shape
    tokens = np.arange(n, dtype=np.int32) + 3
    pos = np.arange(n, dtype=np.int32) * 5
    active = np.ones(n, bool)
    bt = (np.arange(n * p, dtype=np.int32).reshape(n, p) % (s.cache.num_pages - 1)) + 1
    kp, vp = s.k_pages.clone(), s.v_pages.clone()
    logits, _ = g.replay(tokens, pos, active, bt)
    eager = s.model.decode_logits(kp, vp, *(torch.as_tensor(a).cuda()
                                            for a in (tokens, pos, active, bt)))
    torch.testing.assert_close(logits, eager, rtol=1e-5, atol=1e-6)
