"""The port's ServingSession against the JAX package's, on the CPU.

Both engines get the same weights (moved from the JAX model by name) and the
mixed PROMPTS of tests/test_decode_fastpath.py, with joins and retires
(max_slots=4, page_size=8, buckets (8, 16, 32)). Greedy tokens must be
IDENTICAL, with whole-prompt prefill and with chunked prefill (a chunk size
that divides the prompts and one that does not). The port keeps one decode
signature and leaks no page.

Sampling draws jax's threefry bits in both packages, so a sampled
request's whole token stream equals the JAX engine's at the same seed, and
the port's own contracts hold too: same seed -> same tokens, a sampled
request's tokens do not depend on its batch-mates, temperature 0 and
top_k=1 are greedy."""

import numpy as np
import pytest

from paddle_tpu_torch.serving import ServableLM, ServingSession, make_demo_session
from paddle_tpu_torch.serving.convert import params_from_jax
from paddle_tpu_torch.serving.model import LMConfig

pytestmark = pytest.mark.serving

CFG = dict(vocab=96, n_layers=2, d_model=32, n_heads=2, max_len=96)
SESSION = dict(max_slots=4, page_size=8, prefill_buckets=(8, 16, 32),
               max_new_limit=16)
PROMPTS = [
    [1, 5, 9, 11],
    [1, 7],
    [1, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18],
    [1, 40, 41, 42, 43, 44, 45, 46],
]
LONG = [1] + list(range(3, 60))  # 58 tokens: beyond every bucket


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


def _port_session(port_model, **kw):
    return ServingSession(port_model, device="cpu", **{**SESSION, **kw})


def _run(session, prompts, n=8, **kw):
    hs = [session.submit(p, n, **kw) for p in prompts]
    session.run_until_idle()
    return [h.tokens for h in hs]


@pytest.mark.parametrize("chunk", [None, 3, 8])
def test_greedy_tokens_identical_to_jax_session(jax_pair, port_model, chunk):
    from paddle_tpu.serving.session import ServingSession as JaxSession

    jm, jp = jax_pair
    prompts = PROMPTS + ([LONG] if chunk else [])
    want = _run(JaxSession(jm, jp, prefill_chunk=chunk, **SESSION), prompts)
    port = _port_session(port_model, prefill_chunk=chunk)
    assert _run(port, prompts) == want
    assert port.decode_shape_signatures() == 1
    assert port.cache.pages_in_use == 0
    if chunk:
        assert port.prefill_chunks_committed > 0


def test_more_requests_than_slots_join_and_retire(jax_pair, port_model):
    """Eight requests through four slots with varied budgets: requests join
    as others retire, and tokens still equal the JAX engine's."""
    from paddle_tpu.serving.session import ServingSession as JaxSession

    jm, jp = jax_pair
    budgets = [3, 9, 5, 12, 2, 7, 16, 4]
    prompts = [PROMPTS[i % 4] + [20 + i] for i in range(8)]
    js = JaxSession(jm, jp, prefill_chunk=8, **SESSION)
    jh = [js.submit(p, n) for p, n in zip(prompts, budgets)]
    js.run_until_idle()
    ps = _port_session(port_model, prefill_chunk=8)
    ph = [ps.submit(p, n) for p, n in zip(prompts, budgets)]
    ps.run_until_idle()
    assert [h.tokens for h in ph] == [h.tokens for h in jh]
    assert [h.finish_reason for h in ph] == [h.finish_reason for h in jh]
    st = ps.stats()
    assert st["completed"] == 8 and st["pages_in_use"] == 0
    assert st["decode_shape_signatures"] == 1


@pytest.mark.parametrize("chunk", [None, 8])
def test_sampled_streams_identical_to_jax_session(jax_pair, port_model, chunk):
    """Sampled requests (seeds past 2^31 too) beside greedy ones: every
    stream equals the JAX engine's token for token."""
    from paddle_tpu.serving.session import ServingSession as JaxSession

    jm, jp = jax_pair
    reqs = [(PROMPTS[0], dict(temperature=0.8, top_k=40, seed=2**31 + 7)),
            (PROMPTS[1], {}),
            (PROMPTS[2], dict(temperature=1.7, seed=3)),
            (PROMPTS[3], dict(temperature=0.5, top_k=5, seed=2**32 - 1)),
            (PROMPTS[0] + [20], {})]
    prompts = reqs + ([(LONG, dict(temperature=1.0, seed=9))] if chunk else [])

    def run(session):
        hs = [session.submit(p, 12, **kw) for p, kw in prompts]
        session.run_until_idle()
        return [h.tokens for h in hs]

    want = run(JaxSession(jm, jp, prefill_chunk=chunk, **SESSION))
    assert run(_port_session(port_model, prefill_chunk=chunk)) == want
    greedy = _run(_port_session(port_model), [PROMPTS[1]], n=12)[0]
    assert want[1] == greedy and want[0] != _run(_port_session(port_model), [PROMPTS[0]], n=12)[0]


def test_no_decode_step_skipped_during_chunked_prefill(port_model):
    """While a long prompt's chunks commit, an already-decoding stream
    gains exactly one token at every engine step."""
    s = _port_session(port_model, prefill_chunk=8)
    short = s.submit(PROMPTS[0], 16)
    s.step()  # admit + prefill (first token) + decode (second token)
    assert len(short.tokens) == 2
    long = s.submit(LONG, 4)
    while long.tokens == [] and not short.done:
        n_before = len(short.tokens)
        s.step()
        assert len(short.tokens) == n_before + 1
    assert s.prefill_chunks_committed >= 7
    s.run_until_idle()
    assert s.cache.pages_in_use == 0


def test_prefix_cache_is_result_transparent(port_model):
    shared = [1] + list(range(10, 40))  # 31 tokens: 3 full pages to alias
    prompts = [shared + [50 + i, 60 + i] for i in range(3)]
    plain = _run(_port_session(port_model, prefill_chunk=8), prompts)
    s = _port_session(port_model, prefill_chunk=8, prefix_cache=True)
    first = _run(s, prompts[:1])
    rest = _run(s, prompts[1:])
    assert first + rest == plain
    assert s.stats()["prefix_pages_shared"] > 0
    s.cache.flush_prefix()
    assert s.cache.pages_in_use == 0


# -- sampling: the port's own contracts ---------------------------------------


def test_sampling_same_seed_same_tokens(port_model):
    def run(**kw):
        return _run(_port_session(port_model), PROMPTS[:1], 12, **kw)[0]

    a = run(temperature=0.8, top_k=10, seed=42)
    assert a == run(temperature=0.8, top_k=10, seed=42)
    assert a != run(temperature=0.8, top_k=10, seed=7), (
        "different seeds must diverge (fixed seeds chosen so)"
    )
    greedy = run()
    assert run(temperature=0.0, seed=3) == greedy
    assert run(temperature=0.9, top_k=1, seed=3) == greedy


def test_sampling_batched_equals_alone(port_model):
    kw = dict(temperature=0.7, top_k=8)
    alone = [
        _run(_port_session(port_model), [p], 8, seed=100 + i, **kw)[0]
        for i, p in enumerate(PROMPTS)
    ]
    s = _port_session(port_model)
    hs = [s.submit(p, 8, seed=100 + i, **kw) for i, p in enumerate(PROMPTS)]
    s.run_until_idle()
    assert [h.tokens for h in hs] == alone
    assert s.decode_shape_signatures() == 1


def test_greedy_and_sampled_mix_in_one_batch(port_model):
    """Greedy requests keep their greedy tokens beside sampled ones."""
    greedy = _run(_port_session(port_model), PROMPTS[:2])
    s = _port_session(port_model)
    g = [s.submit(p, 8) for p in PROMPTS[:2]]
    s.submit(PROMPTS[2], 8, temperature=1.0, seed=5)
    s.run_until_idle()
    assert [h.tokens for h in g] == greedy


def test_top_k_keeps_ties(port_model):
    import torch

    logits = torch.tensor([[1.0, 3.0, 3.0, 2.0, -1.0]])
    drawn = {
        int(port_model._sample(logits, np.array([seed], np.uint32),
                               np.array([0], np.int32),
                               np.array([5.0], np.float32),
                               np.array([1], np.int32))[0])
        for seed in range(40)
    }
    # both tied maxima survive top_k=1; nothing else does
    assert drawn == {1, 2}


# -- front-door guards and what is not ported ---------------------------------


def test_front_door_rejections(port_model):
    s = _port_session(port_model, prefill_chunk=8)
    with pytest.raises(ValueError, match="max_len"):
        s.submit([1] + [3] * 89, 16)
    with pytest.raises(ValueError, match="token ids"):
        s.submit([1, CFG["vocab"]], 4)
    with pytest.raises(ValueError, match="token ids"):
        s.submit([1, -1], 4)
    with pytest.raises(ValueError, match="empty"):
        s.submit([], 4)
    plain = _port_session(port_model)
    with pytest.raises(ValueError, match="bucket"):
        plain.submit(LONG, 4)
    with pytest.raises(ValueError, match="max_len"):
        ServingSession(port_model, device="cpu", max_slots=4, page_size=8,
                       prefill_buckets=(8, 16, 64), max_new_limit=64)


def test_unported_features_raise_naming_the_roadmap(port_model):
    # speculation and serve_forever are ported (test_torch_speculative.py,
    # test_torch_serving_resilience.py); tensor parallelism is not
    assert _port_session(port_model, speculate_k=2).speculate_k == 2
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_demo_session(tp=2, device="cpu")


def test_cancel_tenant_and_deadline_reap(port_model):
    s = _port_session(port_model, max_slots=1)
    running = s.submit(PROMPTS[0], 8, tenant="a")
    queued = [s.submit(PROMPTS[1], 8, tenant="b") for _ in range(2)]
    s.step()
    assert s.cancel_tenant("b") == 2
    assert all(h.finish_reason == "cancelled" for h in queued)
    doomed = s.submit(PROMPTS[1], 8, tenant="a", deadline_s=60.0)
    s.step(now=doomed.t_submit + 61.0)
    assert doomed.finish_reason == "deadline"
    s.run_until_idle()
    assert running.finish_reason in ("length", "eos")
    assert s.cache.pages_in_use == 0


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")


@pytest.mark.cuda
def test_cuda_session_tokens_equal_cpu_session(cuda):
    """The same seeded demo model on the card (decode attention through the
    CUDA kernel, n_layers launches per decode step) and on the CPU (the
    plain version, no launch) gives identical greedy tokens."""
    from paddle_tpu_torch.ops import paged_attention as pa

    kw = dict(vocab=96, n_layers=2, d_model=32, n_heads=2, max_len=96,
              prefill_chunk=8, **SESSION)
    out = {}
    for dev in ("cuda", "cpu"):
        s = make_demo_session(device=dev, **kw)
        before = pa.LAUNCHES
        out[dev] = _run(s, PROMPTS + [LONG])
        want = s.decode_steps * 2 if dev == "cuda" else 0
        assert pa.LAUNCHES - before == want
        assert s.cache.pages_in_use == 0
    assert out["cuda"] == out["cpu"]
