"""The port's prompt-lookup speculative decoding, against the JAX package.

Twins of tests/test_speculative.py on the port, with the JAX model's
parameters moved across by name (`convert.params_from_jax`):

  * result transparency — greedy tokens with speculation on EQUAL the port
    without it AND the JAX session's non-speculative greedy tokens, on
    repetitive prompts (drafts land), random prompts (they mostly miss) and
    a mix; `speculate_k=0` is the plain engine;
  * seeded sampling is identical with speculation on and off (the port's
    own sampling contract: position i of a verify round draws with the
    emitted-token index, as the plain decode step would);
  * one verify signature; the decode signature stays 1;
  * paging — the +K reservation headroom is trimmed back once speculation
    can no longer reach it, retirement returns everything, and with the
    prefix cache on the trims free only private tail pages;
  * the drafter — the JAX package's three drafter tests, and its drafts
    equal the reference drafter's on the same histories.

The JAX package's own copies of the two paging tests
(`test_spec_pages_reserved_trimmed_and_recycled`,
`test_prefix_cache::test_speculation_composes_with_prefix_cache`) fail
with jax 0.9.0: their prompts never reach the trim path or never draft
under the weights that jax draws from PRNGKey(0). The twins here use
those same weights and add prompts that do reach both paths."""

import numpy as np
import pytest

from paddle_tpu_torch.serving import PromptLookupDrafter, ServableLM, ServingSession
from paddle_tpu_torch.serving.convert import params_from_jax
from paddle_tpu_torch.serving.model import LMConfig
from paddle_tpu_torch.serving.speculation import next_draft_k

pytestmark = pytest.mark.serving

CFG = dict(vocab=96, n_layers=2, d_model=32, n_heads=2, max_len=96)
REPETITIVE = [
    [1] + [5, 9, 11] * 5,
    [1] + [7, 8] * 7,
    [1] + [40, 41, 42, 43] * 4,
]
RANDOM = [
    [1, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18],
    [1, 90, 2, 90],
    [1, 7],
]
SYS = list(range(3, 27))


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
    kw.setdefault("max_slots", 4)
    kw.setdefault("page_size", 8)
    kw.setdefault("prefill_buckets", (8, 16, 32))
    kw.setdefault("max_new_limit", 24)
    return ServingSession(port_model, device="cpu", **kw)


def _run_all(session, prompts, max_new, **submit_kw):
    handles = [session.submit(p, max_new, **submit_kw) for p in prompts]
    session.run_until_idle()
    return [h.tokens for h in handles]


@pytest.mark.parametrize("prompts", [REPETITIVE, RANDOM, REPETITIVE + RANDOM],
                         ids=["repetitive", "random", "mixed"])
def test_speculative_greedy_equals_nonspec_and_jax(jax_pair, port_model, prompts):
    from paddle_tpu.serving.session import ServingSession as JaxSession

    jm, jp = jax_pair
    js = JaxSession(jm, jp, max_slots=4, page_size=8,
                    prefill_buckets=(8, 16, 32), max_new_limit=24)
    want = _run_all(js, prompts, 12)
    spec = make_session(port_model, speculate_k=4)
    got_spec = _run_all(spec, prompts, 12)
    base = make_session(port_model, speculate_k=0)
    assert got_spec == _run_all(base, prompts, 12) == want
    assert base.spec_rounds == 0 and base.verify_shape_signatures() == 0
    if prompts is not RANDOM:
        assert spec.spec_rounds >= 1, "workload never exercised speculation"


def test_speculative_sampling_replay_stable(port_model):
    kw = dict(temperature=0.8, top_k=20, seed=1234)
    spec = make_session(port_model, speculate_k=4)
    got_spec = _run_all(spec, REPETITIVE, 12, **kw)
    base = make_session(port_model, speculate_k=0)
    assert got_spec == _run_all(base, REPETITIVE, 12, **kw)
    assert spec.spec_rounds >= 1


def test_one_verify_signature_and_decode_signature_stays(port_model):
    s = make_session(port_model, speculate_k=4)
    _run_all(s, REPETITIVE + RANDOM, 12)
    assert s.spec_rounds >= 2
    assert s.verify_shape_signatures() == 1
    assert s.decode_shape_signatures() == 1
    _run_all(s, REPETITIVE, 10)
    assert s.verify_shape_signatures() == 1
    assert s.decode_shape_signatures() == 1


def test_speculate_k0_is_the_plain_engine(port_model):
    s = make_session(port_model, speculate_k=0)
    got = _run_all(s, RANDOM, 8)
    assert all(len(t) > 0 for t in got)
    st = s.stats()
    assert st["speculate_k"] == 0
    assert st["spec_rounds"] == 0 and st["spec_tokens_drafted"] == 0
    assert st["verify_shape_signatures"] == 0
    assert st["spec_pages_trimmed"] == 0
    assert s.cache.max_pages_per_seq == -(-(32 + 24) // 8)  # no +K headroom


def test_spec_pages_reserved_trimmed_and_recycled(port_model):
    """The +K headroom reserved at admission is trimmed back once
    unreachable and returned at retirement; the pool serves follow-up work
    with nothing leaked. RANDOM[0] (17 tokens + 16 new = 5 pages, +8
    headroom = 6) decodes plainly to its last token, so its sixth page
    comes back mid-flight."""
    s = make_session(port_model, speculate_k=8, page_size=8)
    free0 = s.cache.free_pages
    _run_all(s, REPETITIVE + RANDOM, 16)
    assert s.cache.free_pages == free0, "pages leaked across retirement"
    assert s.spec_pages_trimmed >= 1
    assert s.spec_rounds >= 1
    h = s.submit(REPETITIVE[0], 8)
    s.run_until_idle()
    assert len(h.tokens) == 8
    assert s.cache.free_pages == free0


@pytest.mark.parametrize("tail,path", [
    ([5, 9, 11] * 5, "trim"),   # the reference test's prompt
    ([7, 8] * 7, "draft"),
])
def test_speculation_composes_with_prefix_cache(port_model, tail, path):
    """Speculation's +K headroom and aliased prefix pages coexist: the
    second request hits the cache AND runs the speculative path, tokens
    equal cache-off, trims free only private tail pages, and the pool is
    whole after a flush."""
    prompt = SYS + tail

    def run(prefix):
        s = make_session(port_model, page_size=4, max_new_limit=16,
                         prefill_chunk=8, prefix_cache=prefix, speculate_k=4)
        hs = []
        for p in (prompt, prompt):
            hs.append(s.submit(p, 12, tenant="t0"))
            s.run_until_idle()
        return [h.tokens for h in hs], s

    ref, _ = run(False)
    out, s = run(True)
    assert out == ref
    st = s.stats()
    assert st["prefix_hits"] >= 1
    if path == "draft":
        assert st["spec_rounds"] > 0
        assert 1.0 <= st["spec_effective_k"] <= 4.0
    else:
        assert st["spec_pages_trimmed"] > 0
    assert st["verify_shape_signatures"] <= 1
    total = s.cache.num_pages - 1
    s.cache.flush_prefix()
    assert s.cache.free_pages == total, "no leak from headroom + aliasing"


def test_eos_truncates_committed_draft(port_model):
    spec = make_session(port_model, speculate_k=6)
    base = make_session(port_model, speculate_k=0)
    for p in REPETITIVE + RANDOM:
        hs = spec.submit(p, 20)
        spec.run_until_idle()
        hb = base.submit(p, 20)
        base.run_until_idle()
        assert hs.tokens == hb.tokens
        assert hs.finish_reason == hb.finish_reason
        eos = spec.cfg.eos_id
        if eos in hs.tokens:
            assert hs.tokens.index(eos) == len(hs.tokens) - 1


# -- the drafter ----------------------------------------------------------------


def test_drafter_drafts_previous_occurrence_not_self():
    d = PromptLookupDrafter(ngram=2)
    d.feed([7, 7, 7, 7])
    assert d.draft(3) == [7, 7, 7]


def test_drafter_cycles_and_misses():
    d = PromptLookupDrafter(ngram=2)
    d.feed([1, 5, 9, 11, 5, 9, 11, 5, 9])
    assert d.draft(6) == [11, 5, 9, 11, 5, 9]
    miss = PromptLookupDrafter(ngram=2)
    miss.feed([1, 2, 3, 4, 5])
    assert miss.draft(4) == []
    tiny = PromptLookupDrafter(ngram=3)
    tiny.feed([1, 2])
    assert tiny.draft(4) == []


def test_drafter_sync_is_incremental_and_deterministic():
    prompt = [1, 5, 9, 11, 5, 9, 11]
    gen = [5, 9, 11, 5]
    a = PromptLookupDrafter(ngram=2)
    for i in range(len(gen) + 1):
        a.sync(prompt, gen[:i])
    b = PromptLookupDrafter(ngram=2)
    b.sync(prompt, gen)
    assert len(a) == len(b) == len(prompt) + len(gen)
    assert a.draft(5) == b.draft(5)


@pytest.mark.parametrize("seed", range(4))
def test_drafter_and_adaptive_k_match_reference(seed):
    from paddle_tpu.serving.speculation import PromptLookupDrafter as RefDrafter
    from paddle_tpu.serving.speculation import next_draft_k as ref_next_k

    rng = np.random.RandomState(seed)
    seq = [int(t) for t in rng.randint(0, 6, size=60)]
    mine, ref = PromptLookupDrafter(ngram=2), RefDrafter(ngram=2)
    for i in range(0, 60, 3):
        mine.sync(seq[:10], seq[10:i])
        ref.sync(seq[:10], seq[10:i])
        for k in (1, 4, 8):
            assert mine.draft(k) == ref.draft(k)
    for k_eff, k_max, drafted, accepted in rng.randint(0, 9, size=(20, 4)):
        assert next_draft_k(k_eff, k_max + 1, drafted, accepted) == \
            ref_next_k(k_eff, k_max + 1, drafted, accepted)
