"""The decode step as one CUDA graph (`serving/decode_graph.py`).

On the CPU, which has no graphs, the session runs every decode step eagerly
(`decode_graph_captures` stays 0) and `DecodeGraph` refuses CPU pools; the
paged-attention wrapper keeps launches and captured calls apart. On the card
(`cuda` tests): the replayed logits equal the eager step's, the launch count
under replay equals decode steps x n_layers, and a capture on the engine
thread serves the supervised engine."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.serving import make_demo_session
from paddle_tpu_torch.serving.decode_graph import DecodeGraph

pytestmark = pytest.mark.serving

KW = dict(vocab=96, n_layers=2, d_model=32, n_heads=2, max_len=96,
          max_slots=4, page_size=8, prefill_buckets=(8, 16, 32),
          max_new_limit=16, prefill_chunk=8)
PROMPTS = [[1, 5, 9, 11], [1, 7], list(range(1, 19)), [1] + list(range(40, 47)),
           [1] + list(range(3, 60))]


def test_cpu_session_runs_every_decode_step_eagerly():
    s = make_demo_session(**KW, device="cpu")
    before = pa.LAUNCHES
    hs = [s.submit(p, 8) for p in PROMPTS]
    s.run_until_idle()
    assert all(h.done for h in hs) and s.decode_steps > 0
    assert s.decode_graph_captures == 0 and s._decode_graph is None
    assert pa.LAUNCHES == before  # the plain version launches nothing


def test_decode_graph_refuses_cpu_pools():
    s = make_demo_session(**KW, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        DecodeGraph(s.model, s.k_pages, s.v_pages, 4, s.cache.max_pages_per_seq)


def test_note_replay_counts_launches_not_captures():
    before, captured = pa.LAUNCHES, pa.CAPTURED
    pa.note_replay(12)
    assert pa.LAUNCHES == before + 12 and pa.CAPTURED == captured
    pa.LAUNCHES = before


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs have no CPU mode")


def _inputs(s, seed):
    rng = np.random.RandomState(seed)
    n, p = s.cache.max_slots, s.cache.max_pages_per_seq
    ps = s.cache.page_size
    tokens = rng.randint(3, s.cfg.vocab, size=n).astype(np.int32)
    pos = rng.randint(0, p * ps, size=n).astype(np.int32)
    active = rng.rand(n) < 0.75
    # distinct pages for every slot (the default pool has n * p of them)
    bt = (rng.permutation(s.cache.num_pages - 1)[: n * p].reshape(n, p) + 1
          ).astype(np.int32)
    return tokens, pos, active, bt


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cuda_graph_replay_matches_eager_logits(cuda, seed):
    s = make_demo_session(**KW, device="cuda")
    s.submit(PROMPTS[0], 4)
    s.run_until_idle()  # the first decode step ran eagerly, then captured
    g = s._decode_graph
    assert g is not None and s.decode_graph_captures == 1
    assert g.kernel_calls == KW["n_layers"]
    host = _inputs(s, seed)
    kp, vp = s.k_pages.clone(), s.v_pages.clone()
    logits, greedy = g.replay(*host)
    eager = s.model.decode_logits(kp, vp, *(torch.as_tensor(a).cuda() for a in host))
    torch.testing.assert_close(logits, eager, rtol=1e-5, atol=1e-6)
    assert torch.equal(greedy, eager.argmax(-1))
    torch.testing.assert_close(s.k_pages, kp, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_cuda_launch_count_under_replay(cuda):
    """decode kernel launches = decode steps x n_layers, the eager first
    step and every replay alike; capturing launches nothing."""
    s = make_demo_session(**KW, device="cuda")
    before, captured = pa.LAUNCHES, pa.CAPTURED
    hs = [s.submit(p, 8) for p in PROMPTS]
    s.run_until_idle()
    assert all(h.done for h in hs) and s.decode_steps > 2
    assert pa.LAUNCHES - before == s.decode_steps * KW["n_layers"]
    assert pa.CAPTURED - captured == KW["n_layers"]
    assert s.decode_graph_captures == 1 and s.decode_shape_signatures() == 1
    cpu = make_demo_session(**KW, device="cpu")
    hc = [cpu.submit(p, 8) for p in PROMPTS]
    cpu.run_until_idle()
    assert [h.tokens for h in hs] == [h.tokens for h in hc]


@pytest.mark.cuda
@pytest.mark.timeout(60)
def test_cuda_supervised_engine_captures_on_its_thread(cuda):
    s = make_demo_session(**KW, device="cuda")
    s.serve_forever()
    try:
        hs = [s.submit(p, 8, temperature=t, seed=7)
              for p, t in zip(PROMPTS, (0.0, 0.8, 0.0, 1.0, 0.0))]
        assert all(h._event.wait(60) for h in hs)
    finally:
        s.stop()
    assert s.decode_graph_captures == 1 and s.engine_restarts == 0
    ref = make_demo_session(**KW, device="cuda")
    hr = [ref.submit(p, 8, temperature=t, seed=7)
          for p, t in zip(PROMPTS, (0.0, 0.8, 0.0, 1.0, 0.0))]
    ref.run_until_idle()
    assert [h.tokens for h in hs] == [h.tokens for h in hr]
