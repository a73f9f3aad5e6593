"""The benchmark harness's helpers in the port: `core/benchmark.py`'s step
timers and `serving/workload.py`'s prompt sets and open loop, against the
JAX package's (`paddle_tpu/core/benchmark.py`,
`paddle_tpu/serving/workload.py`).

  * the shared-prefix and mixed prompt lists and the arrival schedule equal
    the JAX functions' for the same arguments and seeds;
  * `run_open_loop` on a CPU demo session returns the JAX result's keys
    (per phase too), offers every arrival and completes what it accepts;
  * each timer returns a finite time a step and the final state, and its
    barrier fetched a finite cost."""

import math

import numpy as np
import pytest

from paddle_tpu_torch.core import benchmark as tbench
from paddle_tpu_torch.serving import workload as tw
from paddle_tpu_torch.serving.session import make_demo_session


@pytest.mark.parametrize("seed", [0, 3])
def test_prompt_sets_equal_jax(seed):
    from paddle_tpu.serving import workload as jw

    kw = dict(n=10, n_prefixes=3, prefix_len=12, suffix_len=4, vocab=50, bos_id=1, seed=seed)
    assert tw.make_shared_prefix_prompts(**kw) == jw.make_shared_prefix_prompts(**kw)
    kw = dict(n=12, short_lengths=(5, 9), long_len=30, long_every=4, vocab=50, bos_id=1,
              seed=seed, burst=2)
    assert tw.make_mixed_prompts(**kw) == jw.make_mixed_prompts(**kw)


@pytest.mark.parametrize("schedule", [[(0.1, 20), (0.05, 0), (0.2, 35)], [(1.0, 7)]])
def test_expand_schedule_equals_jax(schedule):
    from paddle_tpu.serving import workload as jw

    for n in (3, 50):
        assert tw.expand_schedule(n, schedule) == jw.expand_schedule(n, schedule)


def _jax_open_loop_keys(**kw):
    from paddle_tpu.serving import workload as jw
    from paddle_tpu.serving.session import make_demo_session as jax_demo

    s = jax_demo(max_slots=2, page_size=8, prefill_buckets=(8,), max_new_limit=4)
    return jw.run_open_loop(s, [[1, 5, 9]] * 4, 3, **kw)


@pytest.mark.parametrize("kw", [{"rate_rps": 200.0},
                                {"schedule": [(0.01, 200.0), (0.01, 0.0), (0.01, 200.0)]}],
                         ids=["rate", "schedule"])
def test_run_open_loop_reports_the_jax_keys(kw):
    s = make_demo_session(max_slots=2, page_size=8, prefill_buckets=(8,), max_new_limit=4,
                          device="cpu")
    got = tw.run_open_loop(s, [[1, 5, 9]] * 4, 3, **kw)
    want = _jax_open_loop_keys(**kw)
    assert set(got) == set(want)
    if "phases" in want:
        assert [set(p) for p in got["phases"]] == [set(p) for p in want["phases"]]
    assert got["requests_offered"] == want["requests_offered"]
    assert got["accepted"] == got["completed_ok"] == got["requests_offered"]
    assert got["shed"] == 0 and got["goodput_rps"] > 0
    with pytest.raises(ValueError, match="rate_rps or schedule"):
        tw.run_open_loop(s, [[1]], 2)


def _trainer():
    from paddle_tpu_torch.nn import costs as C
    from paddle_tpu_torch.nn import layers as L
    from paddle_tpu_torch.nn.graph import reset_name_scope
    from paddle_tpu_torch.optim.optimizers import SGD
    from paddle_tpu_torch.trainer.trainer import SGDTrainer

    reset_name_scope()
    x = L.Data("x", shape=(4,))
    cost = C.SquareError(L.Fc(x, 1, act=None, name="o"), L.Data("y", shape=(1,)))
    rs = np.random.RandomState(0)
    batch = {"x": rs.randn(8, 4).astype(np.float32), "y": rs.randn(8, 1).astype(np.float32)}
    return SGDTrainer(cost, SGD(learning_rate=0.01), device="cpu"), batch


def test_time_train_steps_returns_time_and_state():
    tr, batch = _trainer()
    seen = []

    def step(state, b):
        seen.append(state)
        return state + 1, tr.step(b), {}

    dt, final = tbench.time_train_steps(step, 0, batch, steps=3, warmup=2)
    assert math.isfinite(dt) and dt > 0
    assert final == 5 and seen == [0, 1, 2, 3, 4]


def test_time_multi_steps_returns_time_and_state():
    tr, batch = _trainer()
    stacked = {k: np.stack([v, v]) for k, v in batch.items()}

    def multi(state, b):
        return state + 1, tr.multi_step(b)  # the K costs

    dt, final = tbench.time_multi_steps(multi, 0, stacked, k=2, dispatches=2, warmup=1)
    assert math.isfinite(dt) and dt > 0 and final == 3
    with pytest.raises(AssertionError, match="non-finite"):
        tbench.time_train_steps(lambda s, b: (s, float("nan"), {}), 0, batch)
