"""The device prefetcher (`paddle_tpu_torch/data/pipeline.py`), mirroring
tests/test_pipeline.py without the sharded placement.

On the CPU (`device="cpu"`: the worker feeds and converts to tensors):
  * batches come out in reader order, as tensors equal to the JAX
    package's prefetcher's arrays for the same samples and feeder;
  * feed-ready dict batches compose (only the device leg is added);
  * a worker error reaches the consumer with its message, a transient one
    is retried (the `feeder_raise` fault), abandoning the iterator retires
    the worker, a bad depth and a ragged slot are rejected;
  * is_device_batch and coerce_batch;
  * the trainer trains through a prefetcher (the cost falls, test() runs on
    it), and stack_k=3 StackedBatches give bitwise the updates of single
    steps, a trailing remainder coming out as single batches.

On the card (`cuda`, skipped elsewhere): batches land on the card through
the copy stream, and the step graph fed by the prefetcher gives bitwise
the updates of pre-placed batches."""

import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import faults, stats
from paddle_tpu_torch.data import DataFeeder, dense_vector, integer_value
from paddle_tpu_torch.data.pipeline import (
    DevicePrefetcher, StackedBatch, coerce_batch, is_device_batch,
)
from paddle_tpu_torch.nn import costs as TC
from paddle_tpu_torch.nn import graph as tgraph
from paddle_tpu_torch.nn import layers as TL
from paddle_tpu_torch.optim import Adam
from paddle_tpu_torch.trainer import EndPass, SGDTrainer


def raw_batches(n=6, bs=8, dim=4, classes=3, seed=0):
    rs = np.random.RandomState(seed)
    return [[(rs.randn(dim).astype(np.float32), int(i % classes)) for i in range(bs)]
            for _ in range(n)]


def feeder(dim=4, classes=3):
    return DataFeeder({"x": dense_vector(dim), "label": integer_value(classes)})


def test_prefetcher_preserves_order_and_matches_jax():
    from paddle_tpu.data.feeder import DataFeeder as JaxFeeder
    from paddle_tpu.data.feeder import dense_vector as jdense
    from paddle_tpu.data.feeder import integer_value as jint
    from paddle_tpu.data.pipeline import DevicePrefetcher as JaxPrefetcher

    raws = raw_batches()
    got = list(DevicePrefetcher(lambda: iter(raws), feeder(), prefetch_depth=2, device="cpu"))
    want = list(JaxPrefetcher(lambda: iter(raws), JaxFeeder({"x": jdense(4),
                                                             "label": jint(3)})))
    assert len(got) == len(want) == len(raws)
    for g, w in zip(got, want):
        assert is_device_batch(g) and set(g) == set(w)
        for k in w:
            assert isinstance(g[k], torch.Tensor)
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


def test_prefetcher_accepts_dict_batches():
    dicts = [feeder()(r) for r in raw_batches(n=3)]
    got = list(DevicePrefetcher(lambda: iter(dicts), prefetch_depth=1, device="cpu"))
    assert len(got) == 3 and all(is_device_batch(b) for b in got)
    np.testing.assert_array_equal(got[1]["x"].numpy(), dicts[1]["x"])


def test_prefetcher_propagates_worker_errors():
    def reader():
        yield raw_batches(n=1)[0]
        raise RuntimeError("boom in feeder thread")

    with pytest.raises(RuntimeError, match="boom in feeder thread"):
        list(DevicePrefetcher(reader, feeder(), prefetch_depth=1, device="cpu"))


def test_prefetcher_retries_a_transient_feed_error():
    stats.FT_EVENTS._counts.clear()
    with faults.inject("feeder_raise:step=1"):
        got = list(DevicePrefetcher(lambda: iter(raw_batches(n=3)), feeder(), device="cpu"))
    assert len(got) == 3 and stats.FT_EVENTS.get("feeder_retry") == 1
    with faults.inject("feeder_raise:1.0"):
        with pytest.raises(faults.InjectedFault):
            list(DevicePrefetcher(lambda: iter(raw_batches(n=1)), feeder(), device="cpu",
                                  feed_retries=1))


def test_prefetcher_clean_shutdown_on_early_exit():
    produced = []

    def reader():
        for i, r in enumerate(raw_batches(n=100)):
            produced.append(i)
            yield r

    before = threading.active_count()
    it = iter(DevicePrefetcher(lambda: reader(), feeder(), prefetch_depth=2, device="cpu"))
    next(it)
    it.close()
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before
    assert len(produced) < 100


def test_prefetcher_rejects_bad_depth_and_ragged_batches():
    with pytest.raises(ValueError, match="prefetch_depth"):
        DevicePrefetcher(lambda: iter(()), prefetch_depth=0, device="cpu")
    with pytest.raises(ValueError, match="stack_k"):
        DevicePrefetcher(lambda: iter(()), stack_k=0, device="cpu")
    ragged = {"x": [np.zeros(2), np.zeros(3)]}
    with pytest.raises(ValueError, match="ragged|inhomogeneous"):
        list(DevicePrefetcher(lambda: iter([ragged]), prefetch_depth=1, device="cpu"))


def test_is_device_batch_and_coerce():
    assert not is_device_batch({"x": np.zeros(3)})
    assert not is_device_batch({})
    assert not is_device_batch([torch.zeros(3)])
    assert is_device_batch({"x": torch.zeros(3)})
    out = coerce_batch({"a": [1, 2], "b": np.zeros(2), "c": torch.ones(1)})
    assert isinstance(out["a"], np.ndarray) and isinstance(out["c"], torch.Tensor)


def tiny_trainer(device="cpu"):
    tgraph.reset_name_scope()
    x = TL.Data("x", shape=(4,))
    lbl = TL.Data("label", shape=())
    logits = TL.Fc(TL.Fc(x, 16, act="relu"), 3, act=None)
    return SGDTrainer(TC.ClassificationCost(logits, lbl), Adam(learning_rate=0.02), seed=1,
                      device=device)


def test_trainer_trains_through_prefetcher():
    raws = raw_batches(n=8, bs=16)
    reader = DevicePrefetcher(lambda: iter(raws), feeder(), prefetch_depth=3, device="cpu")
    tr = tiny_trainer()
    passes = []
    tr.train(reader, num_passes=6,
             event_handler=lambda e: passes.append(e.metrics) if isinstance(e, EndPass) else None)
    assert len(passes) == 6 and passes[-1]["avg_cost"] < passes[0]["avg_cost"]
    res = tr.test(DevicePrefetcher(lambda: iter(raws), feeder(), device="cpu"))
    assert np.isfinite(res["cost"]) and res["samples"] == 8 * 16


def test_stacked_batches_apply_the_updates_of_single_steps():
    raws = raw_batches(n=7, bs=8)
    pf = DevicePrefetcher(lambda: iter(raws), feeder(), stack_k=3, device="cpu")
    items = list(pf)
    assert [type(b).__name__ for b in items] == ["StackedBatch"] * 2 + ["dict"]
    assert isinstance(items[0], StackedBatch) and items[0].k == 3
    assert tuple(items[0]["x"].shape) == (3, 8, 4)
    single, stacked = tiny_trainer(), tiny_trainer()
    single.train(lambda: iter([feeder()(r) for r in raws]), num_passes=2)
    ends = []
    stacked.train(pf, num_passes=2,
                  event_handler=lambda e: ends.append(e.batch_id)
                  if type(e).__name__ == "EndIteration" else None)
    assert ends == [2, 5, 6] * 2
    for k, v in single.state["params"].items():
        assert torch.equal(stacked.state["params"][k], v), k
    assert int(stacked.state["samples"]) == int(single.state["samples"]) == 2 * 7 * 8


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_prefetcher_lands_on_card_and_feeds_the_graph_bitwise(cuda):
    raws = raw_batches(n=6, bs=16)
    got = list(DevicePrefetcher(lambda: iter(raws), feeder(), device=cuda))
    assert all(v.is_cuda for b in got for v in b.values())
    np.testing.assert_array_equal(got[2]["x"].cpu().numpy(), feeder()(raws[2])["x"])
    placed = [{k: torch.from_numpy(np.asarray(v)).to(cuda) for k, v in feeder()(r).items()}
              for r in raws]
    a, b = tiny_trainer(cuda), tiny_trainer(cuda)
    a.train(DevicePrefetcher(lambda: iter(raws), feeder(), device=cuda), num_passes=2)
    b.train(lambda: iter(placed), num_passes=2)
    assert next(iter(a.graphs.values())).replays == 11
    for k, v in b.state["params"].items():
        assert torch.equal(a.state["params"][k], v), k
