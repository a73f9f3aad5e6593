"""The PyDataProvider2 surface of the port (`paddle_tpu_torch/data/provider.py`),
mirroring tests/test_provider.py, and held against the JAX package's
providers: the same samples in the same order (the pool shuffle and the
ratio mixing draw from the same seeded `random.Random` streams)."""

import numpy as np
import pytest

from paddle_tpu_torch.data import DataFeeder, dense_vector, integer_value
from paddle_tpu_torch.data.provider import (
    CacheType, DataProviderConverter, DataProviderWrapper, DoubleBuffer, MultiDataProvider,
    provider,
)


def test_provider_decorator_and_types():
    @provider(input_types={"x": dense_vector(4), "y": integer_value(3)},
              should_shuffle=False, check=True)
    def process(settings, filename):
        assert settings.input_types is not None
        for i in range(5):
            yield {"x": np.full(4, i, np.float32), "y": i % 3}

    assert isinstance(process, DataProviderWrapper)
    samples = list(process(file_list=["f0", "f1"]))
    assert len(samples) == 10
    b = DataFeeder(process.input_types)(samples[:4])
    assert b["x"].shape == (4, 4) and b["y"].dtype == np.int32


def test_provider_check_rejects_bad_sample_or_skips_it():
    @provider(input_types=[dense_vector(4)], should_shuffle=False, check=True)
    def bad(settings, filename):
        yield (np.zeros(3, np.float32),)

    with pytest.raises(ValueError):
        list(bad(file_list=["f"]))

    @provider(input_types=[dense_vector(4)], should_shuffle=False, check=True,
              check_fail_continue=True)
    def mixed(settings, filename):
        yield (np.zeros(3, np.float32),)
        yield (np.zeros(4, np.float32),)

    assert len(list(mixed(file_list=["f"]))) == 1


def test_provider_init_hook_and_cache():
    calls = []

    def init_hook(settings, obj, file_list, **kw):
        calls.append(file_list)
        settings.scale = 2.0

    @provider(input_types=[dense_vector(1)], init_hook=init_hook, should_shuffle=False,
              cache=CacheType.CACHE_PASS_IN_MEM)
    def process(settings, filename):
        for i in range(3):
            yield (np.array([i * settings.scale], np.float32),)

    first = list(process(file_list=["a"]))
    second = list(process(file_list=["a"]))
    assert [s[0][0] for s in first] == [0.0, 2.0, 4.0]
    assert [s[0][0] for s in second] == [0.0, 2.0, 4.0]
    assert len(calls) >= 1


def test_shuffled_provider_and_mixing_match_jax():
    from paddle_tpu.data.feeder import dense_vector as jdense
    from paddle_tpu.data.provider import MultiDataProvider as JaxMulti
    from paddle_tpu.data.provider import provider as jprovider

    def gen(settings, filename):
        for i in range(50):
            yield (np.array([i], np.float32), filename)

    tp = provider(input_types=[dense_vector(1)], pool_size=16)(gen)
    jp = jprovider(input_types=[jdense(1)], pool_size=16)(gen)
    for _ in range(2):  # the shuffle differs per pass, the same way
        got = [(float(s[0][0]), s[1]) for s in tp(file_list=["a", "b"])]
        want = [(float(s[0][0]), s[1]) for s in jp(file_list=["a", "b"])]
        assert got == want and len(got) == 100
    assert [float(s[0][0]) for s in tp(file_list=["a"], is_train=False)] == list(range(50))
    a = lambda: iter([("a", i) for i in range(30)])  # noqa: E731
    b = lambda: iter([("b", i) for i in range(10)])  # noqa: E731
    assert list(MultiDataProvider([(a, 3.0), (b, 1.0)], seed=4)()) == \
        list(JaxMulti([(a, 3.0), (b, 1.0)], seed=4)())


def test_multi_data_provider_ratio():
    a = lambda: iter([("a",)] * 300)  # noqa: E731
    b = lambda: iter([("b",)] * 100)  # noqa: E731
    mixed = list(MultiDataProvider([(a, 3.0), (b, 1.0)])())
    assert len(mixed) == 400
    n_a = sum(1 for s in mixed[:100] if s[0] == "a")
    assert 55 <= n_a <= 95


def test_double_buffer_matches_sync():
    def reader():
        for i in range(20):
            yield [(np.full(2, i, np.float32), i % 2)] * 3

    feeder = DataFeeder({"x": dense_vector(2), "y": integer_value(2)})
    sync = [feeder(r) for r in reader()]
    buffered = list(DoubleBuffer(reader, feeder, capacity=2))
    assert len(buffered) == len(sync)
    for s, bch in zip(sync, buffered):
        np.testing.assert_array_equal(s["x"], bch["x"])


def test_double_buffer_propagates_errors():
    def reader():
        yield [(np.zeros(2, np.float32), 0)]
        raise RuntimeError("boom")

    feeder = DataFeeder({"x": dense_vector(2), "y": integer_value(2)})
    with pytest.raises(RuntimeError, match="boom"):
        list(DoubleBuffer(reader, feeder))


def test_converter_list_and_dict_types():
    conv = DataProviderConverter([dense_vector(2), integer_value(5)], names=["img", "lbl"])
    out = conv([(np.ones(2, np.float32), 4)])
    assert out["img"].shape == (1, 2) and out["lbl"][0] == 4
    conv2 = DataProviderConverter({"a": dense_vector(3)})
    assert conv2([(np.zeros(3, np.float32),)])["a"].shape == (1, 3)


def test_as_reader_plugs_into_the_trainer():
    from paddle_tpu_torch.data import reader as rd
    from paddle_tpu_torch.nn import costs as TC
    from paddle_tpu_torch.nn import graph as tgraph
    from paddle_tpu_torch.nn import layers as TL
    from paddle_tpu_torch.optim import SGD
    from paddle_tpu_torch.trainer import SGDTrainer

    types = {"x": dense_vector(4), "label": integer_value(3)}

    @provider(input_types=types, should_shuffle=False)
    def process(settings, filename):
        rs = np.random.RandomState(0)
        for i in range(32):
            yield {"x": rs.randn(4).astype(np.float32), "label": i % 3}

    tgraph.reset_name_scope()
    x, lbl = TL.Data("x", shape=(4,)), TL.Data("label", shape=())
    tr = SGDTrainer(TC.ClassificationCost(TL.Fc(x, 3, act=None), lbl),
                    SGD(learning_rate=0.1), device="cpu")
    feed = DataFeeder(types)
    tr.train(rd.batch(process.as_reader(file_list=["f"]), 8),
             feeder=lambda samples: feed([[s["x"], s["label"]] for s in samples]))
    assert int(tr.state["samples"]) == 32
