"""The port's readers and DataFeeder against the JAX package's, on the CPU.

Every reader combinator yields the same samples in the same order as the
JAX package's on the same input (exact; `shuffle` under the same `random`
seed), and `DataFeeder` builds the same batch dict, key for key, dtype for
dtype and value for value (exact), `seq_bucket` padding and truncation
included."""

import random

import numpy as np
import pytest

from paddle_tpu.data import feeder as jfeed
from paddle_tpu.data import reader as jrd
from paddle_tpu_torch.data import feeder as tfeed
from paddle_tpu_torch.data import reader as trd


def numbers(n=23):
    return lambda: iter(range(n))


def letters():
    return iter("abcdefghijklmnopqrstuvw")


def pairs():
    return iter([(i, -i) for i in range(23)])


CASES = {
    "batch": lambda rd: rd.batch(numbers(), 5),
    "batch_drop_last": lambda rd: rd.batch(numbers(), 5, drop_last=True),
    "shuffle": lambda rd: rd.shuffle(numbers(), 7),
    "buffered": lambda rd: rd.buffered(numbers(), 3),
    "chain": lambda rd: rd.chain(numbers(4), letters, numbers(3)),
    "compose": lambda rd: rd.compose(numbers(), letters),
    "compose_tuples": lambda rd: rd.compose(pairs, letters),
    "compose_unchecked": lambda rd: rd.compose(numbers(30), letters,
                                               check_alignment=False),
    "firstn": lambda rd: rd.firstn(numbers(), 9),
    "cache": lambda rd: rd.cache(numbers()),
    "map_readers": lambda rd: rd.map_readers(lambda a, b: f"{a}{b}", numbers(), letters),
    "xmap_ordered": lambda rd: rd.xmap_readers(lambda x: x * x, numbers(), 3, 4,
                                               order=True),
    "batch_of_shuffled": lambda rd: rd.batch(rd.shuffle(numbers(40), 16), 6),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_combinator_matches_jax(name):
    out = []
    for rd in (jrd, trd):
        random.seed(0)
        reader = CASES[name](rd)
        out.append([list(reader()), list(reader())])  # two passes
    assert out[1] == out[0]


def test_xmap_unordered_yields_the_same_set():
    got = [sorted(rd.xmap_readers(lambda x: x + 1, numbers(), 4, 2)()) for rd in (jrd, trd)]
    assert got[1] == got[0] == list(range(1, 24))


def test_compose_misaligned_raises_like_jax():
    for rd in (jrd, trd):
        with pytest.raises(rd.ComposeNotAligned):
            list(rd.compose(numbers(30), letters)())


def test_buffered_reraises_the_producer_error():
    def bad():
        yield 1
        raise KeyError("boom")

    for rd in (jrd, trd):
        with pytest.raises(KeyError):
            list(rd.buffered(bad, 2)())


def test_cache_ignores_a_partial_first_pass():
    calls = []

    def src():
        calls.append(1)
        return iter(range(5))

    c = trd.cache(src)
    assert next(iter(c())) == 0  # abandoned after one sample
    assert list(c()) == list(range(5)) and list(c()) == list(range(5))
    assert len(calls) == 2


def _samples(rs, n=6):
    out = []
    for i in range(n):
        t = rs.randint(1, 12)
        out.append({
            "vec": rs.randn(4).astype(np.float32).tolist(),
            "img": rs.randn(2, 3).astype(np.float32).tolist(),
            "label": int(rs.randint(0, 5)),
            "ids": rs.randint(0, 50, t).tolist(),
            "ids_b": rs.randint(0, 50, t).tolist(),
            "frames": rs.randn(t, 3).astype(np.float32).tolist(),
            "sub": [rs.randint(0, 9, rs.randint(1, 4)).tolist()
                    for _ in range(rs.randint(1, 4))],
            "dsub": [rs.randn(rs.randint(1, 3), 2).astype(np.float32).tolist()
                     for _ in range(rs.randint(1, 3))],
            "bits": sorted(set(rs.randint(0, 10, 3).tolist())),
            "kv": [(int(j), float(rs.randn())) for j in sorted(set(rs.randint(0, 10, 2)))],
        })
        if i == 0:
            out[-1]["ids"] = list(range(20))  # longer than the bucket: truncated
    return out


def _feeding(m):
    return {
        "vec": m.dense_vector(4),
        "img": m.dense_array((2, 3)),
        "label": m.integer_value(5),
        "ids": m.InputSpec("index_seq", 50, seq_bucket=[4, 8, 16]),
        "ids_b": m.integer_value_sequence(50),
        "frames": m.dense_vector_sequence(3),
        "sub": m.integer_value_sub_sequence(9),
        "dsub": m.dense_vector_sub_sequence(2),
        "bits": m.sparse_binary_vector(10),
        "kv": m.sparse_value_slot(10),
    }


@pytest.mark.parametrize("as_tuples", [False, True])
def test_data_feeder_matches_jax(as_tuples):
    samples = _samples(np.random.RandomState(3))
    if as_tuples:
        names = list(_feeding(jfeed))
        samples = [tuple(s[n] for n in names) for s in samples]
    want = jfeed.DataFeeder(_feeding(jfeed))(samples)
    got = tfeed.DataFeeder(_feeding(tfeed))(samples)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # sample 0's 20 ids are cut to the largest bucket, 16
    assert got["ids"].shape[1] == 16 and got["ids.lengths"][0] == 16


@pytest.mark.parametrize("n", [1, 7, 9, 33])
def test_bucket_length_matches_jax(n):
    for buckets in (None, [4, 8, 16]):
        assert tfeed._bucket_len(n, buckets) == jfeed._bucket_len(n, buckets)


def test_feeder_rejects_what_jax_rejects():
    spec_t = {"a": tfeed.integer_value(3), "b": tfeed.integer_value(3)}
    with pytest.raises(ValueError, match="fields"):
        tfeed.DataFeeder(spec_t)([(1,)])
    with pytest.raises(ValueError, match="empty subsequence"):
        tfeed.DataFeeder({"s": tfeed.integer_value_sub_sequence(4)})([{"s": [[1], []]}])
    with pytest.raises(ValueError, match="unknown input kind"):
        tfeed.DataFeeder({"x": tfeed.InputSpec("nope")})([{"x": 1}])
