"""jax.random's threefry in torch integer ops (`paddle_tpu_torch/core/prng.py`)
against jax.random itself, bit for bit: `PRNGKey`, `fold_in` (of Python
ints and of 0-d int32 tensors, the trainer's samples counter), the 32-bit
`random_bits` of the partitionable stream, `uniform` and `bernoulli`, for
several seeds and shapes (odd sizes, 0-d, sizes past one 2x32 block).

On the card (`cuda`, skipped elsewhere): the same bits from tensors on the
device, and `fold_in` of a device counter inside a captured CUDA graph
gives each replay the key of the counter's current value."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import prng

SEEDS = [0, 1, 7, -3, 2 ** 31 + 5, 123456789]
SHAPES = [(), (1,), (7,), (3, 5), (64, 33), (2, 3, 4)]


def _jax_key(seed):
    import jax

    return jax.random.PRNGKey(seed)


def _u32(x):
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_matches_jax(seed):
    assert prng.PRNGKey(seed).tolist() == _u32(_jax_key(seed)).tolist()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 1, 5, 2 ** 31 - 1, 3000017])
def test_fold_in_matches_jax(seed, data):
    import jax

    want = _u32(jax.random.fold_in(_jax_key(seed), data)).tolist()
    key = prng.PRNGKey(seed)
    assert prng.fold_in(key, data).tolist() == want
    assert prng.fold_in(key, torch.tensor(data, dtype=torch.int32)).tolist() == want


def test_fold_in_of_negative_int32_counter_matches_jax():
    import jax
    import jax.numpy as jnp

    want = _u32(jax.random.fold_in(_jax_key(3), jnp.int32(-1))).tolist()
    assert prng.fold_in(prng.PRNGKey(3), torch.tensor(-1, dtype=torch.int32)).tolist() == want


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("shape", SHAPES)
def test_random_bits_uniform_bernoulli_match_jax(seed, shape):
    import jax

    jk, key = _jax_key(seed), prng.PRNGKey(seed)
    assert np.array_equal(prng.random_bits(key, shape).numpy().astype(np.uint32),
                          np.asarray(jax.random.bits(jk, shape)))
    u = prng.uniform(key, shape).numpy()
    assert u.dtype == np.float32 and u.shape == shape
    assert np.array_equal(u.view(np.uint32),
                          np.asarray(jax.random.uniform(jk, shape)).view(np.uint32))
    for p in (0.5, 0.1, 0.9):
        assert np.array_equal(prng.bernoulli(key, p, shape).numpy(),
                              np.asarray(jax.random.bernoulli(jk, p, shape)))


def test_chained_keys_match_jax_dropout_derivation():
    """The key a Dropout layer draws from: fold_in(fold_in(fold_in(key,
    samples), hash(name)), count), as nn/graph.py derives it."""
    import jax

    from paddle_tpu_torch.nn.graph import _stable_hash

    jk, key = _jax_key(11), prng.PRNGKey(11)
    for samples, count in ((0, 1), (64, 2), (6400, 1)):
        j = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(jk, samples),
                                                  _stable_hash("drop6")), count)
        t = prng.fold_in(prng.fold_in(prng.fold_in(
            key, torch.tensor(samples, dtype=torch.int32)), _stable_hash("drop6")), count)
        assert t.tolist() == _u32(j).tolist()
        assert np.array_equal(prng.bernoulli(t, 0.5, (4, 9)).numpy(),
                              np.asarray(jax.random.bernoulli(j, 0.5, (4, 9))))


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_bits_equal_cpu_bits(cuda):
    for seed in SEEDS:
        key_c, key_g = prng.PRNGKey(seed), prng.PRNGKey(seed, cuda)
        for shape in SHAPES:
            assert torch.equal(prng.random_bits(key_g, shape).cpu(),
                               prng.random_bits(key_c, shape))
            assert torch.equal(prng.bernoulli(key_g, 0.5, shape).cpu(),
                               prng.bernoulli(key_c, 0.5, shape))


@pytest.mark.cuda
def test_cuda_fold_in_of_device_counter_replays_fresh(cuda):
    key = prng.PRNGKey(5, cuda)
    counter = torch.zeros((), dtype=torch.int32, device=cuda)
    prng.bernoulli(prng.fold_in(key, counter), 0.5, (16,))  # warm-up
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        mask = prng.bernoulli(prng.fold_in(key, counter), 0.5, (16,))
        counter.add_(8)
    seen = []
    for step in range(3):
        g.replay()
        want = prng.bernoulli(prng.fold_in(prng.PRNGKey(5), step * 8), 0.5, (16,))
        assert torch.equal(mask.cpu(), want)
        seen.append(mask.clone())
    assert not torch.equal(seen[0], seen[1])
