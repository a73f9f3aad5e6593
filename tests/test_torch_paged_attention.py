"""The port's ragged paged-attention decode: plain version, wrapper, build.

  * `paged_attention_decode_ref` (the port's plain version) matches the JAX
    package's Pallas kernel — run in interpret mode, as the JAX package's
    own tests run it on the CPU — and its dense-gather oracle, at
    atol=1e-5 (f32 on both sides; the online softmax reassociates sums),
    over the cases of tests/test_decode_fastpath.py: shuffled physical
    pages, partly filled pages, an empty slot at position 0 with an
    all-dump table.
  * The wrapper takes the plain version for CPU tensors only, without
    counting a launch, and never for tensors elsewhere.
  * The wrapper's input checks and the nvcc build recipe.
  * On a card (marked `cuda`, skipped here): the CUDA kernel vs the plain
    version on the same tensors."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import build
from paddle_tpu_torch.ops import paged_attention as pa

CASES = [(0, 8, 4), (1, 4, 7), (2, 16, 3)]


def _inputs(seed, ps, pmax, S=5, H=2, HD=8):
    """The inputs of test_decode_fastpath.test_kernel_matches_oracle_mixed_lengths."""
    rng = np.random.RandomState(seed)
    NP = 1 + pmax * S
    KD = H * HD
    q = rng.randn(S, KD).astype(np.float32)
    kp = rng.randn(NP, ps, KD).astype(np.float32)
    vp = rng.randn(NP, ps, KD).astype(np.float32)
    bt = np.zeros((S, pmax), np.int32)
    free = list(rng.permutation(np.arange(1, NP)))
    positions = np.zeros(S, np.int32)
    for s_ in range(S - 1):  # last slot stays empty (dump table, position 0)
        n = rng.randint(1, pmax + 1)
        pages = [free.pop() for _ in range(n)]
        bt[s_, :n] = pages
        positions[s_] = rng.randint(0, n * ps)
    return q, kp, vp, bt, positions, 1.0 / np.sqrt(HD), H


def _port(q, kp, vp, bt, positions, scale, h, fn=pa.paged_attention_decode_ref):
    return fn(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(bt), torch.from_numpy(positions),
        scale=scale, n_heads=h,
    ).numpy()


@pytest.mark.parametrize("seed,ps,pmax", CASES)
def test_plain_version_matches_jax_kernel_interpret(seed, ps, pmax):
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas import interpret_mode
    from paddle_tpu.ops.pallas.paged_attention import paged_attention_decode

    assert interpret_mode(), "the JAX kernel must run in interpret mode here"
    q, kp, vp, bt, positions, scale, h = _inputs(seed, ps, pmax)
    want = paged_attention_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(positions), scale=scale, n_heads=h,
    )
    got = _port(q, kp, vp, bt, positions, scale, h)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("seed,ps,pmax", CASES)
def test_plain_version_matches_jax_oracle(seed, ps, pmax, monkeypatch):
    import jax.numpy as jnp

    from paddle_tpu.serving.model import LMConfig, ServableLM

    # the JAX model's own dense-gather path (Pallas off), not a copy of it
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "0")
    q, kp, vp, bt, positions, scale, h = _inputs(seed, ps, pmax)
    jm = ServableLM(LMConfig(vocab=8, d_model=q.shape[1], n_heads=h))
    assert jm.scale == pytest.approx(scale)
    want = jm._paged_attention_local(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(positions), n_heads=h,
    )
    got = _port(q, kp, vp, bt, positions, scale, h)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("seed,ps,pmax", CASES)
def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing(seed, ps, pmax):
    args = _inputs(seed, ps, pmax)
    before = pa.LAUNCHES
    got = _port(*args, fn=pa.paged_attention_decode)
    np.testing.assert_array_equal(got, _port(*args))
    assert pa.LAUNCHES == before


def test_wrapper_never_falls_back_off_the_cpu():
    q, kp, vp, bt, positions, scale, h = (
        torch.from_numpy(a) if isinstance(a, np.ndarray) else a
        for a in _inputs(0, 8, 4)
    )
    meta = [t.to("meta") for t in (q, kp, vp, bt, positions)]
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_attention_decode(*meta, scale=scale, n_heads=h)


def _tensors(seed=0, ps=8, pmax=4):
    q, kp, vp, bt, positions, _, h = _inputs(seed, ps, pmax)
    return [torch.from_numpy(a) for a in (q, kp, vp, bt, positions)], h


@pytest.mark.parametrize("broken,err", [
    (lambda t: [t[0].double()] + t[1:], TypeError),                    # q f64
    (lambda t: t[:3] + [t[3].long(), t[4]], TypeError),                # table i64
    (lambda t: t[:4] + [t[4].long()], TypeError),                      # positions i64
    (lambda t: [t[0].t().contiguous().t()] + t[1:], ValueError),       # q strided
    (lambda t: [t[0]] + [t[1][:, :, :8].contiguous()] + t[2:], ValueError),  # KD
    (lambda t: t[:3] + [t[3][:3]] + t[4:], ValueError),                # table rows
    (lambda t: t[:4] + [t[4][:2]], ValueError),                        # positions
])
def test_kernel_input_checks(broken, err):
    t, h = _tensors()
    pa.check_inputs(*t, h)  # the well-formed inputs pass
    with pytest.raises(err):
        pa.check_inputs(*broken(t), h)


def test_kernel_rejects_head_dim_over_256():
    q = torch.zeros(2, 512)
    kp = torch.zeros(3, 4, 512)
    bt = torch.zeros(2, 2, dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="head_dim"):
        pa.check_inputs(q, kp, kp, bt, pos, 1)
    pa.check_inputs(q, kp, kp, bt, pos, 2)  # head_dim 256 is fine


def test_build_recipe():
    cmd = build.nvcc_command("nvcc", "paged_attention", build.BUILD_DIR / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert {"-shared", "-O3", "-fPIC"} <= set(cmd)
    assert cmd[-1].endswith("paddle_tpu_torch/csrc/paged_attention.cu")
    path = build.library_path("paged_attention")
    # keyed by source + flags: stable across calls, inside the checkout
    assert path == build.library_path("paged_attention")
    assert path.parent == build.BUILD_DIR
    assert build.BUILD_DIR.parent.parent == build.PACKAGE_DIR.parent
    assert set(build.KERNELS) == {p.stem for p in build.CSRC_DIR.glob("*.cu")}


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    real_is_file = build.Path.is_file
    monkeypatch.setattr(
        build.Path, "is_file",
        lambda self: False if self.name == "nvcc" else real_is_file(self),
    )
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed,ps,pmax", CASES)
def test_cuda_kernel_matches_plain_version(cuda, seed, ps, pmax):
    q, kp, vp, bt, positions, scale, h = _inputs(seed, ps, pmax)
    t = [torch.from_numpy(a).to(cuda) for a in (q, kp, vp, bt, positions)]
    before = pa.LAUNCHES
    got = pa.paged_attention_decode(*t, scale=scale, n_heads=h)
    want = pa.paged_attention_decode_ref(*t, scale=scale, n_heads=h)
    torch.cuda.synchronize()
    assert pa.LAUNCHES == before + 1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
