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
  * The wrapper's input checks, the split plan and its run choice
    (`split_tiles`: every visible token in exactly one split, live splits
    that follow the position, at contexts of 1 to P*PS tokens and S = 1, 5,
    8, 32) and the nvcc build recipe.
  * On a card (marked `cuda`, skipped here): the CUDA kernel vs the plain
    version on the same tensors, over head dims, page sizes and slot
    counts, with a dump slot and positions past the table's reach, and at
    GPT-2 small's decode shapes at short (16-34 tokens) and full contexts;
    two calls bit-identical."""

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


@pytest.mark.parametrize("s,h,hd,ps,pmax,sms", [
    (8, 12, 64, 16, 64, 132), (32, 12, 64, 16, 64, 132), (1, 12, 64, 16, 64, 132),
    (5, 2, 8, 4, 7, 132), (5, 6, 40, 1, 96, 132), (3, 2, 256, 32, 3, 132),
    (7, 5, 48, 8, 37, 16), (64, 16, 128, 16, 128, 132), (1, 1, 6, 3, 1, 8),
])
def test_split_plan_covers_every_page_once(s, h, hd, ps, pmax, sms):
    plan = pa.split_plan(s, h, hd, ps, pmax, sms)
    hg = plan.heads_per_block
    assert h % hg == 0 and hg * hd <= pa.MAX_BLOCK_WIDTH
    # the largest head group that fits: one more head would not
    assert all(h % d or d * hd > pa.MAX_BLOCK_WIDTH for d in range(hg + 1, h + 1))
    tt = plan.tile_tokens
    assert 8 <= tt <= 64 and tt & (tt - 1) == 0  # a power of two
    assert plan.tiles_per_split * tt <= 2048  # a split's pool rows fit on chip
    tiles = -(-pmax * ps // tt)
    assert plan.n_splits <= tiles <= plan.n_splits * plan.tiles_per_split
    # at the table's reach every split is live, and every page's tokens are
    # walked once: each page once
    runs = pa.split_tiles(plan, pmax * ps)
    assert all(runs) and all(len(r) <= plan.tiles_per_split for r in runs)
    tokens = sorted(t for r in runs for a, b in r for t in range(a, b))
    assert tokens == list(range(pmax * ps))
    # the grid aims at ~4 blocks an SM, or one tile a split when that is fewer
    blocks = s * (h // hg) * plan.n_splits
    assert blocks >= min(4 * sms, s * (h // hg) * tiles)
    assert plan.scratch_floats(s, h * hd, h) == s * plan.n_splits * (h * hd + 2 * h)


_GPT2 = dict(n_heads=12, head_dim=64, page_size=16, pages_per_seq=64, sms=132)


@pytest.mark.parametrize("n_tok", [1, 16, 17, 25, 34, 48, 200, 1024])
@pytest.mark.parametrize("s", [1, 5, 8, 32])
def test_split_tiles_cover_every_visible_token_once(s, n_tok):
    """The kernel's run choice (mirrored by `split_tiles`): at any context
    every visible token is walked by exactly one split, in tiles of TT, in
    order; the live splits are the first ones and follow the position: one
    a tile for a short slot (at most min(RT, NC) tiles: at S = 8 and 32 the
    decode profile's 16-34 tokens), else ceil(tiles / RT) runs of at most
    RT tiles."""
    plan = pa.split_plan(s, **_GPT2)
    tt, rt, nc = plan.tile_tokens, plan.tiles_per_split, plan.n_splits
    runs = pa.split_tiles(plan, n_tok)
    assert len(runs) == nc
    tokens = [t for r in runs for a, b in r for t in range(a, b)]
    assert tokens == list(range(n_tok))
    assert all(b - a <= tt and a % tt == 0 for r in runs for a, b in r)
    tiles = -(-n_tok // tt)
    short = tiles <= min(rt, nc)
    live = [c for c, r in enumerate(runs) if r]
    assert live == list(range(tiles if short else -(-tiles // rt)))
    assert all(len(r) <= (1 if short else rt) for r in runs)
    if s in (8, 32) and n_tok <= 34:
        assert short


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


def _check_cuda(cuda, q, kp, vp, bt, positions, scale, h):
    """Kernel vs plain version on the card (one launch counted), and a
    second call bit-identical to the first."""
    t = [torch.from_numpy(a).to(cuda) for a in (q, kp, vp, bt, positions)]
    before = pa.LAUNCHES
    got = pa.paged_attention_decode(*t, scale=scale, n_heads=h)
    want = pa.paged_attention_decode_ref(*t, scale=scale, n_heads=h)
    torch.cuda.synchronize()
    assert pa.LAUNCHES == before + 1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    again = pa.paged_attention_decode(*t, scale=scale, n_heads=h)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,ps,pmax", CASES)
def test_cuda_kernel_matches_plain_version(cuda, seed, ps, pmax):
    _check_cuda(cuda, *_inputs(seed, ps, pmax))


# head dims (with H so that a block holds one to several heads, and hd=6
# for the 4-byte copies of rows that are not 16-byte aligned) x page sizes;
# the slot count cycles through 1, 5, 8, 32
_HEADS = {6: 3, 8: 4, 40: 6, 64: 12, 128: 4, 256: 2}
_SPLIT_CASES = [(hd, ps, (1, 5, 8, 32)[i % 4])
                for i, (hd, ps) in enumerate((hd, ps) for hd in _HEADS
                                             for ps in (1, 4, 16, 32))]


@pytest.mark.cuda
@pytest.mark.parametrize("hd,ps,s", _SPLIT_CASES)
def test_cuda_split_kernel_matches_plain_version(cuda, hd, ps, s):
    pmax = max(2, 96 // ps)  # up to 96 tokens: several runs and tiles
    _check_cuda(cuda, *_inputs(hd + ps + s, ps, pmax, S=s, H=_HEADS[hd], HD=hd))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 5, 8, 32])
def test_cuda_positions_past_the_tables_reach(cuda, s):
    """Every slot but the dump slot has a full table and a position past its
    reach: it sees all P*PS tokens, as the plain version's mask does."""
    q, kp, vp, bt, positions, scale, h = _inputs(s, 16, 8, S=s + 1, H=12, HD=64)
    n_pages = kp.shape[0]
    bt[:s] = np.arange(1, 1 + s * 8, dtype=np.int32).reshape(s, 8) % (n_pages - 1) + 1
    positions[:s] = 8 * 16 + np.arange(s)
    _check_cuda(cuda, q, kp, vp, bt, positions, scale, h)


@pytest.mark.cuda
@pytest.mark.parametrize("context", ["short", "long"])
@pytest.mark.parametrize("s", [1, 5, 8, 32])
def test_cuda_short_and_long_contexts(cuda, s, context):
    """GPT-2 small's decode shapes (H=12, hd=64, PS=16, P=64): positions
    15-33 (a slot's tiles one to a split) or 960-1023 (every split live)."""
    q, kp, vp, bt, positions, scale, h = _inputs(40 + s, 16, 64, S=s, H=12, HD=64)
    lo, hi = (15, 33) if context == "short" else (960, 1023)
    rng = np.random.RandomState(s)
    n_pages = kp.shape[0]
    for i in range(s):
        n = hi // 16 + 1
        bt[i, :n] = rng.permutation(np.arange(1, n_pages))[:n]
        positions[i] = rng.randint(lo, hi + 1)
    _check_cuda(cuda, q, kp, vp, bt, positions, scale, h)
