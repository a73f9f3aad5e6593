"""The port's scaled dot-product attention (`paddle_tpu_torch/ops/attention.
dot_product_attention`, `ops/rnn_kernels.attention_seq_fused`) against the
JAX package's, on the CPU.

Same numpy inputs on both sides (seeded), (B, Tq, Tk, D, Dv) = (3, 5, 7, 8,
6) as tests/test_pallas_rnn.py draws them: no mask, a [B,1,Tk] mask, a
[B,Tq,Tk] mask with a fully masked row, an explicit scale.

  * Forward against the JAX function with `fused=False` (its jnp body) and
    `fused=True` (the Pallas kernel in interpret mode), with the port's
    fused op and its plain body: 1e-5, the JAX package's own tolerance.
  * q/k/v gradients through both of the port's paths against both of the
    JAX package's: rtol 1e-4 / atol 1e-5.
  * bf16 inputs: the output stays bf16 and tracks the JAX function within
    atol 2e-2 (bf16 resolution; the softmax is f32 on both sides).
  * The route: `fused=None` takes the fused op only where the kernel takes
    the shape (`attention_seq_fits`: Dv <= 256, its tiles within 227 KB of
    shared memory, B <= 65535); at D=40, Dv=300 both `fused=None` and
    `fused=False` run the plain body and match the JAX body (1e-5, grads
    rtol 1e-4 / atol 1e-5); `fused=True` there raises a ValueError that
    names the limit.
  * On a card (marked `cuda`, skipped here): the CUDA kernel vs its plain
    version (1e-4), including a fully masked row; the shapes the kernel
    does not take (q, k [1,1,512] with v [1,1,64]; Dv=257) through
    `fused=None` launch nothing and match the plain body; the shared-memory
    copy equals the library's. jax is imported inside the CPU tests
    only."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import attention as tatt
from paddle_tpu_torch.ops import rnn_kernels as K


def _inputs(seed=7, b=3, tq=5, tk=7, d=8, dv=6):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, tq, d).astype(np.float32)
    k = rs.randn(b, tk, d).astype(np.float32)
    v = rs.randn(b, tk, dv).astype(np.float32)
    mask_kv = (rs.rand(b, 1, tk) > 0.3).astype(np.float32)
    mask_full = (rs.rand(b, tq, tk) > 0.3).astype(np.float32)
    mask_full[min(1, b - 1), min(2, tq - 1), :] = 0.0  # a fully masked row
    return q, k, v, mask_kv, mask_full


CASES = ["none", "kv", "full", "kv_scale"]


def _kw(case, mask_kv, mask_full):
    return {"none": {}, "kv": {"mask": mask_kv}, "full": {"mask": mask_full},
            "kv_scale": {"mask": mask_kv, "scale": 0.5}}[case]


def _jax(q, k, v, kw, fused, monkeypatch, grads=False):
    import jax
    import jax.numpy as jnp

    from paddle_tpu.ops.attention import dot_product_attention

    monkeypatch.setenv("PADDLE_TPU_PALLAS", "interpret")
    kw = {n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x) for n, x in kw.items()}
    f = lambda q_, k_, v_: dot_product_attention(q_, k_, v_, fused=fused, **kw)
    args = [jnp.asarray(x) for x in (q, k, v)]
    if not grads:
        return np.asarray(f(*args).astype(jnp.float32))
    return [np.asarray(g) for g in
            jax.grad(lambda *a: jnp.sum(f(*a) ** 2), argnums=(0, 1, 2))(*args)]


def _torch(q, k, v, kw, fused, grads=False, device="cpu"):
    kw = {n: (torch.tensor(x, device=device) if isinstance(x, np.ndarray) else x)
          for n, x in kw.items()}
    ts = [torch.tensor(x, device=device, requires_grad=grads) for x in (q, k, v)]
    out = tatt.dot_product_attention(*ts, fused=fused, **kw)
    if not grads:
        return out.detach().float().cpu().numpy()
    return [g.cpu().numpy() for g in torch.autograd.grad((out ** 2).sum(), ts)]


@pytest.mark.parametrize("jax_fused", [False, True])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_forward_matches_jax(monkeypatch, case, fused, jax_fused):
    q, k, v, mkv, mfull = _inputs()
    kw = _kw(case, mkv, mfull)
    want = _jax(q, k, v, kw, jax_fused, monkeypatch)
    got = _torch(q, k, v, kw, fused)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("jax_fused", [False, True])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("case", ["kv", "full"])
def test_grads_match_jax(monkeypatch, case, fused, jax_fused):
    q, k, v, mkv, mfull = _inputs(8)
    kw = _kw(case, mkv, mfull)
    want = _jax(q, k, v, kw, jax_fused, monkeypatch, grads=True)
    got = _torch(q, k, v, kw, fused, grads=True)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("fused", [False, True])
def test_bf16_inputs_f32_softmax(monkeypatch, fused):
    import jax.numpy as jnp

    from paddle_tpu.ops.attention import dot_product_attention

    q, k, v, mkv, _ = _inputs(9)
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "interpret")
    want = dot_product_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                                 mask=jnp.asarray(mkv), fused=fused)
    tb = [torch.tensor(x).to(torch.bfloat16) for x in (q, k, v)]
    got = tatt.dot_product_attention(*tb, mask=torch.tensor(mkv), fused=fused)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=2e-2)
    tb = [x.requires_grad_(True) for x in tb]
    out = tatt.dot_product_attention(*tb, mask=torch.tensor(mkv), fused=fused)
    grads = torch.autograd.grad(out.float().sum(), tb)
    assert all(g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all() for g in grads)


def test_fused_ref_matches_jax_oracle():
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas.rnn_kernels import _attn_oracle

    q, k, v, _, mfull = _inputs(10)
    want = np.asarray(_attn_oracle(0.3, *(jnp.asarray(x) for x in (q, k, v, mfull))))
    got = K.attention_seq_fused_ref(*(torch.tensor(x) for x in (q, k, v, mfull)), 0.3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_dispatch_and_launch_count(monkeypatch):
    """fused=None takes the fused op for a static scale and the plain body
    for a tensor scale; on the CPU no kernel launches."""
    q, k, v, mkv, _ = _inputs(11)
    calls = []
    real = tatt.attention_seq_fused
    monkeypatch.setattr(tatt, "attention_seq_fused", lambda *a: calls.append(1) or real(*a))
    before = K.ATTN_LAUNCHES
    tq, tk, tv, tm = (torch.tensor(x) for x in (q, k, v, mkv))
    tatt.dot_product_attention(tq, tk, tv, mask=tm)
    tatt.dot_product_attention(tq, tk, tv, mask=tm, scale=0.25)
    assert calls == [1, 1]
    tatt.dot_product_attention(tq, tk, tv, mask=tm, scale=torch.tensor(0.25))
    tatt.dot_product_attention(tq, tk, tv, fused=False)
    assert calls == [1, 1] and K.ATTN_LAUNCHES == before


@pytest.mark.parametrize("fused", [None, False])
def test_wide_value_dims_take_the_plain_body(monkeypatch, fused):
    """D=40, Dv=300: past the kernel's Dv, so fused=None runs the plain
    body, as the JAX package's `_attn_fuse_ok` sends it to the jnp body."""
    q, k, v, mkv, mfull = _inputs(14, b=2, tq=3, tk=9, d=40, dv=300)
    calls = []
    real = tatt.attention_seq_fused
    monkeypatch.setattr(tatt, "attention_seq_fused", lambda *a: calls.append(1) or real(*a))
    for kw in ({"mask": mfull}, {"mask": mkv, "scale": 0.5}):
        want = _jax(q, k, v, kw, False, monkeypatch)
        np.testing.assert_allclose(_torch(q, k, v, kw, fused), want, rtol=1e-5, atol=1e-5)
    g_j = _jax(q, k, v, {"mask": mfull}, False, monkeypatch, grads=True)
    g_t = _torch(q, k, v, {"mask": mfull}, fused, grads=True)
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    assert calls == []


@pytest.mark.parametrize("b,d,dv,fits,limit", [
    (3, 8, 6, True, None),
    (1, 64, 256, True, None),
    (1, 512, 64, False, "shared memory"),  # tiles of 296 192 bytes
    (1, 16, 257, False, "Dv <= 256"),
    (65536, 8, 8, False, "B <= 65535"),
])
def test_fit_names_the_limit(b, d, dv, fits, limit):
    assert K.attention_seq_fits(b, d, dv) is fits
    misfit = K.attention_seq_misfit(b, d, dv)
    assert (misfit is None) is fits
    if limit:
        assert limit in misfit
    assert K.attention_seq_smem_bytes(512, 64) == 296192


@pytest.mark.parametrize("fits", [True, False])
def test_fused_none_routes_by_the_fit(monkeypatch, fits):
    q, k, v, mkv, _ = _inputs(15)
    calls, asked = [], []
    real = tatt.attention_seq_fused
    monkeypatch.setattr(tatt, "attention_seq_fused", lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(tatt, "attention_seq_fits", lambda *a: asked.append(a) or fits)
    _torch(q, k, v, {"mask": mkv}, None)
    assert asked == [(3, 8, 6)] and calls == ([1] if fits else [])


@pytest.mark.parametrize("d,dv", [(512, 64), (16, 257)])
def test_fused_true_raises_where_the_kernel_does_not_fit(d, dv):
    q, k, v, mkv, _ = _inputs(16, b=1, tq=1, tk=1, d=d, dv=dv)
    with pytest.raises(ValueError, match="fused=True.*(shared memory|Dv <= 256)"):
        _torch(q, k, v, {"mask": mkv}, True)


def test_kernel_wrapper_rejects_cpu_tensors_and_bad_shapes():
    q, k, v, mkv, _ = _inputs(12)
    tq, tk, tv, tm = (torch.tensor(x) for x in (q, k, v, mkv))
    with pytest.raises(ValueError, match="CUDA"):
        K.attention_seq_fwd(tq, tk, tv, tm, 0.5)
    with pytest.raises(ValueError, match="mask must be"):
        K.attention_seq_fwd(tq, tk, tv, tm[:, :, :3].expand(-1, 2, -1), 0.5)
    with pytest.raises(ValueError, match="v must be"):
        K.attention_seq_fwd(tq, tk, tv[:, :3], tm, 0.5)
    wide = torch.zeros(tv.shape[:2] + (K.ATTN_MAX_DV + 1,))
    with pytest.raises(ValueError, match="Dv <= 256"):
        K.attention_seq_fwd(tq, tk, wide, tm, 0.5)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda")


CARD_SHAPES = [  # b, tq, tk, d, dv
    (3, 5, 7, 8, 6),
    (2, 70, 130, 17, 33),   # ragged q and key tiles, odd widths
    (4, 64, 64, 64, 64),
    (2, 40, 90, 24, 200),   # four column chunks of the accumulator
]


@pytest.mark.cuda
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("b,tq,tk,d,dv", CARD_SHAPES)
def test_cuda_kernel_matches_plain_version(cuda, b, tq, tk, d, dv, per_row):
    g = torch.Generator().manual_seed(b * tq + tk)
    q, k, v = (torch.randn(s, generator=g).to(cuda)
               for s in ((b, tq, d), (b, tk, d), (b, tk, dv)))
    mask = (torch.rand((b, tq if per_row else 1, tk), generator=g) > 0.3).float()
    mask[0, 0, :] = 0.0  # a fully masked row (or every row of batch 0)
    mask = mask.to(cuda)
    before = K.ATTN_LAUNCHES
    got = K.attention_seq_fwd(q, k, v, mask, 0.37)
    want = K.attention_seq_fused_ref(q, k, v, mask, 0.37)
    torch.cuda.synchronize()
    assert K.ATTN_LAUNCHES == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,d,dv", [(1, 1, 1, 512, 64), (2, 5, 9, 16, 257)])
def test_cuda_shapes_without_a_fit_take_the_plain_body(cuda, b, tq, tk, d, dv):
    """Where the kernel does not take the shape, fused=None computes through
    the plain body (no launch) and fused=True raises before any launch."""
    q, k, v, mkv, mfull = _inputs(17, b, tq, tk, d, dv)
    before = K.ATTN_LAUNCHES
    got = _torch(q, k, v, {"mask": mfull}, None, grads=True, device=cuda)
    out = _torch(q, k, v, {"mask": mkv}, None, device=cuda)
    torch.cuda.synchronize()
    assert K.ATTN_LAUNCHES == before
    want = _torch(q, k, v, {"mask": mfull}, False, grads=True)
    for a, b2 in zip(got, want):
        np.testing.assert_allclose(a, b2, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out, _torch(q, k, v, {"mask": mkv}, False), atol=1e-4)
    with pytest.raises(ValueError, match="fused=True"):
        _torch(q, k, v, {"mask": mkv}, True, device=cuda)
    assert K.ATTN_LAUNCHES == before


@pytest.mark.cuda
def test_cuda_smem_copy_matches_the_library(cuda):
    fn = K._entry("attention_seq", "attention_seq_smem_bytes", 0, (K._I, K._I))
    for d in (1, 8, 17, 64, 255, 256, 512, 1000):
        for dv in (1, 6, 64, 200, 256):
            assert fn(d, dv) == K.attention_seq_smem_bytes(d, dv), (d, dv)


@pytest.mark.cuda
def test_cuda_dot_product_attention_goes_through_the_kernel(cuda):
    q, k, v, mkv, mfull = _inputs(13)
    before = K.ATTN_LAUNCHES
    got = _torch(q, k, v, {"mask": mfull}, None, grads=True, device=cuda)
    out = _torch(q, k, v, {"mask": mkv}, None, device=cuda)
    assert K.ATTN_LAUNCHES == before + 2
    want = _torch(q, k, v, {"mask": mfull}, False, grads=True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out, _torch(q, k, v, {"mask": mkv}, False), atol=1e-4)
    bf = [torch.tensor(x, device=cuda).to(torch.bfloat16) for x in (q, k, v)]
    assert tatt.dot_product_attention(*bf).dtype == torch.bfloat16
