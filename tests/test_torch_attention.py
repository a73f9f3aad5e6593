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
  * The route: `fused=None` takes the fused op for every static scale (the
    kernel tiles D and Dv: no shape limit is left, B past 65535 included);
    at D=512/Dv=64, D=16/Dv=257 and D=40/Dv=300 both `fused=None` and
    `fused=True` go through it and match the JAX jnp body (1e-5, grads
    rtol 1e-4 / atol 1e-5) and the JAX Pallas kernel in interpret mode
    (1e-5).
  * On a card (marked `cuda`, skipped here): the CUDA kernel vs its plain
    version (1e-4) at D in {8, 64, 100, 512} x Dv in {6, 64, 257, 300},
    Tq and Tk no multiples of a tile, fully masked rows, both mask shapes,
    and at B = 65536; scores of order 10, where 3xTF32 holds 1e-4 and one
    TF32 pass does not; `dot_product_attention` through the kernel,
    gradients included. jax is imported inside the CPU tests only."""

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


# head dims the kernel takes since it tiles D and Dv (the JAX package's
# _attn_fuse_ok takes them too at these sizes): b, tq, tk, d, dv
WIDE = [(1, 2, 3, 512, 64), (2, 5, 9, 16, 257), (2, 3, 9, 40, 300)]


@pytest.mark.parametrize("fused", [None, True])
@pytest.mark.parametrize("b,tq,tk,d,dv", WIDE)
def test_wide_head_dims_take_the_fused_op(monkeypatch, b, tq, tk, d, dv, fused):
    """D=512 or Dv=257/300 go through the fused op with fused=None and
    fused=True, and match the JAX package's jnp body (outputs 1e-5, grads
    rtol 1e-4 / atol 1e-5)."""
    q, k, v, mkv, mfull = _inputs(14, b, tq, tk, d, dv)
    calls = []
    real = tatt.attention_seq_fused
    monkeypatch.setattr(tatt, "attention_seq_fused", lambda *a: calls.append(1) or real(*a))
    for kw in ({"mask": mfull}, {"mask": mkv, "scale": 0.5}):
        want = _jax(q, k, v, kw, False, monkeypatch)
        np.testing.assert_allclose(_torch(q, k, v, kw, fused), want, rtol=1e-5, atol=1e-5)
    g_j = _jax(q, k, v, {"mask": mfull}, False, monkeypatch, grads=True)
    g_t = _torch(q, k, v, {"mask": mfull}, fused, grads=True)
    for name, a, w in zip("qkv", g_t, g_j):
        np.testing.assert_allclose(a, w, rtol=1e-4, atol=1e-5, err_msg=f"d{name}")
    assert calls == [1, 1, 1]


@pytest.mark.parametrize("case", ["kv", "full"])
@pytest.mark.parametrize("b,tq,tk,d,dv", WIDE)
def test_wide_head_dims_match_the_jax_kernel(monkeypatch, b, tq, tk, d, dv, case):
    """The same shapes against the JAX package's Pallas kernel in interpret
    mode, which its `_attn_fuse_ok` takes at these sizes (1e-5)."""
    import jax.numpy as jnp

    from paddle_tpu.ops.attention import _attn_fuse_ok

    q, k, v, mkv, mfull = _inputs(18, b, tq, tk, d, dv)
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "interpret")
    assert _attn_fuse_ok(*(jnp.asarray(x) for x in (q, k, v)), None)
    kw = _kw(case, mkv, mfull)
    want = _jax(q, k, v, kw, True, monkeypatch)
    np.testing.assert_allclose(_torch(q, k, v, kw, True), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,d,dv", [
    (3, 8, 6), (1, 64, 256), (1, 512, 64), (1, 16, 257), (65536, 8, 8),
])
def test_fused_none_takes_the_fused_op_for_every_static_scale(monkeypatch, b, d, dv):
    """No shape limit is left: fused=None sends every static scale to the
    fused op, B past 65535 included, and it matches the plain body."""
    tq, tk = (1, 2) if b > 1000 else (3, 5)
    q, k, v, mkv, _ = _inputs(15, b, tq, tk, d, dv)
    calls = []
    real = tatt.attention_seq_fused
    monkeypatch.setattr(tatt, "attention_seq_fused", lambda *a: calls.append(1) or real(*a))
    got = _torch(q, k, v, {"mask": mkv}, None)
    assert calls == [1]
    np.testing.assert_allclose(got, _torch(q, k, v, {"mask": mkv}, False), atol=1e-5)


def test_kernel_wrapper_rejects_cpu_tensors_and_bad_shapes():
    q, k, v, mkv, _ = _inputs(12)
    tq, tk, tv, tm = (torch.tensor(x) for x in (q, k, v, mkv))
    with pytest.raises(ValueError, match="CUDA"):
        K.attention_seq_fwd(tq, tk, tv, tm, 0.5)
    with pytest.raises(ValueError, match="mask must be"):
        K.attention_seq_fwd(tq, tk, tv, tm[:, :, :3].expand(-1, 2, -1), 0.5)
    with pytest.raises(ValueError, match="v must be"):
        K.attention_seq_fwd(tq, tk, tv[:, :3], tm, 0.5)
    # no head dim is too wide: a wide v is refused only for lying on the CPU
    wide = torch.zeros(tv.shape[:2] + (300,))
    with pytest.raises(ValueError, match="CUDA"):
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
    (2, 40, 90, 24, 200),   # four Dv blocks (3 x 64 + 8 columns)
    (1, 70, 130, 512, 1000),  # Dv blocks of several chunks each, key splits
    (140, 64, 40, 64, 130),   # three chunks a block, a grid that needs no split
    (1, 64, 1000, 64, 64),    # one block's keys split 16 ways
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
    # the key splits merge in a fixed order: a second call is bit-identical
    assert torch.equal(got, K.attention_seq_fwd(q, k, v, mask, 0.37))


def _card_inputs(cuda, seed, b, tq, tk, d, dv, per_row, qk_std=1.0):
    g = torch.Generator().manual_seed(seed)
    q, k = (torch.randn(s, generator=g) * qk_std for s in ((b, tq, d), (b, tk, d)))
    v = torch.randn((b, tk, dv), generator=g)
    mask = (torch.rand((b, tq if per_row else 1, tk), generator=g) > 0.3).float()
    mask[-1, -1, :] = 0.0  # a fully masked row (or every row of the last batch row)
    return [x.to(cuda) for x in (q, k, v, mask)]


def _kernel_vs_plain(q, k, v, mask, scale):
    before = K.ATTN_LAUNCHES
    got = K.attention_seq_fwd(q, k, v, mask, scale)
    want = K.attention_seq_fused_ref(q, k, v, mask, scale)
    torch.cuda.synchronize()
    assert K.ATTN_LAUNCHES == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("dv", [6, 64, 257, 300])
@pytest.mark.parametrize("d", [8, 64, 100, 512])
def test_cuda_any_head_dims_match_plain_version(cuda, d, dv, per_row):
    """D and Dv tiled: q/k chunks of 64 columns (q resident up to D=256,
    streamed past it), Dv chunks of up to 64 columns; Tq=70 and Tk=130 are
    no multiples of a tile (64), a row is fully masked, and the small grid
    splits the key tiles over blocks."""
    q, k, v, mask = _card_inputs(cuda, d + dv, 2, 70, 130, d, dv, per_row)
    _kernel_vs_plain(q, k, v, mask, 1.0 / d ** 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("per_row", [False, True])
def test_cuda_batch_past_65535(cuda, per_row):
    """B is folded into grid x: B = 65536 at tiny Tq/Tk/D."""
    q, k, v, mask = _card_inputs(cuda, 5, 65536, 2, 3, 4, 5, per_row)
    _kernel_vs_plain(q, k, v, mask, 0.5)


@pytest.mark.cuda
def test_cuda_3xtf32_holds_large_scores(cuda):
    """Scores of order 10 (q, k scaled by 3.2 at D=64, scale 1/8): the
    kernel's 3xTF32 products hold 1e-4, where one TF32 pass of the same
    products (the plain version with TF32 matmuls) misses it."""
    q, k, v, mask = _card_inputs(cuda, 41, 4, 200, 200, 64, 64, True, qk_std=3.2)
    got, want = _kernel_vs_plain(q, k, v, mask, 0.125)
    scores = torch.einsum("bqd,bkd->bqk", q, k) * 0.125
    assert float(scores.abs().mean()) > 5.0
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        one_pass = K.attention_seq_fused_ref(q, k, v, mask, 0.125)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert float((one_pass - want).abs().max()) > 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,d,dv", [(1, 1, 1, 512, 64), (2, 5, 9, 16, 257)])
def test_cuda_former_route_shapes_launch_the_kernel(cuda, b, tq, tk, d, dv):
    """Shapes that once went to the plain body (D=512 at Dv=64, Dv=257)
    launch the kernel with fused=None and fused=True; forward and
    gradients match the plain body on the CPU."""
    q, k, v, mkv, mfull = _inputs(17, b, tq, tk, d, dv)
    before = K.ATTN_LAUNCHES
    got = _torch(q, k, v, {"mask": mfull}, None, grads=True, device=cuda)
    out = _torch(q, k, v, {"mask": mkv}, True, device=cuda)
    torch.cuda.synchronize()
    assert K.ATTN_LAUNCHES == before + 2
    want = _torch(q, k, v, {"mask": mfull}, False, grads=True)
    for a, b2 in zip(got, want):
        np.testing.assert_allclose(a, b2, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out, _torch(q, k, v, {"mask": mkv}, False), atol=1e-4)


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
