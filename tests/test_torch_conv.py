"""The port's conv, pooling and batch-norm ops and the image layers
(`paddle_tpu_torch/ops/conv.py`, `ops/normalization.py`, `nn/layers.py`)
against the JAX package's, on the CPU, plus the dtype policy.

Same numpy inputs on both sides (seeded); JAX parameters and states move
across by name.

  * `conv2d` at kernels 1/3/5/7, strides 1/2, paddings 0-3, with its input
    and weight gradients: f32 within 1e-5 (relative to the largest value);
    a bf16 conv within bf16 resolution.
  * `max_pool2d` / `avg_pool2d` with symmetric pads and with the asymmetric
    pads of `Pool2D(ceil_mode=True)`, `global_avg_pool2d`: forward and
    input gradient within 1e-6.
  * `batch_norm_train` (y, mean, biased var) and its VJP against the JAX
    package's `custom_vjp`: f32 within 1e-5, bf16 input within bf16
    resolution (2e-2); `batch_norm_inference` within 1e-6.
  * Layers: Conv2D (bias, relu), Pool2D, BatchNorm (train mode moves the
    moving statistics by 0.9 / 0.1; eval mode and `use_global_stats` use
    them), Addto, GlobalPool, Reshape: outputs, input gradients and states.
  * `Fc` on a non-sequence input of more than two axes flattens it as the
    JAX package does: the JAX `fc.w` (12, 4) loads and the [5, 4] output
    matches within 1e-6.
  * The f32 conv the card takes (cuDNN forward and input gradient, the
    weight gradient as im2col + matmul) is F.conv2d's function: in float64
    on the CPU its gradients match autograd's, groups and dilation too.
  * On a card (marked `cuda`, skipped here): the same ops on the card
    against the CPU, f32 with TF32 off and bf16, the conv's output an
    NHWC view of cuDNN's channels_last result, and f32 conv gradients
    within 1e-5 of float64. jax is imported inside the CPU tests only."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import dtypes
from paddle_tpu_torch.core.stack_trace import LayerError
from paddle_tpu_torch.nn import graph as tgraph
from paddle_tpu_torch.nn import layers as TL
from paddle_tpu_torch.nn.convert import params_from_jax
from paddle_tpu_torch.ops import conv as tconv
from paddle_tpu_torch.ops import normalization as tnorm


def _close(got, want, tol, what=""):
    """max |got - want| <= tol * max(1, max |want|)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: max abs err {err} > {tol} x {scale}"


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


# -- dtype policy ---------------------------------------------------------------


def test_policy_names_cast_and_scope():
    assert dtypes.get(None) is dtypes.f32_policy() is dtypes.get("float32")
    assert dtypes.get("bf16") is dtypes.bf16_policy() is dtypes.get("mixed")
    with pytest.raises(ValueError, match="unknown dtype policy"):
        dtypes.get("fp8")
    bf = dtypes.bf16_policy()
    assert bf.name == "bf16" and dtypes.f32_policy().name == "f32"
    assert bf.accum_dtype == torch.bfloat16  # bf16 outputs, as the reference's _BF16
    assert bf.cast(torch.ones(2)).dtype == torch.bfloat16
    ints = torch.arange(3)
    assert bf.cast(ints) is ints
    assert dtypes.current() is dtypes.f32_policy()
    with dtypes.policy_scope(bf):
        assert dtypes.current() is bf
    assert dtypes.current() is dtypes.f32_policy()


def test_matmul_follows_the_policy():
    from paddle_tpu_torch.ops import linalg

    a, b = torch.randn(3, 4), torch.randn(4, 5)
    assert torch.equal(linalg.matmul(a, b), torch.matmul(a, b))
    out = linalg.matmul(a, b, dtypes.bf16_policy())
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, torch.matmul(a.bfloat16(), b.bfloat16()))
    # an f32 bias add promotes the bf16 product back to f32, as in JAX
    assert (out + torch.zeros(5)).dtype == torch.float32


# -- conv -----------------------------------------------------------------------

CONV_CASES = [  # kernel, stride, padding
    (1, 1, 0), (1, 2, 0), (3, 1, 1), (3, 2, 1), (3, 1, 0),
    (5, 1, 2), (5, 2, 3), (7, 2, 3), (7, 1, 0), (3, 2, 2),
]


@pytest.mark.parametrize("k,s,p", CONV_CASES)
def test_conv2d_matches_jax(k, s, p):
    import jax
    import jax.numpy as jnp

    from paddle_tpu.ops import conv as jconv

    rs = np.random.RandomState(k * 100 + s * 10 + p)
    x = rs.randn(2, 11, 9, 5).astype(np.float32)
    w = (rs.randn(k, k, 5, 6) / k).astype(np.float32)

    def jf(x, w):
        return jconv.conv2d(x, w, s, p)

    want = np.asarray(jf(jnp.asarray(x), jnp.asarray(w)))
    ct = rs.randn(*want.shape).astype(np.float32)
    jdx, jdw = jax.grad(lambda x, w: jnp.sum(jf(x, w) * ct), (0, 1))(
        jnp.asarray(x), jnp.asarray(w))

    tx, tw = _t(x, True), _t(w, True)
    out = tconv.conv2d(tx, tw, s, p)
    assert out.dtype == torch.float32
    assert tuple(out.shape) == (2, tconv.conv_out_size(11, k, s, p),
                                tconv.conv_out_size(9, k, s, p), 6)
    dx, dw = torch.autograd.grad((out * _t(ct)).sum(), (tx, tw))
    _close(out.detach(), want, 1e-5, "y")
    _close(dx, jdx, 1e-5, "dx")
    _close(dw, jdw, 1e-5, "dw")


WGRAD_CASES = [  # batch, in, out, size, kernel, stride, padding, dilation, groups
    (2, 1, 4, 9, 5, 1, 2, 1, 1), (3, 6, 8, 11, 3, 2, 1, 1, 2),
    (2, 4, 6, 10, 3, 1, 2, 2, 1), (2, 3, 5, 13, 7, 2, 3, 1, 1),
]


@pytest.mark.parametrize("b,cin,cout,h,k,s,p,d,g", WGRAD_CASES)
def test_f32_conv_function_matches_autograd(b, cin, cout, h, k, s, p, d, g):
    """The card's f32 conv (cuDNN forward and input gradient, weight
    gradient as im2col + matmul) is the same function as F.conv2d: run on
    the CPU in float64, it matches autograd's gradients to rounding."""
    gen = torch.Generator().manual_seed(k + g)
    x = torch.randn(b, cin, h, h, generator=gen, dtype=torch.float64, requires_grad=True)
    w = torch.randn(cout, cin // g, k, k, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    y = torch.nn.functional.conv2d(x, w, None, s, p, d, g)
    dy = torch.randn(y.shape, generator=gen, dtype=torch.float64)
    want = torch.autograd.grad(y, (x, w), dy)
    x2, w2 = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
    y2 = tconv._Conv2dF32.apply(x2, w2, (s, s), (p, p), (d, d), g)
    got = torch.autograd.grad(y2, (x2, w2), dy)
    assert torch.equal(y2, y)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=1e-12, atol=1e-12)


def test_conv2d_bf16_matches_jax():
    import jax.numpy as jnp

    from paddle_tpu.core import dtypes as jdtypes
    from paddle_tpu.ops import conv as jconv

    rs = np.random.RandomState(3)
    x = rs.randn(2, 8, 8, 16).astype(np.float32)
    w = (rs.randn(3, 3, 16, 8) / 12).astype(np.float32)
    want = jconv.conv2d(jnp.asarray(x), jnp.asarray(w), 1, 1, policy=jdtypes.bf16_policy())
    out = tconv.conv2d(_t(x), _t(w), 1, 1, policy=dtypes.bf16_policy())
    assert out.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    _close(out.float(), np.asarray(want, np.float32), 2e-2, "bf16 conv")


# -- pooling --------------------------------------------------------------------

POOL_CASES = [  # window, stride, padding, ceil_mode
    (2, None, 0, False), (3, 2, 1, False), (3, 1, 1, False), (2, 2, 0, True),
    (3, 2, 0, True), (3, 2, 1, True), ((3, 2), (2, 1), (1, 0), True),
]


def _pool_graphs(pool_type, window, stride, padding, ceil_mode):
    from paddle_tpu.nn import graph as jgraph
    from paddle_tpu.nn import layers as JL

    jgraph.reset_name_scope()
    jl = JL.Pool2D(JL.Data("x", shape=(9, 7, 3)), window, pool_type, stride=stride,
                   padding=padding, ceil_mode=ceil_mode, name="p")
    tgraph.reset_name_scope()
    tl = TL.Pool2D(TL.Data("x", shape=(9, 7, 3)), window, pool_type, stride=stride,
                   padding=padding, ceil_mode=ceil_mode, name="p")
    return jgraph.Network([jl]), tgraph.Network([tl])


@pytest.mark.parametrize("window,stride,padding,ceil_mode", POOL_CASES)
@pytest.mark.parametrize("pool_type", ["max", "avg"])
def test_pool2d_matches_jax(pool_type, window, stride, padding, ceil_mode):
    import jax
    import jax.numpy as jnp

    rs = np.random.RandomState(11)
    x = rs.randn(2, 9, 7, 3).astype(np.float32)
    jnet, tnet = _pool_graphs(pool_type, window, stride, padding, ceil_mode)
    jp, js = jnet.init(jax.random.PRNGKey(0), {"x": x})

    def jf(x):
        return jnet.apply(jp, js, {"x": x})[0]["p"].value

    want = np.asarray(jf(jnp.asarray(x)))
    ct = rs.randn(*want.shape).astype(np.float32)
    want_g = np.asarray(jax.grad(lambda x: jnp.sum(jf(x) * ct))(jnp.asarray(x)))
    tx = _t(x, True)
    out = tnet.apply({"x": tx}, {"x": tx})["p"].value
    (g,) = torch.autograd.grad((out * _t(ct)).sum(), tx)
    _close(out.detach(), want, 1e-6, "pool")
    _close(g, want_g, 1e-6, "pool grad")


@pytest.mark.parametrize("padding", [1, ((0, 1), (1, 2))])
def test_avg_pool2d_inclusive_matches_jax(padding):
    """exclusive=False divides by the window's size, pads included."""
    import jax.numpy as jnp

    from paddle_tpu.ops import conv as jconv

    x = np.random.RandomState(8).randn(2, 7, 6, 3).astype(np.float32)
    want = jconv.avg_pool2d(jnp.asarray(x), 3, 2, padding, exclusive=False)
    _close(tconv.avg_pool2d(_t(x), 3, 2, padding, exclusive=False), want, 1e-6, "avg")


def test_ceil_mode_pads_bottom_and_right():
    layer = TL.Pool2D(TL.Data("x", shape=(9, 7, 3)), 3, "max", stride=2, ceil_mode=True)
    assert layer._pads(torch.zeros(1, 9, 7, 3)) == ((0, 0), (0, 0))
    assert layer._pads(torch.zeros(1, 8, 6, 3)) == ((0, 1), (0, 1))


def test_global_avg_pool_matches_jax_f32_and_bf16():
    import jax.numpy as jnp

    from paddle_tpu.ops import conv as jconv

    rs = np.random.RandomState(5)
    x = rs.randn(3, 7, 7, 16).astype(np.float32)
    _close(tconv.global_avg_pool2d(_t(x)), jconv.global_avg_pool2d(jnp.asarray(x)),
           1e-6, "f32")
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jconv.global_avg_pool2d(xb), np.float32)
    got = tconv.global_avg_pool2d(_t(x).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


# -- batch norm -----------------------------------------------------------------

BN_SHAPES = [(4, 6, 5, 8), (16, 12), (2, 3, 3, 64)]


def _bn_inputs(shape, seed):
    rs = np.random.RandomState(seed)
    x = (rs.randn(*shape) * 1.5 + rs.randn(shape[-1]) * 2).astype(np.float32)
    gamma = (rs.rand(shape[-1]) + 0.5).astype(np.float32)
    beta = rs.randn(shape[-1]).astype(np.float32)
    dy = rs.randn(*shape).astype(np.float32)
    return x, gamma, beta, dy


def _jax_bn(x, gamma, beta, dy, dtype):
    import jax
    import jax.numpy as jnp

    from paddle_tpu.ops import normalization as jnorm

    xj = jnp.asarray(x, dtype)
    (y, mean, var), vjp = jax.vjp(
        lambda x, g, b: jnorm.batch_norm_train(x, g, b, 1e-5), xj,
        jnp.asarray(gamma), jnp.asarray(beta))
    dx, dg, db = vjp((jnp.asarray(dy, dtype), jnp.zeros_like(mean), jnp.zeros_like(var)))
    return [np.asarray(v, np.float32) for v in (y, mean, var, dx, dg, db)]


def _port_bn(x, gamma, beta, dy, dtype):
    tx = _t(x).to(dtype).requires_grad_(True)
    tg, tb = _t(gamma, True), _t(beta, True)
    y, mean, var = tnorm.batch_norm_train(tx, tg, tb, 1e-5)
    assert y.dtype == dtype and mean.dtype == var.dtype == torch.float32
    dx, dg, db = torch.autograd.grad(y, (tx, tg, tb), _t(dy).to(dtype))
    assert dx.dtype == dtype and dg.dtype == db.dtype == torch.float32
    return [v.detach().float().numpy() for v in (y, mean, var, dx, dg, db)]


@pytest.mark.parametrize("shape", BN_SHAPES)
def test_batch_norm_train_and_vjp_match_jax_f32(shape):
    import jax.numpy as jnp

    args = _bn_inputs(shape, sum(shape))
    want = _jax_bn(*args, jnp.float32)
    got = _port_bn(*args, torch.float32)
    for name, g, w in zip(("y", "mean", "var", "dx", "dgamma", "dbeta"), got, want):
        _close(g, w, 1e-5, name)
    # the variance is the biased one: sum((x - mean)^2) / n
    x = args[0].reshape(-1, shape[-1]).astype(np.float64)
    _close(got[2], x.var(axis=0), 1e-5, "biased var")


@pytest.mark.parametrize("shape", BN_SHAPES)
def test_batch_norm_train_and_vjp_match_jax_bf16(shape):
    import jax.numpy as jnp

    args = _bn_inputs(shape, sum(shape) + 1)
    want = _jax_bn(*args, jnp.bfloat16)
    got = _port_bn(*args, torch.bfloat16)
    # mean and var reduce the same bf16 values in f32 on both sides
    for name, g, w, tol in zip(("y", "mean", "var", "dx", "dgamma", "dbeta"), got, want,
                               (2e-2, 1e-5, 1e-5, 2e-2, 1e-4, 1e-4)):
        _close(g, w, tol, name)


def test_batch_norm_inference_matches_jax():
    import jax.numpy as jnp

    from paddle_tpu.ops import normalization as jnorm

    x, gamma, beta, _ = _bn_inputs((3, 4, 4, 8), 9)
    rs = np.random.RandomState(9)
    mean = rs.randn(8).astype(np.float32)
    var = (rs.rand(8) + 0.1).astype(np.float32)
    want = jnorm.batch_norm_inference(*map(jnp.asarray, (x, gamma, beta, mean, var)), 1e-5)
    got = tnorm.batch_norm_inference(*map(_t, (x, gamma, beta, mean, var)), 1e-5)
    _close(got, want, 1e-6, "inference")


# -- layers ---------------------------------------------------------------------


def _layer_graph(L, kind):
    """One small graph per layer kind, built from either package's layers."""
    x = L.Data("x", shape=(6, 5, 4))
    if kind == "conv":
        out = L.Conv2D(x, 7, 3, stride=2, padding=1, act="relu", name="c")
    elif kind == "batch_norm":
        out = L.BatchNorm(x, act="relu", name="bn")
    elif kind == "batch_norm_global":
        out = L.BatchNorm(x, use_global_stats=True, name="bn")
    elif kind == "addto":
        y = L.Conv2D(x, 4, 1, bias=False, name="c")
        out = L.Addto([x, y], act="relu", bias=True, name="add")
    elif kind == "global_pool":
        out = L.Fc(L.GlobalPool(x, "avg", name="gap"), 3, act=None, name="fc")
    elif kind == "global_max":
        out = L.GlobalPool(x, "max", name="gmp")
    else:  # reshape
        out = L.Fc(L.Reshape(x, (-1,), name="flat"), 3, act="tanh", name="fc")
    return out


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("kind", ["conv", "batch_norm", "batch_norm_global", "addto",
                                  "global_pool", "global_max", "reshape"])
def test_layer_matches_jax(kind, train):
    import jax
    import jax.numpy as jnp

    from paddle_tpu.nn import graph as jgraph
    from paddle_tpu.nn import layers as JL

    rs = np.random.RandomState(len(kind))
    x = (rs.randn(3, 6, 5, 4) + 0.5).astype(np.float32)
    jgraph.reset_name_scope()
    jl = _layer_graph(JL, kind)
    jnet = jgraph.Network([jl])
    jp, js = jnet.init(jax.random.PRNGKey(1), {"x": x})
    js = {k: jnp.asarray(rs.rand(*v.shape) + 0.5, jnp.float32) for k, v in js.items()}

    def jf(x):
        outs, ns = jnet.apply(jp, js, {"x": x}, train=train)
        return outs[jl.name].value, ns

    want, want_states = jf(jnp.asarray(x))
    ct = rs.randn(*want.shape).astype(np.float32)
    want_g = jax.grad(lambda x: jnp.sum(jf(x)[0] * ct))(jnp.asarray(x))

    tgraph.reset_name_scope()
    tl = _layer_graph(TL, kind)
    tnet = tgraph.Network([tl])
    tp, ts = tnet.init({"x": x}, device="cpu", with_states=True)
    assert set(tp) == set(jp) and set(ts) == set(js)
    tx = _t(x, True)
    # a graph without parameters or states takes its device from the input
    params = params_from_jax(jp, device="cpu") or {"x": tx}
    outs, new_states = tnet.apply(params, {"x": tx}, params_from_jax(js, device="cpu"),
                                  train=train)
    out = outs[tl.name].value
    (g,) = torch.autograd.grad((out * _t(ct)).sum(), tx)
    _close(out.detach(), want, 1e-5, "out")
    _close(g, want_g, 1e-5, "grad")
    assert set(new_states) == set(want_states)
    for k in want_states:
        _close(new_states[k], want_states[k], 1e-6, k)


def test_batch_norm_layer_moves_and_uses_its_statistics():
    x = np.random.RandomState(2).randn(8, 4, 4, 3).astype(np.float32) * 2 + 1
    tgraph.reset_name_scope()
    bn = TL.BatchNorm(TL.Data("x", shape=(4, 4, 3)), name="bn")
    net = tgraph.Network([bn])
    params, states = net.init({"x": x}, device="cpu", with_states=True)
    assert sorted(params) == ["bn.bias", "bn.scale"]
    assert torch.equal(states["bn.moving_mean"], torch.zeros(3))
    assert torch.equal(states["bn.moving_var"], torch.ones(3))
    _, new = net.apply(params, {"x": x}, states, train=True)
    flat = x.reshape(-1, 3).astype(np.float64)
    _close(new["bn.moving_mean"], 0.1 * flat.mean(0), 1e-6, "mean")
    _close(new["bn.moving_var"], 0.9 + 0.1 * flat.var(0), 1e-6, "var")
    assert torch.equal(states["bn.moving_mean"], torch.zeros(3))  # inputs untouched
    outs, same = net.apply(params, {"x": x}, new, train=False)
    assert same == new  # eval mode leaves the statistics
    want = (x - new["bn.moving_mean"].numpy()) / np.sqrt(new["bn.moving_var"].numpy() + 1e-5)
    _close(outs["bn"].value, want, 1e-5, "eval output")
    # without states, apply returns the outputs alone and needs none here
    with pytest.raises(LayerError, match=r"error in layer 'bn' .*bn.moving_mean"):
        net.apply(params, {"x": x})


def test_fc_flattens_a_feature_map_like_jax():
    """A non-sequence [B, 2, 2, 3] input: JAX makes fc.w (12, 4) and outputs
    [5, 4]; the port loads that weight and matches."""
    import jax

    from paddle_tpu.nn import graph as jgraph
    from paddle_tpu.nn import layers as JL

    x = np.random.RandomState(4).randn(5, 2, 2, 3).astype(np.float32)
    jgraph.reset_name_scope()
    jfc = JL.Fc(JL.Data("x", shape=(2, 2, 3)), 4, act=None, name="fc")
    jnet = jgraph.Network([jfc])
    jp, js = jnet.init(jax.random.PRNGKey(0), {"x": x})
    assert jp["fc.w"].shape == (12, 4)
    want = np.asarray(jnet.apply(jp, js, {"x": x})[0]["fc"].value)
    assert want.shape == (5, 4)

    tgraph.reset_name_scope()
    tfc = TL.Fc(TL.Data("x", shape=(2, 2, 3)), 4, act=None, name="fc")
    tnet = tgraph.Network([tfc])
    assert tuple(tnet.init({"x": x}, device="cpu")["fc.w"].shape) == (12, 4)
    got = tnet.apply(params_from_jax(jp, device="cpu"), {"x": x})["fc"].value
    assert tuple(got.shape) == (5, 4)
    _close(got, want, 1e-6, "fc")


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the card's conv, pool and batch-norm paths")
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


@pytest.mark.cuda
@pytest.mark.parametrize("k,s,p", CONV_CASES)
def test_cuda_conv2d_matches_cpu(cuda, k, s, p):
    rs = np.random.RandomState(k + s + p)
    x = torch.tensor(rs.randn(4, 17, 13, 32).astype(np.float32))
    w = torch.tensor((rs.randn(k, k, 32, 48) / (3 * k)).astype(np.float32))
    want = tconv.conv2d(x, w, s, p)
    xc, wc = x.to(cuda).requires_grad_(True), w.to(cuda).requires_grad_(True)
    got = tconv.conv2d(xc, wc, s, p)
    # NHWC view of cuDNN's channels_last output: contiguous, no copy made
    assert got.is_contiguous()
    _close(got.detach().cpu(), want, 1e-5, "f32")
    ct = torch.randn(got.shape, device=cuda)
    dx, dw = torch.autograd.grad((got * ct).sum(), (xc, wc))
    assert dx.is_contiguous()
    xr, wr = x.requires_grad_(True), w.requires_grad_(True)
    ex, ew = torch.autograd.grad((tconv.conv2d(xr, wr, s, p) * ct.cpu()).sum(), (xr, wr))
    _close(dx.cpu(), ex, 1e-5, "dx")
    _close(dw.cpu(), ew, 1e-4, "dw")
    bf = tconv.conv2d(xc.detach(), wc.detach(), s, p, policy=dtypes.bf16_policy())
    assert bf.dtype == torch.bfloat16
    _close(bf.float().cpu(), want, 3e-2, "bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,h,k", [(1, 32, 28, 5), (32, 64, 14, 5), (3, 64, 64, 7)])
def test_cuda_f32_conv_gradients_hold_f32(cuda, cin, cout, h, k):
    """Against float64 on the card: LeNet's convs and ResNet's stem. cuDNN's
    own weight-gradient algorithm for one input channel missed the CPU by
    ~5e-4 with TF32 off; the port's f32 path holds 1e-5 (relative L2)."""
    gen = torch.Generator().manual_seed(cin)
    x = torch.randn(8, h, h, cin, generator=gen)
    w = torch.randn(k, k, cin, cout, generator=gen) * 0.2
    ct = torch.randn(8, h, h, cout, generator=gen)

    def run(dtype):
        xc = x.to(cuda, dtype).requires_grad_(True)
        wc = w.to(cuda, dtype).requires_grad_(True)
        pol = dtypes.Policy(dtype, dtype, dtype)
        y = tconv.conv2d(xc, wc, 1, k // 2, policy=pol)
        return [t.double().cpu() for t in (y,) + torch.autograd.grad(
            (y * ct.to(cuda, dtype)).sum(), (xc, wc))]

    for what, got, want in zip(("y", "dx", "dw"), run(torch.float32), run(torch.float64)):
        err = float((got - want).norm() / want.norm())
        assert err <= 1e-5, (what, err)


@pytest.mark.cuda
@pytest.mark.parametrize("window,stride,padding,ceil_mode", POOL_CASES)
@pytest.mark.parametrize("pool_type", ["max", "avg"])
def test_cuda_pool2d_matches_cpu(cuda, pool_type, window, stride, padding, ceil_mode):
    x = torch.randn(4, 9, 7, 16, generator=torch.Generator().manual_seed(3))
    layer = TL.Pool2D(TL.Data("x", shape=(9, 7, 16)), window, pool_type, stride=stride,
                      padding=padding, ceil_mode=ceil_mode)
    pool = tconv.max_pool2d if pool_type == "max" else tconv.avg_pool2d
    pads = layer._pads(x)
    want = pool(x, window, stride, pads)
    _close(pool(x.to(cuda), window, stride, pads).cpu(), want, 1e-6, "pool")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BN_SHAPES + [(32, 14, 14, 256)])
def test_cuda_batch_norm_matches_cpu(cuda, shape, dtype):
    x, gamma, beta, dy = _bn_inputs(shape, 7)

    def run(dev):
        tx = _t(x).to(dev, dtype).requires_grad_(True)
        tg, tb = _t(gamma).to(dev).requires_grad_(True), _t(beta).to(dev).requires_grad_(True)
        y, mean, var = tnorm.batch_norm_train(tx, tg, tb, 1e-5)
        grads = torch.autograd.grad(y, (tx, tg, tb), _t(dy).to(dev, dtype))
        return [v.detach().float().cpu() for v in (y, mean, var) + grads]

    # the statistics sum n = 6 272 values a channel (at the last shape) in
    # another order on each device; with channel means up to 4 standard
    # deviations out, var = s2 / n - mean^2 keeps fewer bits (measured on an
    # H100: var 3.0e-5 f32 / 1.3e-4 bf16 apart, y and dx 1.1e-5 f32)
    tol = 5e-5 if dtype == torch.float32 else 2e-2
    errs = {}
    for name, g, w in zip(("y", "mean", "var", "dx", "dgamma", "dbeta"),
                          run(cuda), run("cpu")):
        errs[name] = float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
    limits = dict(y=tol, dx=tol, mean=1e-3, var=1e-3, dgamma=1e-3, dbeta=1e-3)
    assert all(errs[k] <= limits[k] for k in errs), sorted(errs.items())
