"""The 3-D layers in the port (`paddle_tpu_torch/nn/layers3d.py` over
`ops/conv.conv3d`, `conv3d_transpose`, `max_pool3d`, `avg_pool3d`; ROADMAP §1
item 6e) against the JAX package's, on the CPU.

  * tests/test_layers3d_beam.py's cases on the port: Conv3D against a
    direct window sum (also strided, padded, dilated and grouped), the
    transposed conv as the adjoint of the conv,
    max and average pooling against numpy reshapes.
  * Each layer in a graph of both packages, the JAX parameters (DHWIO)
    moved by name, the same NDHWC batch and cotangent: output within 1e-5,
    the input's and every parameter's gradient within 1e-4 x max(1,
    max|g|). Conv3D with stride, padding, dilation and groups; the
    transposed conv at stride 1 and 2; Pool3D max and average, with and
    without `ceil_mode` (asymmetric padding), with explicit padding.
  * On a card (`cuda`, skipped here): every case card against CPU in f32
    with TF32 off, within 1e-5 relative L2.
jax is imported inside the CPU tests only."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.nn import graph as tgraph
from paddle_tpu_torch.nn.convert import params_from_jax
from paddle_tpu_torch.ops import conv as tconv

TOL = 1e-5
GRAD_TOL = 1e-4
SHAPE = (2, 5, 6, 7, 4)  # B, D, H, W, C

CASES = {
    "conv": lambda L3, x, n: L3.Conv3D(x, 3, 2, name=n),
    "conv_strided_padded": lambda L3, x, n: L3.Conv3D(x, 5, (3, 2, 3), stride=(2, 1, 2),
                                                      padding=(1, 0, 1), act="relu", name=n),
    "conv_dilated_grouped": lambda L3, x, n: L3.Conv3D(x, 4, 2, dilation=2, groups=2,
                                                       bias=False, name=n),
    "deconv": lambda L3, x, n: L3.Conv3DTranspose(x, 3, 2, name=n),
    "deconv_strided": lambda L3, x, n: L3.Conv3DTranspose(x, 2, 3, stride=2, padding=1,
                                                          act="tanh", name=n),
    "max_pool": lambda L3, x, n: L3.Pool3D(x, 2, "max", name=n),
    "avg_pool": lambda L3, x, n: L3.Pool3D(x, 2, "avg", name=n),
    "max_pool_ceil": lambda L3, x, n: L3.Pool3D(x, 3, "max", stride=2, ceil_mode=True, name=n),
    "avg_pool_ceil_padded": lambda L3, x, n: L3.Pool3D(x, 3, "avg", stride=2, padding=1,
                                                       ceil_mode=True, name=n),
}


def _input(seed=0):
    return np.random.RandomState(seed).randn(*SHAPE).astype(np.float32)


def _ct(shape, seed=9):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.fixture(scope="module")
def jax_runs():
    """Every case in one JAX network (one input each, so each input's
    gradient is its own case's), initialised and differentiated in one
    compiled call each -> {case: (params, output, grads)}."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.nn import layers as JL
    from paddle_tpu.nn import layers3d as JL3
    from paddle_tpu.nn.graph import Network, reset_name_scope

    reset_name_scope()
    net = Network([build(JL3, JL.Data(f"x_{case}", shape=SHAPE[1:]), case)
                   for case, build in CASES.items()])
    x = _input()
    feed = {f"x_{case}": x for case in CASES}
    params, states = jax.jit(lambda key: net.init(key, feed))(jax.random.PRNGKey(0))

    def apply(p, xs):
        outs = net.apply(p, states, xs)[0]
        return {case: outs[case].value for case in CASES}

    cts = {c: jnp.asarray(_ct(o.shape)) for c, o in jax.eval_shape(apply, params, feed).items()}

    def f(p, xs):
        outs = apply(p, xs)
        return sum(jnp.sum(outs[c] * cts[c]) for c in CASES), outs

    (_, outs), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in feed.items()})
    runs = {}
    for case in CASES:
        own = [k for k in params if k.startswith(case + ".")]
        runs[case] = ({k: params[k] for k in own}, np.asarray(outs[case]),
                      {**{k: np.asarray(gp[k]) for k in own}, "input": np.asarray(gx[f"x_{case}"])})
    return runs


def _port_run(case, x, params, device="cpu"):
    from paddle_tpu_torch.nn import layers as TL
    from paddle_tpu_torch.nn import layers3d as TL3

    tgraph.reset_name_scope()
    net = tgraph.Network([CASES[case](TL3, TL.Data("x", shape=SHAPE[1:]), case)])
    tp = {k: v.requires_grad_(True) for k, v in params_from_jax(params, device=device).items()}
    xt = torch.from_numpy(x).to(device).requires_grad_(True)
    out = net.apply(tp or {"device": torch.zeros((), device=device)}, {"x": xt})[case].value
    ct = torch.from_numpy(_ct(out.shape)).to(device)
    grads = torch.autograd.grad((out * ct).sum(), list(tp.values()) + [xt])
    return out.detach().cpu().numpy(), {k: g.cpu().numpy()
                                        for k, g in zip(list(tp) + ["input"], grads)}


def _check(got, want, rtol=TOL):
    out, grads = got
    wout, wgrads = want
    np.testing.assert_allclose(out, wout, rtol=rtol, atol=rtol * max(1.0, np.abs(wout).max()))
    assert set(grads) == set(wgrads)
    for k, g in wgrads.items():
        scale = max(1.0, float(np.abs(g).max()))
        np.testing.assert_allclose(grads[k], g, rtol=GRAD_TOL, atol=GRAD_TOL * scale,
                                   err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_jax(jax_runs, case):
    params, out, grads = jax_runs[case]
    _check(_port_run(case, _input(), params), (out, grads))


def test_conv3d_transpose_is_the_adjoint():
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(1, 5, 5, 5, 2).astype(np.float32))
    w = torch.from_numpy(rs.randn(3, 3, 3, 2, 5).astype(np.float32) * 0.1)
    y = tconv.conv3d(x, w, stride=2, padding=1)
    u = torch.from_numpy(rs.randn(*y.shape).astype(np.float32))
    xt = tconv.conv3d_transpose(u, w, stride=2, padding=1)
    assert xt.shape == x.shape
    np.testing.assert_allclose(float((y * u).sum()), float((x * xt).sum()), rtol=1e-4)


def test_pools_match_numpy():
    x = np.random.RandomState(2).randn(2, 4, 4, 4, 3).astype(np.float32)
    blocks = x.reshape(2, 2, 2, 2, 2, 2, 2, 3)
    np.testing.assert_allclose(tconv.max_pool3d(torch.from_numpy(x), 2).numpy(),
                               blocks.max((2, 4, 6)), rtol=1e-6)
    np.testing.assert_allclose(tconv.avg_pool3d(torch.from_numpy(x), 2).numpy(),
                               blocks.mean((2, 4, 6)), rtol=1e-5)


@pytest.mark.parametrize("stride,padding,dilation,groups", [
    ((1, 1, 1), (0, 0, 0), (1, 1, 1), 1), ((2, 1, 2), (1, 0, 1), (1, 1, 1), 1),
    ((1, 1, 1), (1, 1, 1), (2, 2, 2), 2), ((2, 2, 2), (1, 1, 1), (1, 1, 1), 2)])
def test_conv3d_is_a_window_sum(stride, padding, dilation, groups):
    rs = np.random.RandomState(3)
    x = rs.randn(2, 6, 5, 7, 4).astype(np.float32)
    w = rs.randn(3, 2, 3, 4 // groups, 6).astype(np.float32)
    got = tconv.conv3d(torch.from_numpy(x), torch.from_numpy(w), stride, padding, dilation,
                       groups).numpy()
    xp = np.pad(x, [(0, 0)] + [(p, p) for p in padding] + [(0, 0)])
    cg, og = 4 // groups, 6 // groups
    want = np.zeros_like(got)
    for idx in np.ndindex(*got.shape[1:4]):
        lo = [i * s for i, s in zip(idx, stride)]
        win = xp[:, lo[0]:lo[0] + 2 * dilation[0] + 1:dilation[0],
                 lo[1]:lo[1] + dilation[1] + 1:dilation[1],
                 lo[2]:lo[2] + 2 * dilation[2] + 1:dilation[2]]
        for g in range(groups):
            want[(slice(None),) + idx + (slice(g * og, (g + 1) * og),)] = np.tensordot(
                win[..., g * cg:(g + 1) * cg], w[..., g * og:(g + 1) * og],
                axes=([1, 2, 3, 4], [0, 1, 2, 3]))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_layer_matches_cpu(cuda, case):
    from paddle_tpu_torch.nn import layers as TL
    from paddle_tpu_torch.nn import layers3d as TL3

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = _input()
    tgraph.reset_name_scope()
    net = tgraph.Network([CASES[case](TL3, TL.Data("x", shape=SHAPE[1:]), case)])
    params = {k: v.numpy() for k, v in net.init({"x": x}, device="cpu").items()}
    _check(_port_run(case, x, params, "cuda"), _port_run(case, x, params))
