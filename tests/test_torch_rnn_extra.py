"""`SimpleRnn` and `MDLstm` in the port (`paddle_tpu_torch/ops/rnn.py`
`simple_rnn_scan`, `ops/mdlstm.py`, `nn/recurrent.py`; ROADMAP §1 item 6d)
against the JAX package's, on the CPU.

  * `mdlstm_2d` against the JAX package's per-cell oracle and against its
    own `mdlstm_2d`, in all four direction pairs (tests/test_layers3d_beam.py's
    case): 1e-5; `_skew` / `_unskew` against the JAX package's.
  * Each layer in a graph of both packages (SimpleRnn behind a Fc, MDLstm
    on the projected grid itself), the JAX parameters moved by name, the
    same batch and cotangent: output within
    1e-5, every gradient (parameters and input) within 1e-4 x max(1,
    max|g|). SimpleRnn forward and reverse, tanh and relu, with and
    without its bias, over ragged lengths; MDLstm in each direction pair.
  * MDLstm's gradients are finite and reach `w_h` (the JAX test's check).
  * On a card (`cuda`, skipped here): every case card against CPU.
jax is imported inside the CPU tests only."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.nn import graph as tgraph
from paddle_tpu_torch.nn.convert import params_from_jax
from paddle_tpu_torch.ops import mdlstm as tmd

TOL = 1e-5
GRAD_TOL = 1e-4
DIRECTIONS = [(True, True), (False, True), (True, False), (False, False)]


def _md_params(module, rs, hid):
    return module.MDLstmParams(
        w_h=rs.randn(hid, 5 * hid).astype(np.float32) * 0.3,
        bias=rs.randn(5 * hid).astype(np.float32) * 0.1,
        check_i=rs.randn(hid).astype(np.float32) * 0.1,
        check_f=rs.randn(2, hid).astype(np.float32) * 0.1,
        check_o=rs.randn(hid).astype(np.float32) * 0.1)


@pytest.mark.parametrize("directions", DIRECTIONS)
def test_mdlstm_matches_jax_and_the_per_cell_oracle(directions):
    import jax
    import jax.numpy as jnp

    from paddle_tpu.ops import mdlstm as jmd

    rs = np.random.RandomState(3)
    hid = 4
    proj = rs.randn(2, 3, 5, 5 * hid).astype(np.float32) * 0.5
    jp = _md_params(jmd, rs, hid)
    tp = tmd.MDLstmParams(*(torch.from_numpy(np.asarray(v)) for v in jp))
    got = tmd.mdlstm_2d(torch.from_numpy(proj), tp, directions).numpy()
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jmd.mdlstm_2d(jnp.asarray(proj), jp, directions))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, jmd.mdlstm_2d_reference(proj, jp, directions),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tmd.mdlstm_2d_reference(proj, tp, directions),
                               jmd.mdlstm_2d_reference(proj, jp, directions))


def test_skew_and_unskew_match_jax():
    from paddle_tpu.ops import mdlstm as jmd

    x = np.random.RandomState(0).randn(2, 3, 4, 5).astype(np.float32)
    sk = tmd._skew(torch.from_numpy(x))
    np.testing.assert_array_equal(sk.numpy(), np.asarray(jmd._skew(x)))
    np.testing.assert_array_equal(tmd._unskew(sk, 4).numpy(), x)


def _rnn(R, L, x, n, **kw):
    return R.SimpleRnn(L.Fc(x, 6, act=None, name=f"{n}_proj"), name=n, **kw)


def _md(R, L, x, n, directions):
    return R.MDLstm(x, size=3, directions=directions, name=n)


CASES = {
    "rnn_tanh": lambda R, L, d, n: _rnn(R, L, d["seq"], n),
    "rnn_reverse": lambda R, L, d, n: _rnn(R, L, d["seq"], n, reverse=True),
    "rnn_relu_no_bias": lambda R, L, d, n: _rnn(R, L, d["seq"], n, act="relu", bias=False),
    **{f"mdlstm_{int(a)}{int(b)}": (lambda R, L, d, n, dirs=(a, b): _md(R, L, d["grid"], n,
                                                                        dirs))
       for a, b in DIRECTIONS},
}


def _data(L, suffix=""):
    return {"seq": L.Data(f"seq{suffix}", shape=(None, 5), is_seq=True),
            "grid": L.Data(f"grid{suffix}", shape=(3, 4, 15))}


def _batch(case, seed=0):
    rs = np.random.RandomState(seed)
    if case.startswith("rnn"):
        return {"seq": rs.randn(4, 7, 5).astype(np.float32),
                "seq.lengths": np.array([7, 3, 5, 1], np.int32)}
    return {"grid": rs.randn(2, 3, 4, 15).astype(np.float32)}


def _ct(shape, seed=9):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.fixture(scope="module")
def jax_runs():
    """Every case in one JAX network (inputs of their own, so each input's
    gradient is its own case's), initialised and differentiated in one
    compiled call each -> {case: (params, output, grads)}."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.nn import layers as JL
    from paddle_tpu.nn import recurrent as JR
    from paddle_tpu.nn.graph import Network, reset_name_scope

    reset_name_scope()
    net = Network([build(JR, JL, _data(JL, f"_{case}"), case) for case, build in CASES.items()])
    feed, keys = {}, {}
    for case in CASES:
        for k, v in _batch(case).items():
            feed[k.replace(".", f"_{case}.") if "." in k else f"{k}_{case}"] = v
        keys[case] = next(k for k in feed if k.endswith(case))
    xs0 = {keys[c]: jnp.asarray(feed[keys[c]]) for c in CASES}

    def apply(p, xs):
        outs = net.apply(p, states, {**feed, **xs}, train=True)[0]
        return {c: outs[c].value for c in CASES}

    with jax.default_matmul_precision("highest"):
        params, states = jax.jit(lambda k: net.init(k, feed))(jax.random.PRNGKey(0))
        cts = {c: jnp.asarray(_ct(o.shape)) for c, o in jax.eval_shape(apply, params, xs0).items()}

        def f(p, xs):
            outs = apply(p, xs)
            return sum(jnp.sum(outs[c] * cts[c]) for c in CASES), outs

        (_, outs), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
            params, xs0)
    runs = {}
    for case in CASES:
        own = [k for k in params if k.split(".")[0] in (case, f"{case}_proj")]
        runs[case] = ({k: params[k] for k in own}, np.asarray(outs[case]),
                      {**{k: np.asarray(gp[k]) for k in own}, "input": np.asarray(gx[keys[case]])})
    return runs


def _port_run(case, batch, params, device="cpu"):
    from paddle_tpu_torch.nn import layers as TL
    from paddle_tpu_torch.nn import recurrent as TR

    tgraph.reset_name_scope()
    net = tgraph.Network([CASES[case](TR, TL, _data(TL), case)])
    tp = {k: v.requires_grad_(True) for k, v in params_from_jax(params, device=device).items()}
    key = next(k for k in batch if not k.endswith(".lengths"))
    x = torch.from_numpy(batch[key]).to(device).requires_grad_(True)
    out = net.apply(tp, {**batch, key: x}, train=True)[case].value
    ct = torch.from_numpy(_ct(out.shape)).to(device)
    grads = torch.autograd.grad((out * ct).sum(), list(tp.values()) + [x])
    names = list(tp) + ["input"]
    return out.detach().cpu().numpy(), {k: g.cpu().numpy() for k, g in zip(names, grads)}


def _check(got, want):
    out, grads = got
    wout, wgrads = want
    np.testing.assert_allclose(out, wout, rtol=TOL, atol=TOL)
    assert set(grads) == set(wgrads)
    for k, g in wgrads.items():
        scale = max(1.0, float(np.abs(g).max()))
        np.testing.assert_allclose(grads[k], g, rtol=GRAD_TOL, atol=GRAD_TOL * scale,
                                   err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_jax(jax_runs, case):
    params, out, grads = jax_runs[case]
    _check(_port_run(case, _batch(case), params), (out, grads))


def test_mdlstm_gradients_finite_and_reach_w_h():
    from paddle_tpu_torch.nn import layers as TL
    from paddle_tpu_torch.nn import recurrent as TR

    tgraph.reset_name_scope()
    x = np.random.RandomState(4).randn(2, 3, 4, 15).astype(np.float32) * 0.3
    net = tgraph.Network([TR.MDLstm(TL.Data("x", shape=(3, 4, 15)), size=3, name="md")])
    params = {k: v.requires_grad_(True) for k, v in net.init({"x": x}, device="cpu").items()}
    out = net.apply(params, {"x": x})["md"].value
    grads = dict(zip(params, torch.autograd.grad((out ** 2).sum(), list(params.values()))))
    assert all(torch.isfinite(g).all() for g in grads.values())
    assert float(grads["md.w_h"].abs().sum()) > 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_layer_matches_cpu(cuda, case):
    from paddle_tpu_torch.nn import layers as TL
    from paddle_tpu_torch.nn import recurrent as TR

    batch = _batch(case)
    tgraph.reset_name_scope()
    net = tgraph.Network([CASES[case](TR, TL, _data(TL), case)])
    params = {k: v.numpy() for k, v in net.init(batch, device="cpu").items()}
    _check(_port_run(case, batch, params, "cuda"), _port_run(case, batch, params))
