"""Optimizers, lr schedules and model averaging against the JAX package
(`paddle_tpu/optim/`), mirroring tests/test_optim.py.

On the CPU, with the same numpy-seeded parameters and gradients:
  * each of the seven optimizers (SGD plain / momentum / nesterov with the
    `Momentum` alias, AdaGrad, DecayedAdaGrad, AdaDelta, RMSProp, Adam,
    AdaMax) over 3 steps, with global L1 and L2 decay, clipping, a static
    parameter and a per-parameter lr scale: parameters and every slot
    within 1e-6 relative of the JAX optimizer's; each descends a quadratic;
  * Adam's and AdaMax's bias correction bitwise the JAX step's f32 value
    (a repair: the port computed it in f64);
  * the in-place update under the divergence guard's `ok`: a False leaves
    parameters, slots and `t` bitwise as they were;
  * every schedule (constant, poly, caffe_poly, exp, discexp, linear,
    linear_decay, manual, warmup) on a grid of sample counts within 1e-6
    relative, and the reference's pinned values;
  * ModelAverage over 3 updates, its window cap and averaged_params.

On the card (`cuda`, skipped elsewhere): each optimizer's update and a
schedule inside a captured CUDA graph match the CPU over 3 replays."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.nn.graph import ParamAttr
from paddle_tpu_torch.optim import (
    SGD, AdaDelta, AdaGrad, Adam, AdaMax, DecayedAdaGrad, ModelAverage, Momentum, RMSProp,
    schedules,
)

RTOL = 1e-6

OPTS = {
    "sgd": (SGD, dict(learning_rate=0.1)),
    "momentum": (Momentum, dict(learning_rate=0.1, momentum=0.9)),
    "nesterov": (SGD, dict(learning_rate=0.1, momentum=0.9, nesterov=True)),
    "adagrad": (AdaGrad, dict(learning_rate=0.5)),
    "decayed_adagrad": (DecayedAdaGrad, dict(learning_rate=0.05)),
    "adadelta": (AdaDelta, dict(learning_rate=1.0, rho=0.9, epsilon=1e-2)),
    "rmsprop": (RMSProp, dict(learning_rate=0.05, momentum=0.5)),
    "adam": (Adam, dict(learning_rate=0.2)),
    "adamax": (AdaMax, dict(learning_rate=0.2)),
}


def _jax_cls(name):
    from paddle_tpu import optim as jo

    return {"sgd": jo.SGD, "momentum": jo.Momentum, "nesterov": jo.SGD, "adagrad": jo.AdaGrad,
            "decayed_adagrad": jo.DecayedAdaGrad, "adadelta": jo.AdaDelta,
            "rmsprop": jo.RMSProp, "adam": jo.Adam, "adamax": jo.AdaMax}[name]


def _attrs(attr_cls):
    return {"w": attr_cls(), "frozen": attr_cls(is_static=True),
            "scaled": attr_cls(learning_rate=0.5, l2_decay=0.01, l1_decay=0.001,
                               gradient_clipping_threshold=0.3)}


def _data(seed=0, steps=3):
    rs = np.random.RandomState(seed)
    params = {k: rs.randn(*shape).astype(np.float32)
              for k, shape in (("w", (4, 5)), ("frozen", (3,)), ("scaled", (6,)))}
    grads = [{k: rs.randn(*v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(steps)]
    return params, grads


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * max(1.0, np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizer_matches_jax_with_decay_clip_static_and_scale(name):
    import jax.numpy as jnp

    from paddle_tpu.nn.graph import ParamAttr as JaxAttr

    cls, kw = OPTS[name]
    kw = dict(kw, l1_rate=1e-3, l2_rate=1e-2, gradient_clipping_threshold=1.5)
    params, grads = _data()
    jopt = _jax_cls(name)(**kw)
    jopt.param_attrs = _attrs(JaxAttr)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jst = jopt.init_state(jp)
    opt = cls(**kw)
    opt.param_attrs = _attrs(ParamAttr)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tst = opt.init_state(tp)
    for i, g in enumerate(grads):
        lr = 0.1 * (i + 1)
        jp, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jst, jp,
                              jnp.asarray(lr, jnp.float32))
        opt.update({k: torch.from_numpy(v) for k, v in g.items()}, tst, tp,
                   torch.tensor(lr, dtype=torch.float32))
        for k in params:
            _close(tp[k].numpy(), jp[k], f"{name} step {i} {k}")
            for j, (a, b) in enumerate(zip(tst["slots"][k], jst["slots"][k])):
                _close(a.numpy(), b, f"{name} step {i} {k} slot {j}")
    assert int(tst["t"]) == int(jst["t"]) == 3
    assert np.array_equal(tp["frozen"].numpy(), params["frozen"])


@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizer_descends_quadratic(name):
    cls, kw = OPTS[name]
    opt = cls(**kw)
    params = {"w": torch.tensor([3.0, -2.0, 1.5])}
    state = opt.init_state(params)
    lr = torch.tensor(opt.learning_rate)
    for _ in range(150):
        opt.update({"w": 2.0 * params["w"]}, state, params, lr)
    assert float((params["w"] ** 2).sum()) < 1e-2


@pytest.mark.parametrize("name", sorted(OPTS))
def test_guarded_update_keeps_state_when_not_ok(name):
    cls, kw = OPTS[name]
    params, grads = _data(1)
    opt = cls(**kw)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    st = opt.init_state(tp)
    opt.update({k: torch.from_numpy(v) for k, v in grads[0].items()}, st, tp,
               torch.tensor(0.1))
    before = ({k: v.clone() for k, v in tp.items()},
              {k: [s.clone() for s in v] for k, v in st["slots"].items()}, st["t"].clone())
    poisoned = {k: torch.full_like(torch.from_numpy(v), float("nan"))
                for k, v in grads[1].items()}
    opt.update(poisoned, st, tp, torch.tensor(0.1), ok=torch.tensor(False))
    for k in tp:
        assert torch.equal(tp[k], before[0][k]), k
        for a, b in zip(st["slots"][k], before[1][k]):
            assert torch.equal(a, b), k
    assert torch.equal(st["t"], before[2])
    opt.update({k: torch.from_numpy(v) for k, v in grads[1].items()}, st, tp,
               torch.tensor(0.1), ok=torch.tensor(True))
    assert int(st["t"]) == 2 and not torch.equal(tp["w"], before[0]["w"])


def test_adam_bias_correction_is_the_jax_steps_f32():
    """Repair: the port computed 1 - beta^t in f64 and rounded once, 1.3e-5
    relative off the JAX step's f32 value at t = 1, beta = 0.999; Adam's
    first updates drifted by as much. Now bitwise equal for t = 1..64."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu_torch.optim.optimizers import _bias_correction

    for beta in (0.9, 0.999):
        bc = jax.jit(lambda t: 1 - jnp.power(beta, t.astype(jnp.float32)))
        for t in range(1, 65):
            got = _bias_correction(beta, torch.tensor(t, dtype=torch.int32), torch.zeros(()))
            assert got.dtype == torch.float32
            assert float(got) == float(bc(jnp.int32(t))), (beta, t)


def test_momentum_is_sgd():
    assert Momentum is SGD


SCHEDULES = [
    ("constant", 0.0, 0.0), ("poly", 0.01, 0.5), ("caffe_poly", 500.0, 2.0),
    ("exp", 0.5, 100.0), ("discexp", 0.5, 30.0), ("linear", 0.0005, 0.02),
    ("linear_decay", 0.0001, 0.01),
]
GRID = [0.0, 1.0, 29.0, 30.0, 100.0, 250.0, 499.0, 500.0, 640.0, 1e4, 3.2e6]


@pytest.mark.parametrize("name,a,b", SCHEDULES)
@pytest.mark.parametrize("warmup", [0.0, 64.0])
def test_schedule_matches_jax_on_a_grid(name, a, b, warmup):
    import jax.numpy as jnp

    from paddle_tpu.optim import schedules as js

    want = js.build(0.1, name, decay_a=a, decay_b=b, warmup_samples=warmup)
    got = schedules.build(0.1, name, decay_a=a, decay_b=b, warmup_samples=warmup)
    t = torch.tensor(GRID, dtype=torch.float32)
    out = got(t)
    assert out.dtype == torch.float32 and out.shape == t.shape
    for i, v in enumerate(GRID):
        _close(float(out[i]), float(want(jnp.asarray(v, jnp.float32))), f"{name} t={v}")
        assert float(got(torch.tensor(v))) == float(out[i])


def test_manual_schedule_matches_jax():
    import jax.numpy as jnp

    from paddle_tpu.optim import schedules as js

    segs = [(50, 1.0), (100, 0.1), (200, 0.01)]
    want, got = js.manual(1.0, segs), schedules.manual(1.0, segs)
    for v in GRID:
        _close(float(got(torch.tensor(v))), float(want(jnp.asarray(v, jnp.float32))), f"t={v}")


def test_schedules_reference_values():
    t = torch.tensor(100.0)
    assert float(schedules.build(0.1)(t)) == pytest.approx(0.1)
    assert float(schedules.build(0.1, "poly", decay_a=0.01, decay_b=0.5)(t)) == \
        pytest.approx(0.1 * 2.0 ** -0.5)
    assert float(schedules.build(0.1, "exp", decay_a=0.5, decay_b=100.0)(t)) == \
        pytest.approx(0.05)
    assert float(schedules.build(0.1, "discexp", decay_a=0.5, decay_b=30.0)(t)) == \
        pytest.approx(0.1 * 0.5 ** 3)
    assert float(schedules.build(0.1, "linear", decay_a=0.0005, decay_b=0.02)(t)) == \
        pytest.approx(0.05)
    man = schedules.manual(1.0, [(50, 1.0), (100, 0.1), (200, 0.01)])
    assert float(man(torch.tensor(120.0))) == pytest.approx(0.01)
    assert float(schedules.build(0.1, warmup_samples=200.0)(t)) == pytest.approx(0.05)
    with pytest.raises(KeyError, match="pass_manual"):
        schedules.build(0.1, "pass_manual")


@pytest.mark.parametrize("window,cap", [(0.5, 0), (1.0, 2)])
def test_model_average_matches_jax(window, cap):
    import jax.numpy as jnp

    from paddle_tpu.optim import ModelAverage as JaxAverage

    rs = np.random.RandomState(2)
    p0 = {"a": rs.randn(3, 4).astype(np.float32), "b": rs.randn(5).astype(np.float32)}
    javg, tavg = JaxAverage(window, cap), ModelAverage(window, cap)
    jst = javg.init_state({k: jnp.asarray(v) for k, v in p0.items()})
    tst = tavg.init_state({k: torch.from_numpy(v.copy()) for k, v in p0.items()})
    for _ in range(3):
        p = {k: rs.randn(*v.shape).astype(np.float32) for k, v in p0.items()}
        jst = javg.update(jst, {k: jnp.asarray(v) for k, v in p.items()})
        tavg.update(tst, {k: torch.from_numpy(v) for k, v in p.items()})
        assert float(tst["n"]) == float(jst["n"])
        for k in p0:
            _close(tst["avg"][k].numpy(), jst["avg"][k], k)
    out = tavg.averaged_params(tst, {k: torch.from_numpy(v) for k, v in p0.items()})
    for k in p0:
        assert torch.equal(out[k], tst["avg"][k])


def test_model_average_reference_value_and_off():
    avg = ModelAverage(average_window=0.5)
    st = avg.init_state({"w": torch.tensor([0.0])})
    for v in (1.0, 2.0, 3.0):
        avg.update(st, {"w": torch.tensor([v])})
    out = avg.averaged_params(st, {"w": torch.tensor([3.0])})
    assert float(out["w"]) == pytest.approx(2.0)
    off = ModelAverage()
    assert off.init_state({"w": torch.tensor([1.0])}) == {}
    w = {"w": torch.tensor([1.0])}
    assert off.averaged_params({}, w) is w


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(OPTS))
def test_cuda_update_in_a_graph_matches_cpu(cuda, name):
    cls, kw = OPTS[name]
    params, grads = _data(3, steps=4)
    sched = schedules.build(0.1, "discexp", decay_a=0.5, decay_b=2.0, warmup_samples=3.0)
    cpu, card = cls(**kw), cls(**kw)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    gp = {k: v.to(cuda) for k, v in tp.items()}
    cst, gst = cpu.init_state(tp), card.init_state(gp)
    samples = torch.zeros((), dtype=torch.int32, device=cuda)
    g_in = {k: torch.zeros_like(v) for k, v in gp.items()}

    def body():
        card.update(g_in, gst, gp, sched(samples.float()),
                    ok=torch.isfinite(g_in["w"].sum()))
        samples.add_(1)

    for k in g_in:
        g_in[k].copy_(torch.from_numpy(grads[0][k]))
    body()  # eager warm-up = step 0
    cpu.update({k: torch.from_numpy(v) for k, v in grads[0].items()}, cst, tp,
               sched(torch.tensor(0.0)))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    for i in (1, 2, 3):
        for k in g_in:
            g_in[k].copy_(torch.from_numpy(grads[i][k]))
        graph.replay()
        cpu.update({k: torch.from_numpy(v) for k, v in grads[i].items()}, cst, tp,
                   sched(torch.tensor(float(i))))
    assert int(gst["t"]) == int(cst["t"]) == 4
    for k in tp:
        np.testing.assert_allclose(gp[k].cpu().numpy(), tp[k].numpy(), rtol=1e-5, atol=1e-6)
