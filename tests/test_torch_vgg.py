"""VGG-19 with Dropout, held against the JAX package (`paddle_tpu/models/vgg.py`).

On the CPU, with the same numpy-seeded batches and the JAX parameters moved
across by name:
  * Dropout's train-mode output is bitwise the JAX layer's for the same key,
    the identity at inference and for rate 0, and in the input's dtype;
  * a tiny VGG-19 (image 32, fc_dim 64, 10 classes) in train mode: the
    cost within 1e-6 relative and every gradient within 1e-5 relative L2
    of the JAX package's at the key of the first step; then 2 steps of
    Momentum(0.9) with the discexp schedule and warmup and a ModelAverage
    inside the step: costs within 1e-6 relative, parameters and averages
    within 1e-5 relative L2; `test()` evaluates on the averages.

On the card (`cuda`, skipped elsewhere): the tiny VGG-19's captured steps
match the CPU's, and two replays draw different Dropout masks."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import prng
from paddle_tpu_torch.core.stack_trace import LayerError
from paddle_tpu_torch.nn import graph as tgraph
from paddle_tpu_torch.nn import layers as TL
from paddle_tpu_torch.nn.convert import params_from_jax
from paddle_tpu_torch.optim import Momentum, ModelAverage, schedules
from paddle_tpu_torch.trainer import SGDTrainer

SIZE, FC, CLASSES, BATCH = 32, 64, 10, 4
LR, DECAY_A, DECAY_B, WARMUP = 0.01, 0.5, 6.0, 6.0
COST_RTOL, GRAD_RTOL = 1e-6, 1e-5


def batch(seed, b=BATCH):
    rs = np.random.RandomState(seed)
    return {"image": rs.rand(b, SIZE, SIZE, 3).astype(np.float32),
            "label": rs.randint(0, CLASSES, b).astype(np.int32)}


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def port_trainer(device="cpu"):
    from paddle_tpu_torch.models import vgg

    tgraph.reset_name_scope()
    return SGDTrainer(
        vgg(19, num_classes=CLASSES, image_size=SIZE, fc_dim=FC)[3],
        Momentum(learning_rate=LR, momentum=0.9), seed=0, device=device,
        schedule=schedules.build(LR, "discexp", decay_a=DECAY_A, decay_b=DECAY_B,
                                 warmup_samples=WARMUP),
        model_average=ModelAverage(0.5))


@pytest.fixture(scope="module")
def jax_vgg():
    """The JAX trainer's initial parameters, first-step cost and gradients,
    and its two steps' costs, parameters and averages."""
    import jax

    from paddle_tpu.models.vgg import vgg
    from paddle_tpu.nn.graph import reset_name_scope
    from paddle_tpu.optim import ModelAverage as JaxAverage
    from paddle_tpu.optim import Momentum as JaxMomentum
    from paddle_tpu.optim import schedules as jax_schedules
    from paddle_tpu.trainer import SGDTrainer as JaxTrainer

    reset_name_scope()
    cost = vgg(19, num_classes=CLASSES, image_size=SIZE, fc_dim=FC)[3]
    jt = JaxTrainer(cost, JaxMomentum(learning_rate=LR, momentum=0.9), seed=0,
                    schedule=jax_schedules.build(LR, "discexp", decay_a=DECAY_A,
                                                 decay_b=DECAY_B, warmup_samples=WARMUP),
                    model_average=JaxAverage(0.5))
    jt.init_state(batch(0))
    # ModelAverage.init_state's f32 astype aliases the parameters' buffers,
    # which the donating step would donate twice: give the averages their own
    jt.state["avg"]["avg"] = {k: jax.numpy.array(v, copy=True)
                              for k, v in jt.state["avg"]["avg"].items()}
    params0 = {k: np.asarray(v) for k, v in jt.state["params"].items()}
    b0 = batch(1)
    rng0 = jax.random.fold_in(jt.state["rng"], jt.state["samples"])

    def loss(p):
        outs, _ = jt.network.apply(p, jt.state["states"], b0, train=True, rng=rng0,
                                   policy=jt.policy())
        return outs["cost"].value

    c0, g0 = jax.value_and_grad(loss)(jt.state["params"])
    step = jt._make_step()
    costs = []
    for seed in (1, 2):
        jt.state, c, _ = step(jt.state, batch(seed))
        costs.append(float(c))
    st = jax.device_get(jt.state)
    return dict(params0=params0, cost0=float(c0),
                grads0={k: np.asarray(v) for k, v in g0.items()}, costs=costs,
                params={k: np.asarray(v) for k, v in st["params"].items()},
                avg={k: np.asarray(v) for k, v in st["avg"]["avg"].items()},
                n=float(st["avg"]["n"]), samples=int(st["samples"]))


def _loaded(jax_vgg, device="cpu"):
    tr = port_trainer(device)
    tr.init_state(batch(0))
    tr.load_params(params_from_jax(jax_vgg["params0"], device=device))
    # the averages start from the initial parameters, as the JAX state's do
    for k, a in tr.state["avg"]["avg"].items():
        a.copy_(tr.state["params"][k])
    return tr


# -- Dropout ---------------------------------------------------------------------


@pytest.mark.parametrize("rate", [0.5, 0.2, 0.9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_train_output_is_jaxs_bit_for_bit(rate, dtype):
    import jax
    import jax.numpy as jnp

    from paddle_tpu.nn import layers as JL
    from paddle_tpu.nn.graph import Network as JaxNetwork
    from paddle_tpu.nn.graph import reset_name_scope

    x = np.random.RandomState(3).randn(6, 37).astype(np.float32)
    reset_name_scope()
    jd = JL.Dropout(JL.Data("x", shape=(37,)), rate, name="drop")
    jnet = JaxNetwork([jd])
    tgraph.reset_name_scope()
    td = TL.Dropout(TL.Data("x", shape=(37,)), rate, name="drop")
    tnet = tgraph.Network([td])
    for seed, samples in ((0, 0), (4, 128)):
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), samples)
        want, _ = jnet.apply({}, {}, {"x": jnp.asarray(x, dtype)}, train=True, rng=jkey)
        tkey = prng.fold_in(prng.PRNGKey(seed), samples)
        tx = torch.from_numpy(x).to(getattr(torch, dtype))
        # no parameters: apply takes its device from this entry
        got = tnet.apply({"device": tx}, {"x": tx}, train=True, rng=tkey)
        w = np.asarray(want["drop"].value.astype(jnp.float32))
        g = got["drop"].value
        assert g.dtype == getattr(torch, dtype)
        assert np.array_equal(g.float().numpy(), w)
    tx = torch.from_numpy(x)
    out = tnet.apply({"device": tx}, {"x": tx}, train=False)
    assert torch.equal(out["drop"].value, tx)


def test_dropout_rate_zero_is_identity_and_needs_no_key():
    tgraph.reset_name_scope()
    net = tgraph.Network([TL.Dropout(TL.Data("x", shape=(3,)), 0.0, name="d")])
    x = torch.randn(2, 3)
    assert torch.equal(net.apply({"device": x}, {"x": x}, train=True)["d"].value, x)
    net2 = tgraph.Network([TL.Dropout(TL.Data("y", shape=(3,)), 0.5, name="d2")])
    with pytest.raises(LayerError, match=r"error in layer 'd2' .*rng"):
        net2.apply({"device": x}, {"y": x}, train=True)


def test_two_dropouts_in_one_apply_draw_distinct_counts():
    """Two layers of one name-hash draw with counts 1 and 2, as the JAX
    Context counts them, and differ."""
    tgraph.reset_name_scope()
    x = TL.Data("x", shape=(64,))
    a = TL.Dropout(x, 0.5, name="a")
    b = TL.Dropout(a, 0.5, name="b")
    key = prng.PRNGKey(1)
    x1 = torch.ones(2, 64)
    out = tgraph.Network([a, b]).apply({"device": x1}, {"x": x1}, train=True, rng=key)
    mask_a = out["a"].value != 0
    want_a = prng.bernoulli(prng.fold_in(prng.fold_in(key, tgraph._stable_hash("a")), 1),
                            0.5, (2, 64))
    assert torch.equal(mask_a, want_a)
    want_b = prng.bernoulli(prng.fold_in(prng.fold_in(key, tgraph._stable_hash("b")), 2),
                            0.5, (2, 64))
    assert torch.equal(out["b"].value != 0, want_a & want_b)


# -- the tiny VGG-19 ---------------------------------------------------------------


def test_vgg19_parameter_names_match_jax(jax_vgg):
    tr = port_trainer()
    tr.init_state(batch(0))
    assert sorted(tr.state["params"]) == sorted(jax_vgg["params0"])
    for k, v in tr.state["params"].items():
        assert tuple(v.shape) == jax_vgg["params0"][k].shape, k
    assert len(tr.state["params"]) == 2 * 19


def test_vgg19_cost_and_gradients_match_jax(jax_vgg):
    tr = _loaded(jax_vgg)
    cost, grads = tr.cost_and_grads(batch(1))
    np.testing.assert_allclose(float(cost), jax_vgg["cost0"], rtol=COST_RTOL)
    for k, g in jax_vgg["grads0"].items():
        assert rel_l2(grads[k].numpy(), g) < GRAD_RTOL, k


def test_vgg19_two_steps_with_schedule_and_average_match_jax(jax_vgg):
    tr = _loaded(jax_vgg)
    costs = [float(tr.step(batch(s))) for s in (1, 2)]
    np.testing.assert_allclose(costs, jax_vgg["costs"], rtol=COST_RTOL)
    for k, want in jax_vgg["params"].items():
        assert rel_l2(tr.state["params"][k].numpy(), want) < GRAD_RTOL, k
        assert rel_l2(tr.state["avg"]["avg"][k].numpy(), jax_vgg["avg"][k]) < GRAD_RTOL, k
    assert float(tr.state["avg"]["n"]) == jax_vgg["n"] == 2.0
    assert int(tr.state["samples"]) == jax_vgg["samples"] == 2 * BATCH
    # test() runs at the averages, not at the raw parameters
    res = tr.test(lambda: iter([batch(5)]))
    with torch.no_grad():
        raw = float(tr._cost(tr.state["params"], batch(5), train=False)[0])
        avg = float(tr._cost(tr.model_average.averaged_params(
            tr.state["avg"], tr.state["params"]), batch(5), train=False)[0])
    assert res["cost"] == pytest.approx(avg, rel=1e-6) and avg != raw


def test_vgg19_steps_draw_fresh_masks():
    """The step key folds in the samples counter: two steps on the same
    batch from the same parameters draw different Dropout masks."""
    tr = port_trainer()
    tr.init_state(batch(0))
    k0 = tr.step_rng().clone()
    tr.step(batch(1))
    assert not torch.equal(k0, tr.step_rng())
    assert torch.equal(tr.step_rng(), prng.fold_in(prng.PRNGKey(0), BATCH))


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_vgg19_replays_match_cpu_and_draw_fresh_masks(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu, card = port_trainer("cpu"), port_trainer(cuda)
    cpu.init_state(batch(0))
    card.init_state(batch(0))
    card.load_params({k: v.to(cuda) for k, v in cpu.state["params"].items()})
    for k, a in card.state["avg"]["avg"].items():
        a.copy_(card.state["params"][k])
    for k, a in cpu.state["avg"]["avg"].items():
        a.copy_(cpu.state["params"][k])
    keys = []
    for s in (1, 2, 3, 4):
        keys.append(card.step_rng().cpu())
        c_card, c_cpu = float(card.step(batch(s))), float(cpu.step(batch(s)))
        assert c_card == pytest.approx(c_cpu, rel=1e-4)
    assert next(iter(card.graphs.values())).replays == 3
    assert not torch.equal(keys[2], keys[3])
    # the conv biases start at 0 and stay near 1e-4, where a relative
    # measure reads the reduction order of their gradients' sums; after 4
    # steps at full lr a relu or max-pool near a tie moves single weights
    # by ~1e-5 (OCR's card-vs-CPU parameters are held at 1e-4 too)
    for k, v in cpu.state["params"].items():
        np.testing.assert_allclose(card.state["params"][k].cpu().numpy(), v.numpy(), rtol=0,
                                   atol=1e-4 * max(1.0, float(v.abs().max())), err_msg=k)
