"""ResNet-50 and LeNet training in the port (`paddle_tpu_torch/models/`,
`trainer/trainer.py`) against the JAX package, on the CPU.

The JAX ResNet-50 is built once for the module (its init takes ~20 s here),
with 10 classes at 64x64, batch 4: at 32x32 the last stage is 1x1 and its
batch norm normalises 2 values. Parameters and states move across by name.

How close two evaluations of this whole ResNet-50 can be: the graph is
ill-conditioned at this size. Inside the JAX package, jit against
op-by-op (`jax.disable_jit`), the f32 gradients differ by 1.2 % (median
over the 161 of |g1 - g2| / |g1|, max 1.7 %) and the bf16 cost by 9 %
(3.1798 against 3.4722; f32 3.1934). Against a float64 evaluation of the
same graph, JAX's f32 gradients are 3 % (median) off, the port's 4 %;
JAX's cost 2.9e-5, the port's 1.1e-5. So the whole graph's f32 gradients
are held as vectors: each within 10 % (relative L2 norm, measured up to
5.6 %) and all 161 together within 5 %, which still fails for any wrong
term, sign or layout; the cost within 5e-5 (measured 1.8e-5); the 106
states after one train-mode forward within 5e-4 of each state's largest
value (measured 1.4e-4; JAX's own distance from float64 1.7e-4). Every
layer is then held tightly on its own, fed the JAX package's input to it
(`test_resnet50_layers_match_jax`). LeNet has no batch norm and is well
conditioned: its cost within 1e-5 and every gradient within rtol 1e-3,
atol 1e-4 x max(1, max|g|).

  * ResNet-50 f32, the whole graph: cost, all 161 gradients, all 106
    states (above).
  * ResNet-50 layer by layer, f32 and bf16: output, input and parameter
    gradients of every layer.
  * Two SGD(0.1, momentum 0.9) steps of the port's trainer against the
    JAX package's SGDTrainer: the first step's cost, move of every
    parameter and states as above; the second step's cost within 2e-3
    (measured 4.4e-4; the first step at lr 0.1 sends the cost from 3.19 to
    17.4, and from there the parameters of any two f32 runs part by 40 %).
  * A bf16 step: finite, f32 masters, slots and states, the cost within
    the bf16 cost's own spread of JAX's; convs, batch norms, relus and
    adds run in bf16 and the logits in f32.
  * LeNet at 28x28, batch 8, f32: cost, all gradients and two SGD steps.
  * `train(steps_per_dispatch=3)` over 7 batches is bit for bit 7 single
    steps: parameters, states, samples and the pass cost; a shape change
    flushes the group; steps_per_dispatch < 1 raises; `multi_step` of K
    stacked batches returns K costs.
  * `test()` uses the moving statistics.
  * On a card (marked `cuda`, skipped here): a ResNet-50 step on the card
    against the CPU in f32 (TF32 off; as the whole-graph checks above) and
    bf16 (layer by layer), and the trainer turning TF32 off under the f32
    policy. jax is imported inside the CPU tests only."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import models as TM
from paddle_tpu_torch.core import dtypes
from paddle_tpu_torch.nn import graph as tgraph
from paddle_tpu_torch.nn.convert import params_from_jax
from paddle_tpu_torch.optim import SGD
from paddle_tpu_torch.trainer import SGDTrainer
from paddle_tpu_torch.trainer.events import BeginIteration, EndIteration, EndPass

SIZE, BATCH, CLASSES = 64, 4, 10
N_PARAMS, N_STATES = 161, 106
COST_RTOL = 5e-5
GRAD_REL_L2 = 0.1
ALL_GRADS_REL_L2 = 0.05
STATE_RTOL = 5e-4
# the bf16 cost's own spread in the JAX package, jit against op-by-op: 9 %
BF16_STEP_COST_SPREAD = 0.25
STEP2_COST_RTOL = 2e-3
BF16_LAYER_REL_L2 = 1e-3
BF16_RELU_FLIPS = 2


def image_batch(seed, b=BATCH, size=SIZE, classes=CLASSES, slot="image"):
    """Images and labels drawn as bench.py's run_bench draws them."""
    rs = np.random.RandomState(seed)
    return {slot: rs.randn(b, size, size, 1 if slot == "pixel" else 3).astype(np.float32),
            "label": rs.randint(0, classes, b)}


def _np(tree):
    return {k: np.asarray(v, np.float32) for k, v in tree.items()}


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def port_trainer(model=TM.resnet50, precision=None, lr=0.1, **kw):
    tgraph.reset_name_scope()
    cost = model(num_classes=CLASSES, **kw)[3]
    return SGDTrainer(cost, SGD(learning_rate=lr, momentum=0.9), seed=0, device="cpu",
                      precision=precision)


@pytest.fixture(scope="module")
def jax_resnet():
    """The JAX package's ResNet-50 trainer at 64x64: its initial parameters
    and states, its f32 cost, gradients and new states, its bf16 cost, and
    its two SGD steps."""
    import jax

    from paddle_tpu import models as JM
    from paddle_tpu.core import dtypes as jdtypes
    from paddle_tpu.nn.graph import reset_name_scope
    from paddle_tpu.optim import SGD as JaxSGD
    from paddle_tpu.trainer import SGDTrainer as JaxTrainer

    batches = [image_batch(s) for s in (0, 1)]
    reset_name_scope()
    cost = JM.resnet50(num_classes=CLASSES, image_size=SIZE)[3]
    jt = JaxTrainer(cost, JaxSGD(learning_rate=0.1, momentum=0.9), seed=0)
    jt.init_state(batches[0])
    params, states = _np(jt.state["params"]), _np(jt.state["states"])
    net = jt.network

    def loss(p, policy):
        outs, ns = net.apply(p, jt.state["states"], batches[0], train=True, policy=policy)
        return outs["cost"].value, ns

    (c, new_states), grads = jax.jit(jax.value_and_grad(
        lambda p: loss(p, jdtypes.f32_policy()), has_aux=True))(jt.state["params"])
    c_bf16, _ = jax.jit(lambda p: loss(p, jdtypes.bf16_policy()))(jt.state["params"])
    out = dict(batches=batches, params=params, states=states, cost=float(c),
               grads=_np(grads), new_states=_np(new_states), cost_bf16=float(c_bf16),
               layers=[l for l in net.layer_order if l.type_name != "data"])
    every = type(net)(out["layers"])
    for name, policy in (("f32", jdtypes.f32_policy()), ("bf16", jdtypes.bf16_policy())):
        values, _ = jax.jit(lambda p: every.apply(p, jt.state["states"], batches[0],
                                                  train=True, policy=policy))(jt.state["params"])
        out[f"values_{name}"] = {k: v.value for k, v in values.items()}
    step = jt._make_step()
    costs, moved = [], []
    for b in batches:
        jt.state, cost_k, _ = step(jt.state, b)
        costs.append(float(cost_k))
        moved.append((_np(jt.state["params"]), _np(jt.state["states"])))
    out.update(step_costs=costs, step1_params=moved[0][0], step1_states=moved[0][1],
               samples=int(jt.state["samples"]))
    return out


def loaded_resnet(ref, precision=None):
    tr = port_trainer(precision=precision, image_size=SIZE)
    tr.init_state(ref["batches"][0])
    tr.load_params(params_from_jax(ref["params"], device="cpu"))
    tr.load_states(params_from_jax(ref["states"], device="cpu"))
    return tr


def test_resnet50_names_match_jax(jax_resnet):
    tr = port_trainer(image_size=SIZE)
    tr.init_state(jax_resnet["batches"][0])
    params, states = tr.state["params"], tr.state["states"]
    assert len(params) == N_PARAMS and len(states) == N_STATES
    assert set(params) == set(jax_resnet["params"])
    assert set(states) == set(jax_resnet["states"])
    for k, v in params.items():
        assert tuple(v.shape) == jax_resnet["params"][k].shape, k
    assert {"stem.conv.w", "s0b0.a.bn.scale", "s0b0.proj.conv.w", "logits.w",
            "s3b2.c.bn.moving_var"} <= set(params) | set(states)
    # he_normal conv weights: std sqrt(2 / (7 * 7 * 3)) at the stem
    assert abs(float(params["stem.conv.w"].std()) - (2 / 147) ** 0.5) < 0.01
    assert torch.equal(states["stem.bn.moving_var"], torch.ones(64))


def test_resnet50_f32_cost_grads_states_match_jax(jax_resnet):
    tr = loaded_resnet(jax_resnet)
    batch = jax_resnet["batches"][0]
    cost, grads, new_states = tr.cost_grads_and_states(batch)
    assert len(grads) == N_PARAMS and len(new_states) == N_STATES
    assert abs(float(cost) - jax_resnet["cost"]) <= COST_RTOL * abs(jax_resnet["cost"])
    worst = max((rel_l2(grads[k], g), k) for k, g in jax_resnet["grads"].items())
    assert worst[0] <= GRAD_REL_L2, worst
    names = sorted(grads)
    assert rel_l2(np.concatenate([grads[k].numpy().ravel() for k in names]),
                  np.concatenate([jax_resnet["grads"][k].ravel() for k in names])
                  ) <= ALL_GRADS_REL_L2
    for k, want in jax_resnet["new_states"].items():
        err = float(np.abs(new_states[k].numpy() - want).max())
        assert err <= STATE_RTOL * float(np.abs(want).max()), (k, err)
    # the states moved from their 0 / 1 start by a tenth of the batch's
    assert float(new_states["stem.bn.moving_mean"].abs().max()) > 0


def test_resnet50_two_sgd_steps_match_jax(jax_resnet):
    tr = loaded_resnet(jax_resnet)
    p0 = jax_resnet["params"]
    b0, b1 = jax_resnet["batches"]
    c0 = float(tr.step(b0))
    moved = {k: tr.state["params"][k].numpy() - p0[k] for k in p0}
    # the step writes the states in their own storage: keep step 1's values
    states1 = {k: v.clone() for k, v in tr.state["states"].items()}
    c1 = float(tr.step(b1))
    assert tr.state["samples"] == jax_resnet["samples"] == 2 * BATCH
    j0, j1 = jax_resnet["step_costs"]
    assert abs(c0 - j0) <= COST_RTOL * abs(j0)
    assert abs(c1 - j1) <= STEP2_COST_RTOL * abs(j1), (c1, j1)
    # the first step moves each parameter by -lr * g (the first momentum
    # step), so it is held as the gradients are
    worst = max((rel_l2(moved[k], jax_resnet["step1_params"][k] - p0[k]), k) for k in p0)
    assert worst[0] <= GRAD_REL_L2, worst
    for k, want in jax_resnet["step1_states"].items():
        err = float(np.abs(states1[k].numpy() - want).max())
        assert err <= STATE_RTOL * float(np.abs(want).max()), (k, err)
    assert all(bool(torch.isfinite(v).all()) for v in tr.state["states"].values())


def test_resnet50_bf16_step_runs_with_f32_masters(jax_resnet):
    """A bf16 step's cost is finite and near the JAX package's bf16 cost.
    Not within 2e-2: at this size the bf16 cost is not reproducible even
    inside the JAX package (3.1798 jit against 3.4722 op-by-op, f32
    3.1934), since ulp differences in 1 of 10 000 activations grow through
    the last stages; `test_resnet50_layers_match_jax` holds every layer in
    bf16 instead."""
    tr = loaded_resnet(jax_resnet, precision="bf16")
    assert tr.precision == "bf16"
    cost = float(tr.step(jax_resnet["batches"][0]))
    assert abs(cost - jax_resnet["cost_bf16"]) <= BF16_STEP_COST_SPREAD * jax_resnet["cost_bf16"]
    # master parameters, optimizer slots and states stay f32
    assert all(v.dtype == torch.float32 for v in tr.state["params"].values())
    assert all(s.dtype == torch.float32 for slots in tr.state["opt"]["slots"].values()
               for s in slots)
    assert all(v.dtype == torch.float32 for v in tr.state["states"].values())
    assert all(bool(torch.isfinite(v).all()) for v in tr.state["params"].values())


def _jax_layer_vjp(layer, ins, params, states, policy, ct):
    import jax

    from paddle_tpu.nn.graph import Argument, Context

    own = {k: params[k] for k in params if k.startswith(layer.name + ".")}

    def f(xs, ps):
        ctx = Context("apply", {**params, **ps}, states, None, True, policy=policy)
        return layer.forward(ctx, [Argument(x) for x in xs]).value

    out, vjp = jax.vjp(f, ins, own)
    dxs, dps = vjp(ct.astype(out.dtype))
    return out, list(dxs), dps


def _port_layer_vjp(layer, ins, params, states, policy, ct):
    xs = [torch.tensor(np.asarray(x, np.float32)).to(policy.compute_dtype
                                                     if str(x.dtype) == "bfloat16"
                                                     else torch.float32).requires_grad_(True)
          for x in ins]
    own = {k: params[k].clone().requires_grad_(True) for k in params
           if k.startswith(layer.name + ".")}
    ctx = tgraph.Context("apply", {**params, **own}, device=torch.device("cpu"),
                         states=states, train=True, policy=policy)
    out = layer.forward(ctx, [tgraph.Argument(x) for x in xs]).value
    grads = torch.autograd.grad(out, xs + list(own.values()),
                                torch.tensor(ct).to(out.dtype))
    return out, list(grads[:len(xs)]), dict(zip(own, grads[len(xs):]))


@pytest.mark.parametrize("precision,tol", [("f32", 1e-5), ("bf16", 5e-2)])
def test_resnet50_layers_match_jax(jax_resnet, precision, tol):
    """Every layer of ResNet-50 but the cost, fed the JAX package's own
    input to it (train mode, 64x64, batch 4): output, input gradients and
    parameter gradients for one random cotangent, in f32 and under the
    bf16 policy, each within `tol` (relative L2 norm). Well posed where the
    whole graph is not: no rounding difference is carried from one layer
    into the next. f32: all within 1e-5 (measured at most 4.7e-6, at the
    first stage's batch norms, whose channel means reach 5.3 standard
    deviations over 1 024 values: the sums' order shows). bf16: all but
    `BF16_RELU_FLIPS` within 1e-3 (measured 1.3e-4); at a relu on a batch
    norm over 16 values, an output within an ulp of 0 may land on either
    side, which moves that channel's batch-norm gradients (measured 2.6e-2
    at s3b1.a.bn)."""
    from paddle_tpu.core import dtypes as jdtypes

    jpolicy = jdtypes.get(precision)
    policy = dtypes.get(precision)
    values = jax_resnet[f"values_{precision}"]
    batch = jax_resnet["batches"][0]
    tr = loaded_resnet(jax_resnet)
    tlayers = {l.name: l for l in tr.network.layer_order}
    rs = np.random.RandomState(7)
    checked, errs = 0, []
    for layer in jax_resnet["layers"]:
        if layer.is_cost:
            continue
        ins = [batch[i.name] if i.type_name == "data" else values[i.name]
               for i in layer.inputs]
        ct = rs.randn(*values[layer.name].shape).astype(np.float32)
        want, want_dx, want_dp = _jax_layer_vjp(layer, ins, jax_resnet["params"],
                                                jax_resnet["states"], jpolicy, ct)
        got, got_dx, got_dp = _port_layer_vjp(tlayers[layer.name], ins, tr.state["params"],
                                              tr.state["states"], policy, ct)
        assert str(got.dtype).endswith(str(want.dtype)), (layer.name, got.dtype, want.dtype)
        pairs = [("out", got, want)] + list(zip(["dx"] * len(ins), got_dx, want_dx))
        pairs += [(k, got_dp[k], want_dp[k]) for k in want_dp]
        for what, g, w in pairs:
            errs.append((rel_l2(g.detach().float().numpy(), np.asarray(w, np.float32)),
                         layer.name, what))
        checked += 1
    errs.sort()
    assert errs[-1][0] <= tol, errs[-3:]
    if precision == "bf16":
        assert sum(e > BF16_LAYER_REL_L2 for e, *_ in errs) <= BF16_RELU_FLIPS, errs[-5:]
    assert checked == len(jax_resnet["layers"]) - 1


def test_bf16_policy_runs_convs_and_activations_in_bf16():
    tr = port_trainer(precision="bf16", image_size=32)
    batch = image_batch(3, b=2, size=32)
    tr.init_state(batch)
    seen = {}
    layers = {l.name: l for l in tr.network.layer_order}
    fwd = {}
    for name in ("stem.conv", "stem.bn", "s0b0.add", "gap", "logits"):
        layer = layers[name]
        fwd[name] = layer.forward

        def spy(ctx, ins, _name=name):
            out = fwd[_name](ctx, ins)
            seen[_name] = out.value.dtype
            return out

        layer.forward = spy
    tr.step(batch)
    assert seen == {"stem.conv": torch.bfloat16, "stem.bn": torch.bfloat16,
                    "s0b0.add": torch.bfloat16, "gap": torch.bfloat16,
                    "logits": torch.float32}


# -- LeNet ----------------------------------------------------------------------


def test_lenet_cost_grads_and_two_steps_match_jax():
    import jax

    from paddle_tpu import models as JM
    from paddle_tpu.nn.graph import reset_name_scope
    from paddle_tpu.optim import SGD as JaxSGD
    from paddle_tpu.trainer import SGDTrainer as JaxTrainer

    batches = [image_batch(s, b=8, size=28, slot="pixel") for s in (5, 6)]
    reset_name_scope()
    jt = JaxTrainer(JM.lenet()[3], JaxSGD(learning_rate=0.05, momentum=0.9), seed=0)
    jt.init_state(batches[0])
    p0 = _np(jt.state["params"])
    (c, _), g = jax.value_and_grad(
        lambda p: (lambda o: (o[0]["cost"].value, o[1]))(
            jt.network.apply(p, jt.state["states"], batches[0], train=True)),
        has_aux=True)(jt.state["params"])
    step = jt._make_step()
    jcosts = []
    for b in batches:
        jt.state, ck, _ = step(jt.state, b)
        jcosts.append(float(ck))
    p2 = _np(jt.state["params"])

    tr = port_trainer(TM.lenet, lr=0.05)
    tr.init_state(batches[0])
    assert set(tr.state["params"]) == set(p0) and tr.state["states"] == {}
    assert tuple(tr.state["params"]["fc1.w"].shape) == (7 * 7 * 64, 128)
    tr.load_params(params_from_jax(p0, device="cpu"))
    cost, grads = tr.cost_and_grads(batches[0])
    assert abs(float(cost) - float(c)) <= 1e-5 * abs(float(c))
    for k, want in _np(g).items():
        np.testing.assert_allclose(grads[k].numpy(), want, rtol=1e-3,
                                   atol=1e-4 * max(1.0, float(np.abs(want).max())),
                                   err_msg=k)
    costs = [float(tr.step(b)) for b in batches]
    np.testing.assert_allclose(costs, jcosts, rtol=1e-5)
    for k, want in p2.items():
        np.testing.assert_allclose(tr.state["params"][k].numpy(), want, rtol=0, atol=1e-5,
                                   err_msg=k)


# -- K steps a dispatch -----------------------------------------------------------


def _small_trainer():
    # a small learning rate: at batch 2, SGD(0.1) sends this ResNet's cost to
    # inf within a few steps, and the bit-for-bit checks want finite values
    tr = port_trainer(image_size=32, lr=1e-3)
    tr.init_state(image_batch(0, b=2, size=32))
    return tr


def _run(tr, batches, k, events=None):
    passes = []

    def handler(e):
        if events is not None:
            events.append(e)
        if isinstance(e, EndPass):
            passes.append(e.metrics)

    tr.train(lambda: iter(batches), num_passes=1, event_handler=handler,
             steps_per_dispatch=k)
    return passes


def test_steps_per_dispatch_is_bitwise_single_steps():
    """7 batches at K=3: two 3-step calls and one single-step remainder land
    bit for bit on 7 single steps."""
    batches = [image_batch(10 + i, b=2, size=32) for i in range(7)]
    one, three = _small_trainer(), _small_trainer()
    p1 = _run(one, batches, 1)
    events = []
    p3 = _run(three, batches, 3, events)
    for kind in ("params", "states"):
        a, b = one.state[kind], three.state[kind]
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), (kind, k)
    assert one.state["samples"] == three.state["samples"] == 14
    assert p1[0]["avg_cost"] == p3[0]["avg_cost"]
    assert p1[0]["batches"] == p3[0]["batches"] == 7
    begins = [e.batch_id for e in events if isinstance(e, BeginIteration)]
    ends = [e.batch_id for e in events if isinstance(e, EndIteration)]
    assert begins == [0, 3, 6] and ends == [2, 5, 6]


def test_a_shape_change_flushes_the_group():
    small = [image_batch(20 + i, b=2, size=32) for i in range(2)]
    large = [image_batch(30 + i, b=3, size=32) for i in range(4)]
    batches = small + large
    one, three = _small_trainer(), _small_trainer()
    _run(one, batches, 1)
    events = []
    p3 = _run(three, batches, 3, events)
    spans = [(b.batch_id, e.batch_id) for b, e in zip(
        [e for e in events if isinstance(e, BeginIteration)],
        [e for e in events if isinstance(e, EndIteration)])]
    # the two small batches go singly when the third has another shape; then
    # one group of three large ones, and the last large one alone
    assert spans == [(0, 0), (1, 1), (2, 4), (5, 5)]
    assert p3[0]["batches"] == 6
    for k, v in one.state["params"].items():
        assert torch.equal(v, three.state["params"][k]), k


def test_steps_per_dispatch_below_one_raises():
    tr = _small_trainer()
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        tr.train(lambda: iter([]), steps_per_dispatch=0)


def test_multi_step_returns_k_costs_as_one_tensor():
    batches = [image_batch(40 + i, b=2, size=32) for i in range(3)]
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    one, multi = _small_trainer(), _small_trainer()
    singles = [one.step(b) for b in batches]
    costs = multi.multi_step(stacked)
    assert isinstance(costs, torch.Tensor) and tuple(costs.shape) == (3,)
    assert torch.equal(costs, torch.stack(singles))
    assert multi.state["samples"] == 6


def test_test_uses_moving_statistics():
    from paddle_tpu_torch.nn import costs as C
    from paddle_tpu_torch.nn import layers as L

    tgraph.reset_name_scope()
    x = L.Conv2D(L.Data("image", shape=(8, 8, 3)), 6, 3, padding=1, bias=False, name="c")
    x = L.GlobalPool(L.BatchNorm(x, act="relu", name="bn"), "avg", name="gap")
    cost = C.ClassificationCost(L.Fc(x, CLASSES, act=None, name="fc"),
                                L.Data("label", shape=()), name="cost")
    tr = SGDTrainer(cost, SGD(learning_rate=0.1, momentum=0.9), device="cpu")
    batch = image_batch(50, b=4, size=8)
    tr.step(batch)
    res = tr.test(lambda: iter([batch]))
    outs, same = tr.network.apply(tr.state["params"], batch, tr.state["states"], train=False)
    assert same == tr.state["states"]
    assert res == {"cost": float(outs["cost"].value), "samples": 4}
    train_outs, _ = tr.network.apply(tr.state["params"], batch, tr.state["states"],
                                     train=True)
    assert res["cost"] != float(train_outs["cost"].value)


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the port's ResNet-50 step on the card")
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


@pytest.mark.cuda
def test_cuda_f32_trainer_turns_tf32_off(cuda):
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    tgraph.reset_name_scope()
    SGDTrainer(TM.lenet()[3], SGD(learning_rate=0.1), device="cuda")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cuda_resnet50_step_matches_cpu(cuda, precision):
    batch = image_batch(0)
    cpu = port_trainer(precision=precision, image_size=SIZE)
    cpu.init_state(batch)
    tgraph.reset_name_scope()
    card = SGDTrainer(TM.resnet50(num_classes=CLASSES, image_size=SIZE)[3],
                      SGD(learning_rate=0.1, momentum=0.9), seed=0, device="cuda",
                      precision=precision)
    card.init_state(batch)
    card.load_params(cpu.state["params"])
    c_card, g_card, s_card = card.cost_grads_and_states(batch)
    c_cpu, g_cpu, s_cpu = cpu.cost_grads_and_states(batch)
    if precision == "bf16":
        # the whole graph's bf16 cost is not reproducible across rounding
        # orders at this size (see the module docstring): hold each layer,
        # fed the CPU's input to it, and the cost's finiteness
        assert bool(torch.isfinite(c_card))
        every = tgraph.Network([l for l in cpu.network.layer_order if l.type_name != "data"])
        values, _ = every.apply(cpu.state["params"], batch, cpu.state["states"], train=True,
                                policy=dtypes.bf16_policy())
        ctx = tgraph.Context("apply", card.state["params"], device=cuda,
                             states=card.state["states"], train=True,
                             policy=dtypes.bf16_policy())
        for layer in every.outputs:
            ins = [tgraph.Argument(torch.as_tensor(batch[i.name]).to(cuda))
                   if i.type_name == "data" else
                   tgraph.Argument(values[i.name].value.detach().to(cuda))
                   for i in layer.inputs]
            got = layer.forward(ctx, ins).value.detach().float().cpu()
            want = values[layer.name].value.detach().float()
            err = float((got - want).abs().max())
            assert err <= 2e-2 * max(1.0, float(want.abs().max())), (layer.name, err)
        return
    assert abs(float(c_card) - float(c_cpu)) <= COST_RTOL * abs(float(c_cpu))
    worst = max((rel_l2(g_card[k].cpu(), g), k) for k, g in g_cpu.items())
    assert worst[0] <= GRAD_REL_L2, worst
    for k, want in s_cpu.items():
        err = float((s_card[k].cpu() - want).abs().max())
        assert err <= STATE_RTOL * float(want.abs().max()), (k, err)
