"""AlexNet and GoogLeNet in the port (`paddle_tpu_torch/models/alexnet.py`,
`googlenet.py`) against the JAX package's, on the CPU.

Each model is built once for the module in the JAX package at 64x64,
batch 4, 10 classes (AlexNet's last pool is then 1x1, GoogLeNet's last
inception block 2x2), its parameters moved to the port by name. Both draw
Dropout's masks from the same key (the first step's: fold_in(rng,
samples)).

  * The parameter names and shapes equal the JAX package's.
  * The f32 cost and gradients in train mode, the whole graph: the cost
    within 1e-5 relative; the gradients as vectors (relative L2), each and
    all together within TOL's bounds. AlexNet's agree to 1.7e-6 (each) and
    1.5e-6 (all). GoogLeNet's relus sit on many exact or near ties: a
    pre-activation within an ulp of 0 takes either side under the two
    summation orders, and one such element moves its layer's gradient by
    ~2e-3 (measured on conv2 alone); over the graph each gradient agrees
    to 8.6e-3 and all together to 1.2e-3, so they are held at 5e-2 and
    1e-2.
  * Every layer on its own, fed the JAX package's input to it: output,
    input and parameter gradients within 1e-5 relative L2. The cotangent
    is zero where the JAX output is within 1e-6 x its largest value of 0,
    where a relu's derivative is the last bit's (above).
  * Two SGD(0.01, momentum 0.9) steps of the port's trainer against the
    JAX package's SGDTrainer: the first cost within 1e-5 relative, the
    second within 1e-3 (GoogLeNet 7.6e-5 after a first step to 17.5,
    AlexNet 1.2e-7); the parameters after them within TOL's bound x
    max(1, max|p|) each (GoogLeNet 8.9e-4, its relu ties again; AlexNet
    rel L2 1.1e-6).
  * GoogLeNet's inception blocks join NHWC branches with no layout copy:
    every Concat gets four contiguous NHWC tensors.

On a card (marked `cuda`, skipped here): each model's f32 cost and
gradients on the card against the CPU from the same parameters, TF32 off.
jax is imported inside the CPU tests only."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import models as TM
from paddle_tpu_torch.nn import graph as tgraph
from paddle_tpu_torch.nn.convert import params_from_jax
from paddle_tpu_torch.optim import SGD
from paddle_tpu_torch.trainer import SGDTrainer

SIZE, BATCH, CLASSES, LR = 64, 4, 10, 0.01
COST_RTOL, STEP2_COST_RTOL = 1e-5, 1e-3
LAYER_REL_L2 = 1e-5
# (each gradient, all gradients) relative L2, parameters after two steps
# (max abs over max(1, max|p|)): the docstring gives the measured values
TOL = {"alexnet": dict(grad=1e-5, all_grads=1e-5, step_params=1e-5),
       "googlenet": dict(grad=5e-2, all_grads=1e-2, step_params=5e-3)}
NEAR_ZERO = 1e-6
N_PARAMS = {"alexnet": 2 * 8, "googlenet": 2 * (3 + 9 * 6 + 1)}


def image_batch(seed, b=BATCH, size=SIZE, classes=CLASSES):
    """Images and labels drawn as benchmarks/image_bench.py draws them."""
    rs = np.random.RandomState(seed)
    return {"image": rs.randn(b, size, size, 3).astype(np.float32),
            "label": rs.randint(0, classes, b).astype(np.int32)}


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _np(tree):
    return {k: np.asarray(v, np.float32) for k, v in tree.items()}


def port_trainer(model, device="cpu"):
    tgraph.reset_name_scope()
    cost = getattr(TM, model)(num_classes=CLASSES, image_size=SIZE)[3]
    return SGDTrainer(cost, SGD(learning_rate=LR, momentum=0.9), seed=0, device=device)


@pytest.fixture(scope="module", params=["alexnet", "googlenet"])
def jax_model(request):
    """The JAX package's trainer for one model: its initial parameters, the
    first step's key, cost and gradients, each layer's output and VJP fed
    the graph's own input to it, and two SGD steps. The init's forward and
    the per-layer VJPs run jitted (op by op, GoogLeNet's init alone takes
    ~40 s here)."""
    import jax

    from paddle_tpu import models as JM
    from paddle_tpu.nn.graph import reset_name_scope
    from paddle_tpu.optim import SGD as JaxSGD
    from paddle_tpu.trainer import SGDTrainer as JaxTrainer

    name = request.param
    batches = [image_batch(s) for s in (0, 1)]
    reset_name_scope()
    cost = getattr(JM, name)(num_classes=CLASSES, image_size=SIZE)[3]
    jt = JaxTrainer(cost, JaxSGD(learning_rate=LR, momentum=0.9), seed=0)
    net = jt.network
    eager_init = net.init
    net.init = lambda rng, b, **kw: jax.jit(lambda r: eager_init(r, b, **kw))(rng)
    jt.init_state(batches[0])
    rng0 = jax.random.fold_in(jt.state["rng"], jt.state["samples"])
    layers = [l for l in net.layer_order if l.type_name != "data"]
    every = type(net)(layers)

    def loss_and_values(p):
        outs, _ = every.apply(p, jt.state["states"], batches[0], train=True, rng=rng0,
                              policy=jt.policy())
        return outs["cost"].value, {k: v.value for k, v in outs.items()}

    (c, values), g = jax.jit(jax.value_and_grad(loss_and_values, has_aux=True))(
        jt.state["params"])
    params = _np(jt.state["params"])
    out = dict(name=name, batches=batches, params=params, cost=float(c), grads=_np(g),
               rng0=np.asarray(rng0),
               layers=_jax_layers_vjp(layers, batches[0], values, params, rng0))
    step = jt._make_step()
    costs = []
    for b in batches:
        jt.state, cost_k, _ = step(jt.state, b)
        costs.append(float(cost_k))
    out.update(step_costs=costs, step2_params=_np(jt.state["params"]))
    return out


def _jax_layers_vjp(layers, batch, values, params, rng):
    """Each layer but the cost fed its own copy of the graph's input to it,
    all in one jitted VJP with one random cotangent a layer -> [(layer,
    inputs, cotangent, output, input grads, parameter grads)]."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.nn.graph import Argument, Context

    layers = [l for l in layers if not l.is_cost]
    ins = [[np.asarray(batch[i.name] if i.type_name == "data" else values[i.name])
            for i in l.inputs] for l in layers]
    floats = [[x for x in xs if x.dtype == np.float32] for xs in ins]
    rs = np.random.RandomState(7)
    cts = []
    for l in layers:
        v = np.asarray(values[l.name])
        ct = rs.randn(*v.shape).astype(np.float32)
        cts.append(np.where(np.abs(v) > NEAR_ZERO * np.abs(v).max(), ct, 0.0)
                   .astype(np.float32))

    def f(fxs, ps):
        outs = []
        for l, xs, fx in zip(layers, ins, fxs):
            it = iter(fx)
            args = [Argument(next(it) if x.dtype == np.float32 else jnp.asarray(x)) for x in xs]
            ctx = Context("apply", ps, {}, rng, True)
            outs.append(l.forward(ctx, args).value)
        return outs

    def run(fxs, ps, c):
        outs, vjp = jax.vjp(f, fxs, ps)
        return outs, vjp(c)

    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    outs, (dxs, dps) = jax.jit(run)(floats, jparams, cts)
    return [(l, xs, ct, np.asarray(o), [np.asarray(d) for d in dx],
             {k: np.asarray(dps[k]) for k in params if k.startswith(l.name + ".")})
            for l, xs, ct, o, dx in zip(layers, ins, cts, outs, dxs)]


def loaded(ref, device="cpu"):
    tr = port_trainer(ref["name"], device)
    tr.init_state(ref["batches"][0])
    tr.load_params(params_from_jax(ref["params"], device=device))
    return tr


def test_names_and_shapes_match_jax(jax_model):
    tr = port_trainer(jax_model["name"])
    tr.init_state(jax_model["batches"][0])
    params = tr.state["params"]
    assert len(params) == N_PARAMS[jax_model["name"]]
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: v.shape for k, v in jax_model["params"].items()}
    assert tr.state["states"] == {}


def test_f32_cost_and_grads_match_jax(jax_model):
    tr = loaded(jax_model)
    cost, grads = tr.cost_and_grads(jax_model["batches"][0])
    assert abs(float(cost) - jax_model["cost"]) <= COST_RTOL * abs(jax_model["cost"])
    tol = TOL[jax_model["name"]]
    worst = max((rel_l2(grads[k].numpy(), g), k) for k, g in jax_model["grads"].items())
    assert worst[0] <= tol["grad"], worst
    names = sorted(grads)
    assert rel_l2(np.concatenate([grads[k].numpy().ravel() for k in names]),
                  np.concatenate([jax_model["grads"][k].ravel() for k in names])
                  ) <= tol["all_grads"]


def _port_layer_vjp(layer, ins, params, rng, ct):
    xs = [torch.tensor(x).requires_grad_(x.dtype == np.float32) for x in ins]
    own = {k: params[k].clone().requires_grad_(True) for k in params
           if k.startswith(layer.name + ".")}
    ctx = tgraph.Context("apply", {**params, **own}, device=torch.device("cpu"), train=True,
                         rng=torch.tensor(rng, dtype=torch.int64))
    out = layer.forward(ctx, [tgraph.Argument(x) for x in xs]).value
    floats = [x for x in xs if x.requires_grad]
    grads = torch.autograd.grad(out, floats + list(own.values()), torch.tensor(ct))
    return out, list(grads[:len(floats)]), dict(zip(own, grads[len(floats):]))


def test_every_layer_matches_jax(jax_model):
    """Every layer but the cost, fed the JAX package's own input to it:
    output, input gradients and parameter gradients for one random
    cotangent within LAYER_REL_L2. Dropout draws the same mask from the
    same key (one draw a context, as the step's first)."""
    tr = loaded(jax_model)
    tlayers = {l.name: l for l in tr.network.layer_order}
    errs = []
    for layer, ins, ct, want, want_dx, want_dp in jax_model["layers"]:
        got, got_dx, got_dp = _port_layer_vjp(tlayers[layer.name], ins, tr.state["params"],
                                              jax_model["rng0"], ct)
        assert len(got_dx) == len(want_dx) and set(got_dp) == set(want_dp), layer.name
        pairs = [("out", got, want)] + list(zip(["dx"] * len(got_dx), got_dx, want_dx))
        pairs += [(k, got_dp[k], w) for k, w in want_dp.items()]
        for what, g, w in pairs:
            errs.append((rel_l2(g.detach().numpy(), w), layer.name, what))
    errs.sort()
    assert errs[-1][0] <= LAYER_REL_L2, errs[-3:]
    n_layers = len([l for l in tr.network.layer_order if l.type_name != "data"])
    assert len(jax_model["layers"]) == n_layers - 1


def test_two_momentum_steps_match_jax(jax_model):
    tr = loaded(jax_model)
    costs = [float(tr.step(b)) for b in jax_model["batches"]]
    (c0, c1), (j0, j1) = costs, jax_model["step_costs"]
    assert abs(c0 - j0) <= COST_RTOL * abs(j0)
    assert abs(c1 - j1) <= STEP2_COST_RTOL * abs(j1), (c1, j1)
    worst = max((float(np.abs(tr.state["params"][k].numpy() - w).max())
                 / max(1.0, float(np.abs(w).max())), k)
                for k, w in jax_model["step2_params"].items())
    assert worst[0] <= TOL[jax_model["name"]]["step_params"], worst
    assert int(tr.state["samples"]) == 2 * BATCH


def test_googlenet_concats_take_nhwc_branches_as_they_are(monkeypatch):
    """Each inception block's Concat receives its four branches as
    contiguous NHWC tensors (the convs' and pools' NCHW views are
    channels_last, so their outputs come back NHWC-contiguous) and joins
    them with one cat: no layout copy between the branches."""
    from paddle_tpu_torch.nn import layers as TL

    tr = port_trainer("googlenet")
    batch = image_batch(3, b=2)
    tr.init_state(batch)
    assert not [l for l in tr.network.layer_order if isinstance(l, TL.SwitchOrder)]
    seen = []
    orig = TL.Concat.forward

    def spy(self, ctx, ins):
        seen.append([a.value.is_contiguous() and a.value.dim() == 4 for a in ins])
        return orig(self, ctx, ins)

    monkeypatch.setattr(TL.Concat, "forward", spy)
    with torch.no_grad():
        tr._cost(tr.state["params"], batch, train=False)
    assert len(seen) == 9 and all(all(s) and len(s) == 4 for s in seen), seen


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["alexnet", "googlenet"])
def test_cuda_cost_and_grads_match_cpu(cuda, model):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu, card = port_trainer(model), port_trainer(model, cuda)
    batch = image_batch(0)
    cpu.init_state(batch)
    card.init_state(batch)
    card.load_params({k: v.to(cuda) for k, v in cpu.state["params"].items()})
    c_cpu, g_cpu = cpu.cost_and_grads(batch)
    c_card, g_card = card.cost_and_grads(batch)
    assert abs(float(c_card) - float(c_cpu)) <= COST_RTOL * abs(float(c_cpu))
    for k, g in g_cpu.items():
        assert rel_l2(g_card[k].cpu().numpy(), g.numpy()) <= TOL[model]["grad"], k
