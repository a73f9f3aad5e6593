"""OCR CRNN + CTC (`paddle_tpu_torch/models/ocr_crnn.py`, BASELINE config
#5) and `BlockExpand` against the JAX package's, on the CPU.

  * `BlockExpand` (im2seq) against the JAX layer at C > 1, both blocks > 1,
    strides and padding: values and the input's gradient under a random
    cotangent within 1e-6, lengths equal; each step's features run channel
    slowest, (C, block_y, block_x), as `conv_general_dilated_patches` lays
    them out (x = arange(12) as [1, 2, 2, 3] with a (2, 1) block reads
    [0, 6, 1, 7, 2, 8] first).
  * The whole CRNN at tests/test_models.py:130-137's config (32x64x1, 10
    classes, hidden 16, batch 2, labels of 6 and 4 ids): parameter and
    state names and shapes equal; the train-mode cost within 1e-5
    relative, every gradient within rtol 1e-4 / atol 1e-5 x max(1,
    max|g|) (the tolerance tests/test_torch_text_lstm.py holds the peephole
    step loop to), the batch norm's new moving statistics within 1e-5.
    Not 1e-5 / 1e-6 as for each layer alone: the port parts from the JAX
    package by up to 2.0e-5 x max|g| (the LSTMs' input projections), and
    the JAX package from itself, jit against op-by-op, by up to 4.9e-6 x
    max|g| (c3.w): the sums of this graph's gradients are not stable to
    1e-6 under a change of order.
  * Two SGD(0.01) steps through both SGDTrainers: costs within 1e-5
    relative, parameters and states within 1e-5 after.
  * The port's cost falls on a fixed batch through its SGDTrainer, as
    tests/test_models.py holds the JAX package to (25 steps, below 0.8x).
  * On a card (marked `cuda`, skipped here): the step through the step
    graph against the CPU: step-1 cost 1e-5 relative, gradients rtol 1e-3 /
    atol 1e-4 x max(1, max|g|), every state after three steps within 1e-4.
jax is imported inside the CPU tests only."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.nn import graph as tgraph
from paddle_tpu_torch.nn import layers as TL
from paddle_tpu_torch.nn.convert import params_from_jax
from paddle_tpu_torch.optim import SGD as TorchSGD
from paddle_tpu_torch.trainer import SGDTrainer as TorchTrainer

CONFIG = dict(image_height=32, image_width=64, num_classes=10, rnn_hidden=16)


def make_batch(seed=0):
    """tests/test_models.py:131-137's draw."""
    rs = np.random.RandomState(seed)
    return {"image": rs.randn(2, 32, 64, 1).astype(np.float32),
            "label": rs.randint(1, 11, (2, 6)).astype(np.int32),
            "label.lengths": np.asarray([6, 4], np.int32)}


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


# -- BlockExpand ---------------------------------------------------------------


@pytest.mark.parametrize("kw,shape", [
    (dict(block_x=1, block_y=2), (1, 2, 2, 3)),
    (dict(block_x=2, block_y=3), (2, 5, 6, 3)),
    (dict(block_x=3, block_y=2, stride_x=2, stride_y=1), (2, 5, 7, 2)),
    (dict(block_x=2, block_y=2, padding_x=1, padding_y=2), (1, 4, 5, 4)),
    (dict(block_x=1, block_y=4), (2, 4, 16, 8)),  # the CRNN's im2seq, narrowed
])
def test_block_expand_matches_jax(kw, shape):
    import jax
    import jax.numpy as jnp

    from paddle_tpu.nn import graph as jgraph
    from paddle_tpu.nn import layers as JL

    if shape == (1, 2, 2, 3):
        x = np.arange(12, dtype=np.float32).reshape(shape)
    else:
        x = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    batch = {"img": x}
    jgraph.reset_name_scope()
    jnet = jgraph.Network([JL.BlockExpand(JL.Data("img", shape=shape[1:]), name="be", **kw)])
    params, states = jnet.init(jax.random.PRNGKey(0), batch)
    out = jnet.apply(params, states, batch)[0]["be"]
    want, vjp = jax.vjp(lambda v: jnet.apply(params, states, {"img": v})[0]["be"].value,
                        jnp.asarray(x))
    cot = np.random.RandomState(1).randn(*want.shape).astype(np.float32)
    (want_g,) = vjp(jnp.asarray(cot))

    tgraph.reset_name_scope()
    tnet = tgraph.Network([TL.BlockExpand(TL.Data("img", shape=shape[1:]), name="be", **kw)])
    xt = torch.tensor(x, requires_grad=True)
    got = tnet.apply({"device": xt}, {"img": xt})["be"]
    (got_g,) = torch.autograd.grad(got.value, xt, torch.from_numpy(cot))
    np.testing.assert_allclose(got.value.detach().numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(out.lengths))
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-6, atol=1e-6)
    if shape == (1, 2, 2, 3):
        assert got.value[0, 0].tolist() == [0, 6, 1, 7, 2, 8]


# -- the CRNN --------------------------------------------------------------------


def _jax_cost():
    from paddle_tpu import models as jmodels
    from paddle_tpu.nn.graph import reset_name_scope

    reset_name_scope()
    return jmodels.ocr_crnn(**CONFIG)[3]


def _torch_cost():
    tgraph.reset_name_scope()
    return tmodels.ocr_crnn(**CONFIG)[3]


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's parameters, states, train-mode cost, gradients and
    new states on batch 0."""
    import jax

    from paddle_tpu.nn.graph import Network

    cost = _jax_cost()
    net = Network([cost])
    batch = make_batch()
    params, states = net.init(jax.random.PRNGKey(0), batch)

    def loss(p):
        outs, new = net.apply(p, states, batch, train=True)
        return outs[cost.name].value, new

    (c, new_states), g = jax.value_and_grad(loss, has_aux=True)(params)
    return dict(params=_np(params), states=_np(states), cost=float(c), grads=_np(g),
                new_states=_np(new_states))


def port_trainer(ref, batch, device="cpu", lr=0.01):
    tr = TorchTrainer(_torch_cost(), TorchSGD(learning_rate=lr), device=device)
    tr.init_state(batch)
    tr.load_params(params_from_jax(ref["params"], device=device))
    tr.load_states(params_from_jax(ref["states"], device=device))
    return tr


def test_param_and_state_names_match(jax_ref):
    params, states = tgraph.Network(_torch_cost()).init(make_batch(), device="cpu",
                                                        with_states=True)
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: v.shape for k, v in jax_ref["params"].items()}
    assert sorted(states) == sorted(jax_ref["states"]) == ["bn3.moving_mean",
                                                           "bn3.moving_var"]
    assert sum(".check_" in k for k in params) == 6  # peepholes, both directions


def test_cost_grads_and_states_match_jax(jax_ref):
    batch = make_batch()
    tr = port_trainer(jax_ref, batch)
    ct, gt, new_states = tr.cost_grads_and_states(batch)
    assert abs(float(ct) - jax_ref["cost"]) <= 1e-5 * abs(jax_ref["cost"])
    assert sorted(gt) == sorted(jax_ref["grads"])
    for k, g in jax_ref["grads"].items():
        np.testing.assert_allclose(gt[k].numpy(), g, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(g).max())), err_msg=k)
    for k, v in jax_ref["new_states"].items():
        np.testing.assert_allclose(new_states[k].numpy(), v, rtol=1e-5, atol=1e-5, err_msg=k)


def test_sgd_steps_match_jax():
    import jax

    from paddle_tpu.optim import SGD as JaxSGD
    from paddle_tpu.trainer import SGDTrainer as JaxTrainer

    batches = [make_batch(1), make_batch(2)]
    jt = JaxTrainer(_jax_cost(), JaxSGD(learning_rate=0.01), seed=0)
    jt.init_state(batches[0])
    ref = dict(params=_np(jt.state["params"]), states=_np(jt.state["states"]))
    step = jt._make_step()
    jax_costs = []
    for b in batches:
        jt.state, cost, _ = step(jt.state, b)
        jax_costs.append(float(cost))
    pt = port_trainer(ref, batches[0])
    port_costs = [float(pt.step(b)) for b in batches]
    np.testing.assert_allclose(port_costs, jax_costs, rtol=1e-5)
    for kind in ("params", "states"):
        want = jax.device_get(jt.state[kind])
        for k, v in pt.state[kind].items():
            np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5,
                                       err_msg=k)


def test_ocr_cost_falls():
    batch = make_batch()
    tr = TorchTrainer(_torch_cost(), TorchSGD(learning_rate=0.01), device="cpu")
    costs = [float(tr.step(batch)) for _ in range(25)]
    assert np.isfinite(costs).all() and costs[-1] < 0.8 * costs[0], costs


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_steps_in_the_graph_match_cpu(cuda):
    batches = [make_batch(3), make_batch(4), make_batch(5)]
    cpu = TorchTrainer(_torch_cost(), TorchSGD(0.01), device="cpu")
    cpu.init_state(batches[0])
    card = TorchTrainer(_torch_cost(), TorchSGD(0.01), device=cuda)
    card.init_state(batches[0])
    card.load_params(cpu.state["params"])
    c_card, g_card = card.cost_and_grads(batches[0])
    c_cpu, g_cpu = cpu.cost_and_grads(batches[0])
    assert abs(float(c_card) - float(c_cpu)) <= 1e-5 * abs(float(c_cpu))
    for k, g in g_cpu.items():
        torch.testing.assert_close(g_card[k].cpu(), g, rtol=1e-3,
                                   atol=1e-4 * max(1.0, float(g.abs().max())), msg=k)
    for b in batches:
        card.step(b)
        cpu.step(b)
    graphs = list(card.graphs.values())
    assert len(graphs) == 1 and graphs[0].replays == 2
    for k, v in cpu.state["states"].items():
        torch.testing.assert_close(card.state["states"][k].cpu(), v, rtol=1e-4, atol=1e-4,
                                   msg=k)
