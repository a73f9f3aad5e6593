"""CTR wide&deep (`paddle_tpu_torch/models/ctr.py`, BASELINE config #4)
against the JAX package's `models.ctr_wide_deep`, on the CPU, at the
config and batch of tests/test_models.py:80-103: wide 32, slots (16, 16),
embed 8, hidden (16,), batch 32, click <=> an even slot-0 id.

  * Parameter names and shapes equal (moved across by name).
  * Cost within 1e-5 relative, every gradient within rtol 1e-5 / atol
    1e-6 x max(1, max|g|), against jax.value_and_grad.
  * Two SGD(0.5) steps through both SGDTrainers: costs within 1e-5
    relative, parameters within 1e-6 after.
  * The port learns the click pattern through its SGDTrainer on the CPU,
    as tests/test_models.py holds the JAX package to: 60 steps, the cost
    falls more than 2x and more than 90 % of the clicks are predicted.
  * `embedding_sharding=("expert", None)` on four thread ranks trains as
    the unsharded model.
  * On a card (marked `cuda`, skipped here): the step on the card through
    the step graph (one capture, then replays) against the CPU: step-1
    cost 1e-5 relative, gradients rtol 1e-4 / atol 1e-5, parameters after
    three steps within 1e-5.
jax is imported inside the CPU tests only."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.nn import graph as tgraph
from paddle_tpu_torch.nn.convert import params_from_jax
from paddle_tpu_torch.optim import SGD as TorchSGD
from paddle_tpu_torch.trainer import SGDTrainer as TorchTrainer

CONFIG = dict(wide_dim=32, slot_vocab_sizes=(16, 16), embed_dim=8, hidden_dims=(16,))


def make_batch(seed=0, b=32):
    """tests/test_models.py:96-103's draw."""
    rs = np.random.RandomState(seed)
    slot0 = rs.randint(0, 16, b)
    click = (slot0 % 2).astype(np.float32)[:, None]
    return {"wide_features": rs.rand(b, 32).astype(np.float32) * 0.1,
            "slot0_id": slot0, "slot1_id": rs.randint(0, 16, b), "click": click}


def _jax_model():
    from paddle_tpu import models as jmodels
    from paddle_tpu.nn.graph import reset_name_scope

    reset_name_scope()
    return jmodels.ctr_wide_deep(**CONFIG)


def _torch_model():
    tgraph.reset_name_scope()
    return tmodels.ctr_wide_deep(**CONFIG)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's parameters, cost and gradients on batch 0."""
    import jax

    from paddle_tpu.nn.graph import Network

    cost = _jax_model()[3]
    net = Network([cost])
    batch = make_batch()
    params, states = net.init(jax.random.PRNGKey(0), batch)
    c, g = jax.value_and_grad(
        lambda p: net.apply(p, states, batch, train=True)[0][cost.name].value)(params)
    return dict(params={k: np.asarray(v) for k, v in params.items()}, cost=float(c),
                grads={k: np.asarray(v) for k, v in g.items()})


def port_trainer(params, batch, device="cpu", lr=0.5):
    tr = TorchTrainer(_torch_model()[3], TorchSGD(learning_rate=lr), device=device)
    tr.init_state(batch)
    tr.load_params(params_from_jax(params, device=device))
    return tr


def test_param_names_and_shapes_match(jax_ref):
    port = tgraph.Network(_torch_model()[3]).init(make_batch(), device="cpu")
    assert {k: tuple(v.shape) for k, v in port.items()} == {
        k: v.shape for k, v in jax_ref["params"].items()}
    assert {"wide_lr.w", "slot0_emb.w", "slot1_emb.w", "deep_fc0.w",
            "deep_out.w"} <= set(port)


def test_cost_and_grads_match_jax(jax_ref):
    batch = make_batch()
    ct, gt = port_trainer(jax_ref["params"], batch).cost_and_grads(batch)
    assert abs(float(ct) - jax_ref["cost"]) <= 1e-5 * abs(jax_ref["cost"])
    assert sorted(gt) == sorted(jax_ref["grads"])
    for k, g in jax_ref["grads"].items():
        np.testing.assert_allclose(gt[k].numpy(), g, rtol=1e-5,
                                   atol=1e-6 * max(1.0, float(np.abs(g).max())), err_msg=k)


def test_sgd_steps_match_jax():
    import jax

    from paddle_tpu.optim import SGD as JaxSGD
    from paddle_tpu.trainer import SGDTrainer as JaxTrainer

    batches = [make_batch(1), make_batch(2)]
    jt = JaxTrainer(_jax_model()[3], JaxSGD(learning_rate=0.5), seed=0)
    jt.init_state(batches[0])
    params0 = {k: np.asarray(v) for k, v in jt.state["params"].items()}
    step = jt._make_step()
    jax_costs = []
    for b in batches:
        jt.state, cost, _ = step(jt.state, b)
        jax_costs.append(float(cost))
    pt = port_trainer(params0, batches[0])
    port_costs = [float(pt.step(b)) for b in batches]
    np.testing.assert_allclose(port_costs, jax_costs, rtol=1e-5)
    jp = jax.device_get(jt.state["params"])
    for k, v in pt.state["params"].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_ctr_learns_the_click_pattern():
    batch = make_batch()
    ins, label, prob, cost = _torch_model()
    tr = TorchTrainer(cost, TorchSGD(learning_rate=0.5), device="cpu")
    costs = [float(tr.step(batch)) for _ in range(60)]
    assert costs[0] / costs[-1] > 2.0, costs
    outs = tgraph.Network([prob]).apply(tr.state["params"], batch)
    pred = (outs[prob.name].value.numpy() > 0.5).astype(np.float32)
    assert (pred == batch["click"]).mean() > 0.9


def test_embedding_sharding_trains_as_the_unsharded_model():
    """embedding_sharding=("expert", None) on a {"data": 1, "expert": 4}
    mesh of four thread ranks: each rank stores 4 of a table's 16 rows,
    and two SGD(0.5) steps give the unsharded trainer's costs and
    parameters (rtol 1e-5, atol 1e-6)."""
    from paddle_tpu_torch.parallel import DataParallel
    from test_torch_parallel import run_ranks

    batches = [make_batch(0), make_batch(1)]
    plain = TorchTrainer(_torch_model()[3], TorchSGD(0.5), device="cpu")
    plain.init_state(batches[0])
    want = [float(plain.step(b)) for b in batches]
    init = TorchTrainer(_torch_model()[3], TorchSGD(0.5), device="cpu")
    init.init_state(batches[0])
    start = {k: v.clone() for k, v in init.state["params"].items()}

    def rank(r, mesh):
        tgraph.reset_name_scope()
        cost = tmodels.ctr_wide_deep(embedding_sharding=("expert", None), **CONFIG)[3]
        tr = TorchTrainer(cost, TorchSGD(0.5), parallel=DataParallel(mesh))
        tr.init_state(batches[0])
        tr.load_params(start)
        rows = tuple(tr.state["params"]["slot0_emb.w"].shape)
        costs = [float(tr.step(b)) for b in batches]
        return rows, costs, tr.canonical_params()

    got = run_ranks(4, rank, axes={"data": 1, "expert": 4})
    for rows, costs, params in got:
        assert rows == (4, 8)
        np.testing.assert_allclose(costs, want, rtol=1e-5)
        for k, v in plain.state["params"].items():
            torch.testing.assert_close(params[k], v, rtol=1e-5, atol=1e-6, msg=k)


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_steps_in_the_graph_match_cpu(cuda):
    batches = [make_batch(3), make_batch(4), make_batch(5)]
    cpu = TorchTrainer(_torch_model()[3], TorchSGD(0.5), device="cpu")
    cpu.init_state(batches[0])
    card = TorchTrainer(_torch_model()[3], TorchSGD(0.5), device=cuda)
    card.init_state(batches[0])
    card.load_params(cpu.state["params"])
    c_card, g_card = card.cost_and_grads(batches[0])
    c_cpu, g_cpu = cpu.cost_and_grads(batches[0])
    assert abs(float(c_card) - float(c_cpu)) <= 1e-5 * abs(float(c_cpu))
    for k in g_cpu:
        torch.testing.assert_close(g_card[k].cpu(), g_cpu[k], rtol=1e-4, atol=1e-5, msg=k)
    for b in batches:
        card.step(b)
        cpu.step(b)
    graphs = list(card.graphs.values())
    assert len(graphs) == 1 and graphs[0].replays == 2
    for k, v in cpu.state["params"].items():
        torch.testing.assert_close(card.state["params"][k].cpu(), v, rtol=0, atol=1e-5, msg=k)
