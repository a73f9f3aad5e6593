"""The port's LSTM text classifier (`paddle_tpu_torch/models/text_lstm.py`),
its peephole-free twin and `SeqPool` against the JAX package's, on the CPU.

Both graphs are built in each package from the same public calls:
embedding -> 2 x (fc(4H) + lstmemory) -> max SeqPool -> fc(2) ->
ClassificationCost, at vocab 50, embed 8, hidden 12, B=4 with ragged
lengths (one row full, one of length 1). `peep=False` is the network the
fused LSTM kernels carry (`simple_lstm(..., use_peephole=False)`, built by
`build_net` below for both packages); `text_lstm` as built keeps the
peepholes and runs the step loop. The JAX parameters move to the port by
name (`nn/convert.params_from_jax`).

  * Cost within 1e-5 relative and every gradient within rtol 1e-4 / atol
    1e-5 against the JAX scan path (PADDLE_TPU_PALLAS=0); the peephole-free
    network also at the JAX package's kernel tolerances (rtol 2e-3 / atol
    5e-3, cost 1e-4) against its interpret-mode Pallas LSTM.
  * Two SGD(0.01) steps through both SGDTrainers: costs within 1e-5
    relative, parameters within 1e-6 after.
  * `SeqPool` in each pool type, on a sequence and a non-sequence input,
    values and gradients (1e-6); an unknown pool type raises.
  * On a card (marked `cuda`, skipped here): the peephole-free network's
    cost and gradients on the card (kernels) vs the CPU (plain versions)."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.nn import costs as TC
from paddle_tpu_torch.nn import graph as tgraph
from paddle_tpu_torch.nn import layers as TL
from paddle_tpu_torch.nn import recurrent as TR
from paddle_tpu_torch.nn import seq_layers as TS
from paddle_tpu_torch.nn.convert import params_from_jax, params_to_jax
from paddle_tpu_torch.ops import rnn_kernels as K
from paddle_tpu_torch.ops import sequence as tseq
from paddle_tpu_torch.optim import SGD as TorchSGD
from paddle_tpu_torch.trainer import SGDTrainer as TorchTrainer

VOCAB, EMBED, HIDDEN, LAYERS = 50, 8, 12, 2


def build_net(L, C, R, S, vocab=VOCAB, embed=EMBED, hidden=HIDDEN, layers=LAYERS,
              peep=False):
    """The text-classification graph from either package's public layers
    (L layers, C costs, R recurrent, S seq_layers) -> (data, label, cost)."""
    ids = L.Data("word_ids", shape=(vocab,), is_seq=True)
    label = L.Data("label", shape=())
    x = L.Embedding(ids, embed, vocab_size=vocab, name="emb")
    for i in range(layers):
        x = R.simple_lstm(x, hidden, name=f"lstm{i}", use_peephole=peep)
    pooled = S.SeqPool(x, "max", name="pool")
    logits = L.Fc(pooled, 2, act=None, name="logits")
    return ids, label, C.ClassificationCost(logits, label, name="cost")


def make_batch(seed=0, b=4, t=6):
    rs = np.random.RandomState(seed)
    lens = rs.randint(1, t + 1, b).astype(np.int32)
    lens[0], lens[1] = t, 1
    return {"word_ids": rs.randint(0, VOCAB, (b, t)).astype(np.int32),
            "word_ids.lengths": lens, "label": rs.randint(0, 2, b).astype(np.int32)}


def _jax_cost(which):
    from paddle_tpu import models as jmodels
    from paddle_tpu.nn import costs as JC
    from paddle_tpu.nn import layers as JL
    from paddle_tpu.nn import recurrent as JR
    from paddle_tpu.nn import seq_layers as JS
    from paddle_tpu.nn.graph import reset_name_scope

    reset_name_scope()
    if which == "text_lstm":
        return jmodels.text_lstm(VOCAB, EMBED, HIDDEN, LAYERS)[3]
    return build_net(JL, JC, JR, JS)[2]


def _torch_cost(which):
    tgraph.reset_name_scope()
    if which == "text_lstm":
        return tmodels.text_lstm(VOCAB, EMBED, HIDDEN, LAYERS)[3]
    return build_net(TL, TC, TR, TS)[2]


@pytest.fixture(scope="module", params=["peep_free", "text_lstm"])
def jax_net(request):
    """(which, jax Network over the cost, cost name, numpy params)."""
    import jax

    from paddle_tpu.nn.graph import Network

    cost = _jax_cost(request.param)
    net = Network(cost)
    params, _ = net.init(jax.random.PRNGKey(0), make_batch())
    return request.param, net, cost.name, {k: np.asarray(v) for k, v in params.items()}


def jax_cost_and_grads(net, cost_name, params, batch, flag, monkeypatch):
    import jax
    import jax.numpy as jnp

    monkeypatch.setenv("PADDLE_TPU_PALLAS", flag)

    def loss(p):
        outs, _ = net.apply(p, {}, batch, train=True)
        return outs[cost_name].value.astype(jnp.float32)

    cost, grads = jax.value_and_grad(loss)({k: jnp.asarray(v) for k, v in params.items()})
    return float(cost), {k: np.asarray(v) for k, v in grads.items()}


def torch_trainer(which, params, batch, device="cpu", lr=0.01):
    tr = TorchTrainer(_torch_cost(which), TorchSGD(learning_rate=lr), device=device)
    tr.init_state(batch)
    tr.load_params(params_from_jax(params, device=device))
    return tr


def test_param_names_and_shapes_match(jax_net):
    which, _, _, params = jax_net
    port = tgraph.Network(_torch_cost(which)).init(make_batch(), device="cpu")
    assert {k: tuple(v.shape) for k, v in port.items()} == {
        k: v.shape for k, v in params.items()}
    peep = which == "text_lstm"
    assert sum(".check_" in k for k in params) == (3 * LAYERS if peep else 0)
    assert len(params) == 1 + 4 * LAYERS + 2 + (3 * LAYERS if peep else 0)


def test_params_round_trip_bitwise(jax_net):
    _, _, _, params = jax_net
    back = params_to_jax(params_from_jax(params, device="cpu"))
    assert sorted(back) == sorted(params)
    for k, v in params.items():
        np.testing.assert_array_equal(back[k], v)


@pytest.mark.parametrize("seed", [0, 1])
def test_cost_and_grads_match_jax_scan(jax_net, monkeypatch, seed):
    which, net, cost_name, params = jax_net
    batch = make_batch(seed)
    cj, gj = jax_cost_and_grads(net, cost_name, params, batch, "0", monkeypatch)
    ct, gt = torch_trainer(which, params, batch).cost_and_grads(batch)
    assert abs(float(ct) - cj) <= 1e-5 * abs(cj)
    assert sorted(gt) == sorted(gj)
    for k in gj:
        np.testing.assert_allclose(gt[k].numpy(), gj[k], rtol=1e-4, atol=1e-5, err_msg=k)


def test_cost_and_grads_match_jax_interpret_kernel(jax_net, monkeypatch):
    which, net, cost_name, params = jax_net
    batch = make_batch(2)
    cj, gj = jax_cost_and_grads(net, cost_name, params, batch, "interpret", monkeypatch)
    ct, gt = torch_trainer(which, params, batch).cost_and_grads(batch)
    assert abs(float(ct) - cj) <= 1e-4 * abs(cj)
    for k in gj:
        np.testing.assert_allclose(gt[k].numpy(), gj[k], rtol=2e-3, atol=5e-3, err_msg=k)


def test_sgd_steps_match_jax(jax_net, monkeypatch):
    import jax

    from paddle_tpu.optim import SGD as JaxSGD
    from paddle_tpu.trainer import SGDTrainer as JaxTrainer

    which, _, _, _ = jax_net
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "0")
    batches = [make_batch(3), make_batch(4)]
    jt = JaxTrainer(_jax_cost(which), JaxSGD(learning_rate=0.01), seed=0)
    jt.init_state(batches[0])
    params0 = {k: np.asarray(v) for k, v in jt.state["params"].items()}
    step = jt._make_step()
    jax_costs = []
    for b in batches:
        jt.state, cost, _ = step(jt.state, b)
        jax_costs.append(float(cost))
    pt = torch_trainer(which, params0, batches[0])
    port_costs = [float(pt.step(b)) for b in batches]
    np.testing.assert_allclose(port_costs, jax_costs, rtol=1e-5)
    jp = jax.device_get(jt.state["params"])
    for k, v in pt.state["params"].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_peephole_free_net_takes_the_fused_op_and_text_lstm_does_not(monkeypatch):
    from paddle_tpu_torch.ops import rnn as trnn

    calls = []
    real = trnn.lstm_seq_fused
    monkeypatch.setattr(trnn, "lstm_seq_fused", lambda *a: calls.append(1) or real(*a))
    batch = make_batch(5)
    for which in ("text_lstm", "peep_free"):
        net = tgraph.Network(_torch_cost(which))
        params = net.init(batch, device="cpu")
        calls.clear()
        net.apply(params, batch)
    assert len(calls) == LAYERS


# -- SeqPool -----------------------------------------------------------------


POOLS = ["sum", "average", "avg", "max", "sqrt"]


@pytest.mark.parametrize("is_seq", [True, False])
@pytest.mark.parametrize("pool", POOLS)
def test_seq_pool_matches_jax(pool, is_seq):
    import jax
    import jax.numpy as jnp

    from paddle_tpu.nn import graph as jgraph
    from paddle_tpu.nn import layers as JL
    from paddle_tpu.nn import seq_layers as JS

    rs = np.random.RandomState(6)
    shape = (4, 5, 3) if is_seq else (4, 3)
    batch = {"x": rs.randn(*shape).astype(np.float32)}
    if is_seq:
        batch["x.lengths"] = np.array([5, 1, 3, 0], np.int32)
    jgraph.reset_name_scope()
    jl = JS.SeqPool(JL.Data("x", shape=(3,), is_seq=is_seq), pool, name="p")
    jnet = jgraph.Network([jl])
    jparams, jstates = jnet.init(jax.random.PRNGKey(0), batch)

    def jf(x):
        outs, _ = jnet.apply(jparams, jstates, dict(batch, x=x))
        return outs["p"].value

    want = np.asarray(jf(jnp.asarray(batch["x"])))
    want_g = np.asarray(jax.grad(lambda x: jnp.sum(jf(x) ** 3))(jnp.asarray(batch["x"])))

    tgraph.reset_name_scope()
    tl = TS.SeqPool(TL.Data("x", shape=(3,), is_seq=is_seq), pool, name="p")
    tnet = tgraph.Network([tl])
    x = torch.tensor(batch["x"], requires_grad=True)
    assert tnet.init(batch, device="cpu") == {}
    # the graph has no parameters: apply takes its device from this entry
    out = tnet.apply({"device": x}, dict(batch, x=x))["p"]
    assert out.lengths is None
    (g,) = torch.autograd.grad((out.value ** 3).sum(), x)
    np.testing.assert_allclose(out.value.detach().numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-6, atol=1e-6)


def test_seq_pool_unported_modes_raise():
    """Both modes that raised here are ported now (held against the JAX
    package in tests/test_torch_seq_layers.py); an unknown pool type still
    raises."""
    x = TL.Data("x", shape=(3,), is_seq=True)
    assert TS.SeqPool(x, "sum", agg_level="seq").agg_level == "seq"
    assert TS.SeqPool(x, "max", stride=2).stride == 2
    with pytest.raises(ValueError, match="pool_type"):
        TS.SeqPool(x, "median")


@pytest.mark.parametrize("fn", ["seq_sum", "seq_mean", "seq_max", "seq_sqrt_pool",
                                "seq_last"])
def test_sequence_ops_match_jax(fn):
    import jax.numpy as jnp

    from paddle_tpu.ops import sequence as jseq

    rs = np.random.RandomState(7)
    x = rs.randn(4, 6, 3).astype(np.float32)
    lens = np.array([6, 1, 4, 0], np.int32)
    want = np.asarray(getattr(jseq, fn)(jnp.asarray(x), jnp.asarray(lens)))
    got = getattr(tseq, fn)(torch.tensor(x), torch.tensor(lens)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_network_matches_cpu(cuda):
    batch = make_batch(8)
    cpu = TorchTrainer(_torch_cost("peep_free"), TorchSGD(0.01), device="cpu")
    cpu.init_state(batch)
    card = TorchTrainer(_torch_cost("peep_free"), TorchSGD(0.01), device=cuda)
    card.init_state(batch)
    card.load_params(cpu.state["params"])
    before = (K.LSTM_FWD_LAUNCHES, K.LSTM_BWD_LAUNCHES)
    c_card, g_card = card.cost_and_grads(batch)
    torch.cuda.synchronize()
    assert (K.LSTM_FWD_LAUNCHES - before[0], K.LSTM_BWD_LAUNCHES - before[1]) == (
        LAYERS, LAYERS)
    c_cpu, g_cpu = cpu.cost_and_grads(batch)
    assert abs(float(c_card) - float(c_cpu)) <= 1e-5 * abs(float(c_cpu))
    for k in g_cpu:
        torch.testing.assert_close(g_card[k].cpu(), g_cpu[k], rtol=1e-3, atol=1e-4, msg=k)
