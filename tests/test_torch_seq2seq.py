"""The port's seq2seq NMT training graph against the JAX package's, on the
CPU.

`Seq2SeqModel` at vocab 40, embed 16, hidden 24, B=4 with ragged source
and target lengths is built in both packages; the JAX parameters move to
the port by name (`nn/convert.params_from_jax`), the batch is the same
numpy dict. The cost must agree within 1e-5 relative and each of the 22
gradients within rtol 1e-4 / atol 1e-5 against the JAX scan path
(PADDLE_TPU_PALLAS=0), and at the JAX package's own kernel-vs-scan
tolerances (tests/test_pallas_rnn.py: rtol 2e-3, atol 5e-3) against its
interpret-mode Pallas GRU."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import Seq2SeqModel as TorchSeq2Seq
from paddle_tpu_torch.nn import graph as tgraph
from paddle_tpu_torch.nn.convert import params_from_jax, params_to_jax
from paddle_tpu_torch.trainer import SGDTrainer as TorchTrainer
from paddle_tpu_torch.optim import SGD as TorchSGD

VOCAB, EMBED, HIDDEN = 40, 16, 24
NAMES = sorted([
    "src_emb.w", "trg_emb_table", "out_w", "out_b",
    *(f"enc.{d}.input_proj.{p}" for d in ("fw", "bw") for p in ("w", "b")),
    *(f"enc.{d}.{p}" for d in ("fw", "bw") for p in ("w_hzr", "w_hc", "b")),
    "decoder.att.w_enc", "decoder.att.w_dec", "decoder.att.v", "decoder.w_in",
    "decoder.w_init", "decoder.gru.w_hzr", "decoder.gru.w_hc", "decoder.gru.b",
])


def make_batch(seed=0, b=4, src_len=7, trg_len=6, vocab=VOCAB):
    rs = np.random.RandomState(seed)
    src_l = np.array([7, 2, 5, 1][:b], np.int32)
    trg_l = np.array([6, 3, 1, 4][:b], np.int32)
    return {
        "source_ids": rs.randint(2, vocab, (b, src_len)).astype(np.int32),
        "source_ids.lengths": src_l,
        "target_ids": rs.randint(2, vocab, (b, trg_len)).astype(np.int32),
        "target_ids.lengths": trg_l,
        "label_ids": rs.randint(2, vocab, (b, trg_len)).astype(np.int32),
        "label_ids.lengths": trg_l,
    }


@pytest.fixture(scope="module")
def jax_model():
    """(jax Network over the cost, numpy params)."""
    import jax

    from paddle_tpu.models import Seq2SeqModel
    from paddle_tpu.nn.graph import Network, reset_name_scope

    reset_name_scope()
    model = Seq2SeqModel(VOCAB, VOCAB, embed_dim=EMBED, hidden_dim=HIDDEN)
    net = Network(model.cost)
    params, _ = net.init(jax.random.PRNGKey(0), make_batch())
    return net, model.cost.name, {k: np.asarray(v) for k, v in params.items()}


def jax_cost_and_grads(net, cost_name, params, batch, flag, monkeypatch):
    import jax
    import jax.numpy as jnp

    monkeypatch.setenv("PADDLE_TPU_PALLAS", flag)

    def loss(p):
        outs, _ = net.apply(p, {}, batch, train=True)
        return outs[cost_name].value.astype(jnp.float32)

    cost, grads = jax.value_and_grad(loss)({k: jnp.asarray(v) for k, v in params.items()})
    return float(cost), {k: np.asarray(v) for k, v in grads.items()}


def torch_cost_and_grads(params, batch):
    tgraph.reset_name_scope()
    model = TorchSeq2Seq(VOCAB, VOCAB, embed_dim=EMBED, hidden_dim=HIDDEN)
    tr = TorchTrainer(model.cost, TorchSGD(learning_rate=0.1), device="cpu")
    tr.init_state(batch)
    tr.load_params(params_from_jax(params, device="cpu"))
    cost, grads = tr.cost_and_grads(batch)
    return float(cost), {k: g.numpy() for k, g in grads.items()}


def test_param_names_are_the_22_of_the_reference(jax_model):
    _, _, params = jax_model
    assert sorted(params) == NAMES
    tgraph.reset_name_scope()
    model = TorchSeq2Seq(VOCAB, VOCAB, embed_dim=EMBED, hidden_dim=HIDDEN)
    port = tgraph.Network(model.cost).init(make_batch(), seed=0, device="cpu")
    assert sorted(port) == NAMES
    assert {k: tuple(v.shape) for k, v in port.items()} == {
        k: v.shape for k, v in params.items()}


def test_params_round_trip_bitwise(jax_model):
    _, _, params = jax_model
    back = params_to_jax(params_from_jax(params, device="cpu"))
    assert sorted(back) == sorted(params)
    for k, v in params.items():
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], v)


@pytest.mark.parametrize("seed", [0, 1])
def test_cost_and_grads_match_jax_scan(jax_model, monkeypatch, seed):
    net, cost_name, params = jax_model
    batch = make_batch(seed)
    cj, gj = jax_cost_and_grads(net, cost_name, params, batch, "0", monkeypatch)
    ct, gt = torch_cost_and_grads(params, batch)
    assert abs(ct - cj) <= 1e-5 * abs(cj)
    assert sorted(gt) == NAMES
    for k in NAMES:
        np.testing.assert_allclose(gt[k], gj[k], rtol=1e-4, atol=1e-5, err_msg=k)


def test_cost_and_grads_match_jax_interpret_kernel(jax_model, monkeypatch):
    net, cost_name, params = jax_model
    batch = make_batch(2)
    cj, gj = jax_cost_and_grads(net, cost_name, params, batch, "interpret", monkeypatch)
    ct, gt = torch_cost_and_grads(params, batch)
    assert abs(ct - cj) <= 1e-4 * abs(cj)
    for k in NAMES:
        np.testing.assert_allclose(gt[k], gj[k], rtol=2e-3, atol=5e-3, err_msg=k)


def test_decoder_ignores_padded_target_steps():
    """Tokens past a row's target length change neither its cost nor any
    gradient (the mask carries h through and zeroes those steps' cost)."""
    batch = make_batch(3)
    tgraph.reset_name_scope()
    model = TorchSeq2Seq(VOCAB, VOCAB, embed_dim=EMBED, hidden_dim=HIDDEN)
    tr = TorchTrainer(model.cost, TorchSGD(learning_rate=0.1), device="cpu")
    tr.init_state(batch)
    c1, g1 = tr.cost_and_grads(batch)
    other = dict(batch)
    for key in ("target_ids", "label_ids", "source_ids"):
        v = batch[key].copy()
        lens = batch[key + ".lengths"]
        for i, n in enumerate(lens):
            v[i, n:] = (v[i, n:] + 7) % VOCAB
        other[key] = v
    c2, g2 = tr.cost_and_grads(other)
    torch.testing.assert_close(c1, c2, rtol=1e-6, atol=0)
    for k in g1:
        torch.testing.assert_close(g1[k], g2[k], rtol=1e-5, atol=1e-6, msg=k)
