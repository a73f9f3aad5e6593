"""The training step with its counters on the device, and as one CUDA graph.

On the CPU (eager: the CPU has no graphs):
  * the optimizer's `t` is a 0-d int32 tensor on the parameters' device,
    and `update` writes into the parameters' and slots' own storage the
    values `update_one` computes (bitwise), for SGD with momentum and Adam;
  * 3 in-place steps from JAX parameters match the JAX step (SGD with
    momentum: costs rtol 1e-5, parameters atol 1e-5; Adam: costs rtol 1e-4,
    as in tests/test_torch_trainer.py);
  * `multi_step` of K = 3 equals 3 steps bitwise, and `load_params` /
    `load` keep the state's storage (the pointers a graph holds).

On the card (`cuda`, skipped elsewhere): replayed steps match eager steps
from the same state (costs within 1e-6 relative, parameters within 1e-6
relative L2 after 4 steps, 3 of them replayed; whether they are bitwise
is printed); a K = 4
`multi_step` graph matches 4 single replays; a `load` after the capture is
seen by the next replay; GRU and LSTM launch counts read 2 + 2 a step
under replay; the costs handed out survive the next replay; a new
signature is captured while the async checkpoint writer writes."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import Seq2SeqModel as TorchSeq2Seq
from paddle_tpu_torch.nn import graph as tgraph
from paddle_tpu_torch.nn.convert import params_from_jax
from paddle_tpu_torch.optim import SGD, Adam
from paddle_tpu_torch.trainer import SGDTrainer

VOCAB, EMBED, HIDDEN = 24, 16, 20
REPLAY_RTOL = 1e-6


def make_batch(seed, b=4, src_len=7, trg_len=6):
    rs = np.random.RandomState(seed)
    src_l = rs.randint(1, src_len + 1, b).astype(np.int32)
    trg_l = rs.randint(1, trg_len + 1, b).astype(np.int32)
    src_l[0], trg_l[0] = src_len, trg_len
    return {
        "source_ids": rs.randint(2, VOCAB, (b, src_len)).astype(np.int32),
        "source_ids.lengths": src_l,
        "target_ids": rs.randint(2, VOCAB, (b, trg_len)).astype(np.int32),
        "target_ids.lengths": trg_l,
        "label_ids": rs.randint(2, VOCAB, (b, trg_len)).astype(np.int32),
        "label_ids.lengths": trg_l,
    }


def trainer(opt, device="cpu"):
    tgraph.reset_name_scope()
    m = TorchSeq2Seq(VOCAB, VOCAB, embed_dim=EMBED, hidden_dim=HIDDEN)
    return SGDTrainer(m.cost, opt, seed=0, device=device)


# -- on the CPU ------------------------------------------------------------------


@pytest.mark.parametrize("opt", [SGD(learning_rate=0.1, momentum=0.9),
                                 Adam(learning_rate=1e-2)], ids=["sgd", "adam"])
def test_update_writes_update_one_into_own_storage(opt):
    rs = np.random.RandomState(0)
    params = {n: torch.from_numpy(rs.randn(3, 5).astype(np.float32)) for n in "ab"}
    state = opt.init_state(params)
    assert state["t"].dtype == torch.int32 and state["t"].shape == ()
    for step in range(1, 4):
        grads = {n: torch.from_numpy(rs.randn(3, 5).astype(np.float32)) for n in "ab"}
        want = {n: opt.update_one(n, grads[n], state["slots"][n], params[n], 0.05, step)
                for n in "ab"}
        ptrs = {n: params[n].data_ptr() for n in "ab"}
        opt.update(grads, state, params, torch.tensor(0.05))
        assert int(state["t"]) == step
        for n in "ab":
            assert params[n].data_ptr() == ptrs[n]
            assert torch.equal(params[n], want[n][0])
            for own, new in zip(state["slots"][n], want[n][1]):
                assert torch.equal(own, new)


def _jax_steps(jax_opt, batches, monkeypatch):
    import jax

    from paddle_tpu.models import Seq2SeqModel
    from paddle_tpu.nn.graph import reset_name_scope
    from paddle_tpu.trainer import SGDTrainer as JaxTrainer

    monkeypatch.setenv("PADDLE_TPU_PALLAS", "0")
    reset_name_scope()
    jt = JaxTrainer(Seq2SeqModel(VOCAB, VOCAB, embed_dim=EMBED, hidden_dim=HIDDEN).cost,
                    jax_opt, seed=0)
    jt.init_state(batches[0])
    params0 = {k: np.asarray(v) for k, v in jt.state["params"].items()}
    step = jt._make_step()
    costs = []
    for b in batches:
        jt.state, cost, _ = step(jt.state, b)
        costs.append(float(cost))
    return params0, costs, {k: np.asarray(v) for k, v in
                            jax.device_get(jt.state["params"]).items()}


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_in_place_steps_match_jax(kind, monkeypatch):
    from paddle_tpu.optim import SGD as JaxSGD
    from paddle_tpu.optim import Adam as JaxAdam

    batches = [make_batch(s) for s in range(3)]
    if kind == "sgd":
        jopt, popt, rtol = JaxSGD(learning_rate=0.5, momentum=0.9), SGD(
            learning_rate=0.5, momentum=0.9), 1e-5
    else:
        jopt, popt, rtol = JaxAdam(learning_rate=1e-2), Adam(learning_rate=1e-2), 1e-4
    params0, jcosts, jparams = _jax_steps(jopt, batches, monkeypatch)
    tr = trainer(popt)
    tr.init_state(batches[0])
    tr.load_params(params_from_jax(params0, device="cpu"))
    costs = [float(tr.step(b)) for b in batches]
    np.testing.assert_allclose(costs, jcosts, rtol=rtol)
    assert int(tr.state["opt"]["t"]) == 3 and tr.state["samples"] == 12
    if kind == "sgd":
        for k, v in jparams.items():
            np.testing.assert_allclose(tr.state["params"][k].numpy(), v, rtol=0, atol=1e-5,
                                       err_msg=k)


def test_multi_step_is_bitwise_steps_and_loads_keep_storage(tmp_path):
    batches = [make_batch(s) for s in range(3)]
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    one, multi = trainer(Adam(learning_rate=1e-2)), trainer(Adam(learning_rate=1e-2))
    singles = [one.step(b) for b in batches]
    ptrs = {k: v.data_ptr() for k, v in multi.init_state(batches[0])["params"].items()}
    costs = multi.multi_step(stacked)
    assert torch.equal(costs, torch.stack(singles))
    for k, v in one.state["params"].items():
        assert torch.equal(multi.state["params"][k], v), k
    assert int(multi.state["opt"]["t"]) == 3 and multi.state["samples"] == 12
    multi.load_params(one.state["params"])
    one.save(str(tmp_path), 0)
    multi.load(str(tmp_path))
    assert {k: v.data_ptr() for k, v in multi.state["params"].items()} == ptrs


# -- on the card -------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs have no CPU mode")


def eager_steps(tr, batches):
    """Steps through the eager body the capture records, on the card, with
    no graph: the reference a replay is held against."""
    return [float(tr._eager(b, 1)[0][0]) for b in batches]


def rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp(min=1e-30))


def pair(device="cuda"):
    a, b = trainer(Adam(learning_rate=1e-2), device), trainer(Adam(learning_rate=1e-2),
                                                                device)
    a.init_state(make_batch(0))
    b.init_state(make_batch(0))
    b.load_params(a.state["params"])
    return a, b


@pytest.mark.cuda
def test_cuda_replayed_steps_match_eager(cuda):
    from paddle_tpu_torch.ops import rnn_kernels as K

    a, b = pair()
    batches = [make_batch(1)] * 4  # step 1 eager + capture, then 3 replays
    K.FWD_LAUNCHES = K.BWD_LAUNCHES = 0
    got = [float(a.step(x)) for x in batches]
    assert len(a.graphs) == 1
    assert (K.FWD_LAUNCHES, K.BWD_LAUNCHES) == (8, 8)
    want = eager_steps(b, batches)
    np.testing.assert_allclose(got, want, rtol=REPLAY_RTOL)
    errs = {k: rel_l2(v, b.state["params"][k]) for k, v in a.state["params"].items()}
    bitwise = all(torch.equal(v, b.state["params"][k]) for k, v in a.state["params"].items())
    print(f"replay vs eager after 4 steps: bitwise={bitwise}, worst rel L2 "
          f"{max(errs.values()):.3g}")
    assert max(errs.values()) <= REPLAY_RTOL, errs
    assert int(a.state["opt"]["t"]) == int(b.state["opt"]["t"]) == 4


@pytest.mark.cuda
def test_cuda_multi_step_graph_matches_single_replays(cuda):
    a, b = pair()
    warm = make_batch(9)
    a.step(warm)
    b.step(warm)  # each captures its single-step graph
    windows = []
    for w in range(2):
        batches = [make_batch(10 + 4 * w + i) for i in range(4)]
        windows.append((batches, {k: np.stack([x[k] for x in batches]) for k in batches[0]}))
    for i, (batches, stacked) in enumerate(windows):
        # window 0: a runs K = 4 eagerly and captures; window 1 replays it
        got = a.multi_step(stacked)
        want = torch.stack([b.step(x) for x in batches])  # single replays
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=REPLAY_RTOL)
    assert sorted(k for k, _ in a.graphs) == [1, 4]
    errs = {k: rel_l2(v, b.state["params"][k]) for k, v in a.state["params"].items()}
    assert max(errs.values()) <= REPLAY_RTOL, errs
    assert a.state["samples"] == b.state["samples"] == 9 * 4


@pytest.mark.cuda
def test_cuda_load_after_capture_is_seen_by_the_next_replay(cuda, tmp_path):
    a, b = pair()
    x = make_batch(3)
    a.step(x)
    a.step(x)  # captured and replayed once
    b.step(x)
    b.save(str(tmp_path), 0)
    a.load(str(tmp_path))  # copies into the storage the graph holds
    assert len(a.graphs) == 1
    assert float(a.step(x)) == pytest.approx(float(b.step(x)), rel=REPLAY_RTOL)
    for k, v in a.state["params"].items():
        assert rel_l2(v, b.state["params"][k]) <= REPLAY_RTOL, k


@pytest.mark.cuda
def test_cuda_costs_handed_out_survive_the_next_replay(cuda):
    a, _ = pair()
    x, y = make_batch(4), make_batch(5)
    a.step(x)
    c1 = a.step(x)
    v1 = float(c1)
    a.step(y)
    assert float(c1) == v1


@pytest.mark.cuda
def test_cuda_lstm_launches_under_replay(cuda):
    from paddle_tpu_torch.nn import costs as C
    from paddle_tpu_torch.nn import layers as L
    from paddle_tpu_torch.nn.recurrent import simple_lstm
    from paddle_tpu_torch.nn.seq_layers import SeqPool
    from paddle_tpu_torch.ops import rnn_kernels as K

    tgraph.reset_name_scope()
    ids = L.Data("w", shape=(30,), is_seq=True)
    x = L.Embedding(ids, 8, vocab_size=30, name="emb")
    for i in range(2):
        x = simple_lstm(x, 16, name=f"l{i}", use_peephole=False)
    cost = C.ClassificationCost(L.Fc(SeqPool(x, "max", name="p"), 2, act=None, name="fc"),
                                L.Data("y", shape=()), name="cost")
    tr = SGDTrainer(cost, SGD(learning_rate=0.1), device="cuda")
    rs = np.random.RandomState(0)
    batch = {"w": rs.randint(0, 30, (4, 9)).astype(np.int32),
             "w.lengths": np.array([9, 3, 5, 1], np.int32),
             "y": rs.randint(0, 2, 4)}
    tr.init_state(batch)  # its forward launches the LSTM kernels too
    K.LSTM_FWD_LAUNCHES = K.LSTM_BWD_LAUNCHES = 0
    costs = [float(tr.step(batch)) for _ in range(5)]
    assert (K.LSTM_FWD_LAUNCHES, K.LSTM_BWD_LAUNCHES) == (10, 10)
    assert len(tr.graphs) == 1 and costs[-1] < costs[0]


@pytest.mark.cuda
def test_cuda_capture_while_the_checkpoint_writer_writes(cuda, tmp_path):
    """Pass 0 ends in an async save; pass 1 opens with a batch of a new
    shape, so its step is captured while the writer thread waits on the
    copies' event and writes. Every pass's graph replays afterwards."""
    tr = trainer(Adam(learning_rate=1e-2), "cuda")
    small, large = make_batch(20), make_batch(21, b=6)

    def reader():
        # pass 0: small batches; later passes open with a large one
        yield from ([small, small] if not tr.graphs else [large, small, large])

    tr.train(reader, num_passes=3, save_dir=str(tmp_path), async_checkpoint=True)
    assert len(tr.graphs) == 2
    assert all(g.replays >= 1 for g in tr.graphs.values())
    fresh = trainer(Adam(learning_rate=1e-2), "cuda")
    fresh.init_state(small)
    fresh.load(str(tmp_path))
    for k, v in tr.state["params"].items():
        assert torch.equal(fresh.state["params"][k], v), k
