"""The port's SGDTrainer and optimizers against the JAX package's, on the CPU.

  * 3 steps of SGD(momentum=0.9) on the same batches from the same
    parameters: per-step costs within rtol 1e-5, every parameter within
    atol 1e-5 afterwards.
  * 3 steps of Adam: per-step costs within rtol 1e-4. Adam's first step
    divides near-zero gradients by their own size, so a last-ulp difference
    in a gradient can move a parameter by ~lr; parameters are compared
    under SGD only.
  * `Adam.update_one` on given gradients equals the JAX package's (1e-6).
  * `train()` + `test()` learn a small copy task on the CPU; the cost falls.
  * Device policy: without `device=` the trainer runs on CUDA and raises
    when CUDA is absent."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import Seq2SeqModel as TorchSeq2Seq
from paddle_tpu_torch.nn import graph as tgraph
from paddle_tpu_torch.nn.convert import params_from_jax
from paddle_tpu_torch.optim import SGD, Adam
from paddle_tpu_torch.trainer import SGDTrainer
from paddle_tpu_torch.trainer.events import EndIteration, EndPass

VOCAB, EMBED, HIDDEN = 40, 16, 24


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


def run_both(jax_opt, port_opt, batches, monkeypatch):
    """Same params and batches through both trainers -> (jax costs, port
    costs, jax params, port params)."""
    import jax

    from paddle_tpu.models import Seq2SeqModel
    from paddle_tpu.nn.graph import reset_name_scope
    from paddle_tpu.trainer import SGDTrainer as JaxTrainer

    monkeypatch.setenv("PADDLE_TPU_PALLAS", "0")
    reset_name_scope()
    jm = Seq2SeqModel(VOCAB, VOCAB, embed_dim=EMBED, hidden_dim=HIDDEN)
    jt = JaxTrainer(jm.cost, jax_opt, seed=0)
    jt.init_state(batches[0])
    params0 = {k: np.asarray(v) for k, v in jt.state["params"].items()}
    step = jt._make_step()
    jax_costs = []
    for b in batches:
        jt.state, cost, _ = step(jt.state, b)
        jax_costs.append(float(cost))

    tgraph.reset_name_scope()
    pm = TorchSeq2Seq(VOCAB, VOCAB, embed_dim=EMBED, hidden_dim=HIDDEN)
    pt = SGDTrainer(pm.cost, port_opt, seed=0, device="cpu")
    pt.init_state(batches[0])
    pt.load_params(params_from_jax(params0, device="cpu"))
    port_costs = [float(pt.step(b)) for b in batches]
    jax_params = {k: np.asarray(v) for k, v in jax.device_get(jt.state["params"]).items()}
    assert pt.state["samples"] == sum(len(b["source_ids"]) for b in batches)
    return jax_costs, port_costs, jax_params, pt.state["params"]


def test_sgd_momentum_steps_match_jax(monkeypatch):
    from paddle_tpu.optim import SGD as JaxSGD

    batches = [make_batch(s) for s in range(3)]
    jc, pc, jp, pp = run_both(JaxSGD(learning_rate=0.5, momentum=0.9),
                              SGD(learning_rate=0.5, momentum=0.9), batches,
                              monkeypatch)
    np.testing.assert_allclose(pc, jc, rtol=1e-5)
    assert jc[2] != jc[0]  # the parameters moved
    for k, v in jp.items():
        np.testing.assert_allclose(pp[k].numpy(), v, rtol=0, atol=1e-5, err_msg=k)


def test_adam_step_costs_match_jax(monkeypatch):
    from paddle_tpu.optim import Adam as JaxAdam

    batches = [make_batch(s) for s in (3, 4, 5)]
    jc, pc, _, _ = run_both(JaxAdam(learning_rate=1e-2), Adam(learning_rate=1e-2),
                            batches, monkeypatch)
    np.testing.assert_allclose(pc, jc, rtol=1e-4)


def test_adam_update_one_matches_jax():
    import jax.numpy as jnp

    from paddle_tpu.optim import Adam as JaxAdam

    rs = np.random.RandomState(0)
    p, g, m, v = (rs.randn(5, 7).astype(np.float32) for _ in range(4))
    v = np.abs(v)
    ja = JaxAdam(learning_rate=1e-3)
    ja._t = jnp.asarray(3, jnp.int32)
    jp, (jm, jv) = ja.update_one("w", jnp.asarray(g), (jnp.asarray(m), jnp.asarray(v)),
                                 jnp.asarray(p), jnp.asarray(1e-3, jnp.float32))
    ta = Adam(learning_rate=1e-3)
    tp, (tm, tv) = ta.update_one("w", torch.from_numpy(g),
                                 (torch.from_numpy(m), torch.from_numpy(v)),
                                 torch.from_numpy(p), 1e-3, 3)
    for a, b in ((tp, jp), (tm, jm), (tv, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_update_one_param_attr_semantics():
    """static params do not move; clipping, L2 and the lr scale apply."""
    from paddle_tpu_torch.nn.graph import ParamAttr

    opt = SGD(learning_rate=1.0)
    opt.param_attrs = {
        "s": ParamAttr(is_static=True),
        "c": ParamAttr(gradient_clipping_threshold=0.5, learning_rate=0.1, l2_decay=1.0),
    }
    p = torch.tensor([1.0, -2.0])
    g = torch.tensor([3.0, -0.2])
    assert opt.update_one("s", g, (), p, 1.0, 1)[0] is p
    got, _ = opt.update_one("c", g, (), p, 1.0, 1)
    # clip -> [0.5, -0.2], + l2 * p -> [1.5, -2.2], step 0.1
    torch.testing.assert_close(got, torch.tensor([0.85, -1.78]))


def test_train_and_test_learn_a_copy_task():
    vocab = 12  # 0 = BOS, 1 = EOS, 2..11 payload
    rs = np.random.RandomState(1)
    batches = []
    for _ in range(5):
        n = rs.randint(2, 5, 32)
        src = np.zeros((32, 8), np.int32)
        trg = np.zeros((32, 8), np.int32)
        lab = np.zeros((32, 8), np.int32)
        for i, k in enumerate(n):
            toks = rs.randint(2, vocab, k)
            src[i, :k] = toks
            trg[i, 1:k + 1] = toks
            lab[i, :k] = toks
            lab[i, k] = 1
        batches.append({"source_ids": src, "source_ids.lengths": n.astype(np.int32),
                        "target_ids": trg, "target_ids.lengths": (n + 1).astype(np.int32),
                        "label_ids": lab, "label_ids.lengths": (n + 1).astype(np.int32)})

    tgraph.reset_name_scope()
    model = TorchSeq2Seq(vocab, vocab, embed_dim=24, hidden_dim=32)
    trainer = SGDTrainer(model.cost, Adam(learning_rate=0.01), seed=0, device="cpu")
    events = []
    trainer.train(lambda: iter(batches), num_passes=25, event_handler=events.append)
    passes = [e.metrics for e in events if isinstance(e, EndPass)]
    iters = [e for e in events if isinstance(e, EndIteration)]
    assert len(passes) == 25 and len(iters) == 125
    assert all(p["batches"] == 5 for p in passes)
    first = passes[0]["avg_cost"]
    res = trainer.test(lambda: iter(batches))
    assert res["samples"] == 160
    assert np.isfinite(iters[-1].cost)
    assert res["cost"] < 0.3 * first, (first, res)


def test_trainer_without_device_raises_when_cuda_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tgraph.reset_name_scope()
    model = TorchSeq2Seq(VOCAB, VOCAB, embed_dim=EMBED, hidden_dim=HIDDEN)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SGDTrainer(model.cost, Adam(learning_rate=1e-3))
    with pytest.raises(RuntimeError, match="is_available"):
        SGDTrainer(model.cost, Adam(learning_rate=1e-3), device="cuda")
