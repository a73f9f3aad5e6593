"""The divergence guard (`SGDTrainer(divergence_policy=, guard_check_every=)`),
mirroring tests/test_faults.py's guard tests and tests/test_dispatch.py's
device-resident window, on the port.

On the CPU:
  * without a policy one NaN batch (the `nan_loss` fault) poisons every
    parameter; with `skip_batch` the state after the run is bitwise the
    state of a run that never saw that batch (parameters, slots, `t`,
    samples), the pass metrics count the event and average only finite
    costs, and the result matches the JAX package's guarded run;
  * `rollback` restores the newest checkpoint and halves `lr_scale` (and
    persists it), or without a checkpoint falls back to skipping;
  * `raise` raises DivergenceError naming the batch, with the state intact;
  * the host reads `diverged` only at polls: every guard_check_every steps
    and at pass end; a NaN inside a K-step dispatch reverts all K steps;
    with guard_check_every=1 a poisoned step fires no EndIteration.

On the card (`cuda`, skipped elsewhere): a poisoned replay of the step
graph leaves the state bitwise as a graph run without that batch."""

import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import faults, stats
from paddle_tpu_torch.nn import costs as TC
from paddle_tpu_torch.nn import graph as tgraph
from paddle_tpu_torch.nn import layers as TL
from paddle_tpu_torch.optim import SGD
from paddle_tpu_torch.trainer import DivergenceError, EndIteration, SGDTrainer
from paddle_tpu_torch.trainer import checkpoint as ckpt

DIM, CLASSES = 4, 3


@pytest.fixture(autouse=True)
def _fresh():
    stats.FT_EVENTS._counts.clear()
    yield


def trainer(policy=None, guard_every=16, lr=0.2, seed=11, device="cpu"):
    tgraph.reset_name_scope()
    x = TL.Data("x", shape=(DIM,))
    lbl = TL.Data("label", shape=())
    logits = TL.Fc(TL.Fc(x, 16, act="relu"), CLASSES, act=None)
    cost = TC.ClassificationCost(logits, lbl)
    return SGDTrainer(cost, SGD(learning_rate=lr, momentum=0.9), seed=seed, device=device,
                      divergence_policy=policy, guard_check_every=guard_every)


def dict_batches(n, bs=8, seed=0):
    rs = np.random.RandomState(seed)
    return [{"x": rs.randn(bs, DIM).astype(np.float32),
             "label": rs.randint(0, CLASSES, bs).astype(np.int64)} for _ in range(n)]


def snapshot(tr):
    flat = {f"{name}/{k}": v.detach().clone() for name, tree in tr._trees().items()
            for k, v in tree.items()}
    flat["samples"] = tr.state["samples"].clone()
    return flat


def assert_bitwise(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k].cpu(), b[k].cpu()), k


def finite(tr):
    return all(bool(torch.isfinite(v).all()) for v in tr.state["params"].values())


def metrics_of(passes):
    """An event handler keeping EndPass metrics (of either package)."""
    return lambda e: passes.append(e.metrics) if type(e).__name__ == "EndPass" else None


def test_nan_without_guard_poisons_params():
    with faults.inject("nan_loss:step=1"):
        tr = trainer(policy=None)
        tr.train(lambda: iter(dict_batches(2)), num_passes=1)
    assert not finite(tr)


def test_skip_batch_is_bitwise_a_run_without_the_batch():
    batches = dict_batches(4)
    passes = []
    with faults.inject("nan_loss:step=1") as inj:
        guarded = trainer(policy="skip_batch", guard_every=2)
        guarded.train(lambda: iter(batches), num_passes=1, event_handler=metrics_of(passes))
        assert inj.fired["nan_loss"] == 1
    clean = trainer(policy=None)
    clean.train(lambda: iter([batches[0]] + batches[2:]), num_passes=1)
    assert_bitwise(snapshot(guarded), snapshot(clean))
    assert passes[0]["divergence_events"] == 1 and passes[0]["batches"] == 3
    assert np.isfinite(passes[0]["avg_cost"])
    assert stats.FT_EVENTS.get("divergence") == 1
    assert int(guarded.state["diverged"]) == 1


def test_skip_batch_matches_the_jax_packages_guarded_run():
    from paddle_tpu.core import faults as jfaults
    from paddle_tpu.nn import costs as JC
    from paddle_tpu.nn import layers as JL
    from paddle_tpu.nn.graph import reset_name_scope
    from paddle_tpu.optim import SGD as JaxSGD
    from paddle_tpu.trainer import SGDTrainer as JaxTrainer

    from paddle_tpu_torch.nn.convert import params_from_jax

    batches = dict_batches(5, seed=3)
    reset_name_scope()
    x = JL.Data("x", shape=(DIM,))
    lbl = JL.Data("label", shape=())
    cost = JC.ClassificationCost(JL.Fc(JL.Fc(x, 16, act="relu"), CLASSES, act=None), lbl)
    jt = JaxTrainer(cost, JaxSGD(learning_rate=0.2, momentum=0.9), seed=11,
                    divergence_policy="skip_batch", guard_check_every=3)
    jt.init_state(batches[0])
    p0 = {k: np.asarray(v) for k, v in jt.state["params"].items()}
    jpasses, tpasses = [], []
    with jfaults.inject("nan_loss:step=2"):
        jt.train(lambda: iter(batches), num_passes=1, event_handler=metrics_of(jpasses))
    tr = trainer(policy="skip_batch", guard_every=3)
    tr.init_state(batches[0])
    tr.load_params(params_from_jax(p0, device="cpu"))
    with faults.inject("nan_loss:step=2"):
        tr.train(lambda: iter(batches), num_passes=1, event_handler=metrics_of(tpasses))
    for k, v in jt.state["params"].items():
        np.testing.assert_allclose(tr.state["params"][k].numpy(), np.asarray(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for key in ("divergence_events", "batches"):
        assert tpasses[0][key] == jpasses[0][key]
    assert tpasses[0]["avg_cost"] == pytest.approx(jpasses[0]["avg_cost"], rel=1e-5)
    assert int(tr.state["samples"]) == int(jt.state["samples"]) == 4 * 8


def test_rollback_restores_and_halves_lr_scale(tmp_path):
    d = str(tmp_path / "roll")
    batches = dict_batches(2)
    # NaN at dispatch 4 = pass 2 batch 0; passes 0 and 1 are checkpointed
    with faults.inject("nan_loss:step=4"):
        tr = trainer(policy="rollback")
        tr.train(lambda: iter(batches), num_passes=3, save_dir=d)
    assert float(tr.state["lr_scale"]) == 0.5
    assert finite(tr)
    assert stats.FT_EVENTS.get("divergence_rollback") == 1
    assert int(tr.state["diverged"]) == 1
    _, _, _, manifest = ckpt.load_pass(d)
    assert manifest["extra"]["lr_scale"] == 0.5


def test_rollback_lands_on_the_checkpoint(tmp_path):
    """guard_check_every=1: the poll right after the poisoned step (pass 1
    batch 0) reloads pass 0's checkpoint and halves the lr; batch 1 then
    steps from there. Bitwise the run that trained pass 0, halved the lr
    and stepped batch 1."""
    d = str(tmp_path / "roll1")
    batches = dict_batches(2)
    ref = trainer()
    ref.train(lambda: iter(batches), num_passes=1)
    ref.set_lr_scale(0.5)
    ref.step(batches[1])
    with faults.inject("nan_loss:step=2"):
        tr = trainer(policy="rollback", guard_every=1)
        tr.train(lambda: iter(batches), num_passes=2, save_dir=d, async_checkpoint=False)
    assert_bitwise(snapshot(tr), snapshot(ref))
    assert float(tr.state["lr_scale"]) == 0.5 and int(tr.state["samples"]) == 3 * 8


def test_rollback_without_checkpoint_degrades_to_skip(caplog):
    with faults.inject("nan_loss:step=0"):
        tr = trainer(policy="rollback")
        with caplog.at_level("WARNING", logger="paddle_tpu_torch.trainer"):
            tr.train(lambda: iter(dict_batches(2)), num_passes=1)
    assert any("falling back" in r.message for r in caplog.records)
    assert float(tr.state["lr_scale"]) == 1.0
    assert finite(tr)


def test_raise_is_loud_and_state_safe():
    batches = dict_batches(2)
    with faults.inject("nan_loss:step=1"):
        tr = trainer(policy="raise")
        with pytest.raises(DivergenceError, match="non-finite cost.*pass 0 batch 1"):
            tr.train(lambda: iter(batches), num_passes=1)
    assert finite(tr)
    clean = trainer()
    clean.train(lambda: iter(batches[:1]), num_passes=1)
    assert_bitwise(snapshot(tr), snapshot(clean))


def test_bad_policy_and_window_rejected():
    with pytest.raises(ValueError, match="divergence_policy"):
        trainer(policy="explode")
    with pytest.raises(ValueError, match="guard_check_every"):
        trainer(policy="skip_batch", guard_every=0)


def test_guard_window_reacts_within_bound(caplog):
    passes = []
    with faults.inject("nan_loss:step=1") as inj:
        tr = trainer(policy="skip_batch", guard_every=4)
        with caplog.at_level("WARNING", logger="paddle_tpu_torch.trainer"):
            tr.train(lambda: iter(dict_batches(8)), num_passes=1,
                     event_handler=metrics_of(passes))
        assert inj.fired["nan_loss"] == 1
    assert finite(tr)
    assert passes[0]["divergence_events"] == 1 and passes[0]["batches"] == 7
    assert np.isfinite(passes[0]["avg_cost"])
    msgs = [r.message for r in caplog.records if "divergence guard" in r.message]
    assert any("batch 3" in m for m in msgs), msgs


def test_guard_check_every_one_names_the_batch():
    with faults.inject("nan_loss:step=2"):
        tr = trainer(policy="raise", guard_every=1)
        with pytest.raises(DivergenceError, match="pass 0 batch 2"):
            tr.train(lambda: iter(dict_batches(6)), num_passes=1)
    assert finite(tr)


def test_guard_window_covers_fused_dispatch():
    passes = []
    with faults.inject("nan_loss:step=1"):  # the second dispatch
        tr = trainer(policy="skip_batch", guard_every=16)
        tr.train(lambda: iter(dict_batches(8)), num_passes=1, steps_per_dispatch=4,
                 event_handler=metrics_of(passes))
    assert finite(tr)
    assert passes[0]["divergence_events"] == 4 and passes[0]["batches"] == 4
    assert np.isfinite(passes[0]["avg_cost"])
    assert int(tr.state["samples"]) == 4 * 8


def test_guard_every_one_suppresses_the_poisoned_event():
    ends1, ends4 = [], []
    with faults.inject("nan_loss:step=1"):
        tr = trainer(policy="skip_batch", guard_every=1)
        tr.train(lambda: iter(dict_batches(4)), num_passes=1,
                 event_handler=lambda e: ends1.append(e.batch_id)
                 if isinstance(e, EndIteration) else None)
    assert ends1 == [0, 2, 3]
    with faults.inject("nan_loss:step=1"):
        tr = trainer(policy="skip_batch", guard_every=4)
        tr.train(lambda: iter(dict_batches(4)), num_passes=1,
                 event_handler=lambda e: ends4.append(e)
                 if isinstance(e, EndIteration) else None)
    assert [e.batch_id for e in ends4] == [0, 1, 2, 3]
    assert not np.isfinite(ends4[1].cost)


def test_host_reads_diverged_only_at_polls(monkeypatch):
    polls = []
    tr = trainer(policy="skip_batch", guard_every=4)
    real = tr._poll_guard
    monkeypatch.setattr(tr, "_poll_guard", lambda *a, **k: polls.append(a[1]) or real(*a, **k))
    with faults.inject("nan_loss:step=0"):
        tr.train(lambda: iter(dict_batches(10)), num_passes=1)
    assert polls == [3, 7, 9]  # every 4 steps, then the pass end
    assert int(tr.state["diverged"]) == 1 and tr._diverged_seen == 1


def test_diverged_round_trips_a_checkpoint_and_the_jax_load(tmp_path):
    from paddle_tpu.nn import costs as JC
    from paddle_tpu.nn import layers as JL
    from paddle_tpu.nn.graph import reset_name_scope
    from paddle_tpu.optim import SGD as JaxSGD
    from paddle_tpu.trainer import SGDTrainer as JaxTrainer

    d = str(tmp_path / "c")
    with faults.inject("nan_loss:step=1"):
        tr = trainer(policy="skip_batch")
        tr.train(lambda: iter(dict_batches(3)), num_passes=1, save_dir=d,
                 async_checkpoint=False)
    again = trainer(policy="skip_batch")
    again.init_state(dict_batches(1)[0])
    again.load(d)
    assert int(again.state["diverged"]) == again._diverged_seen == 1
    assert_bitwise(snapshot(again), snapshot(tr))
    reset_name_scope()
    x = JL.Data("x", shape=(DIM,))
    lbl = JL.Data("label", shape=())
    cost = JC.ClassificationCost(JL.Fc(JL.Fc(x, 16, act="relu"), CLASSES, act=None), lbl)
    jt = JaxTrainer(cost, JaxSGD(learning_rate=0.2, momentum=0.9), seed=11,
                    divergence_policy="skip_batch")
    jt.init_state(dict_batches(1)[0])
    jt.load(d)
    assert int(jt.state["samples"]) == 2 * 8
    for k, v in tr.state["params"].items():
        assert np.array_equal(np.asarray(jt.state["params"][k]), v.numpy()), k


def test_nan_loss_poisons_an_id_only_batch_through_the_embedding():
    """A seq2seq batch holds ids only: the fault sets its first id slot past
    the vocabulary, the embedding reads NaN rows, and skip_batch leaves the
    state bitwise that of a run without the batch."""
    from paddle_tpu_torch.models import Seq2SeqModel
    from paddle_tpu_torch.optim import Adam

    def s2s(seed):
        rs = np.random.RandomState(seed)
        ids = lambda t: rs.randint(2, 24, (4, t)).astype(np.int32)  # noqa: E731
        return {"source_ids": ids(7), "source_ids.lengths": np.full(4, 7, np.int32),
                "target_ids": ids(6), "target_ids.lengths": np.full(4, 6, np.int32),
                "label_ids": ids(6), "label_ids.lengths": np.full(4, 6, np.int32)}

    def run(batches, spec=None):
        tgraph.reset_name_scope()
        m = Seq2SeqModel(24, 24, embed_dim=8, hidden_dim=8)
        tr = SGDTrainer(m.cost, Adam(learning_rate=1e-2), device="cpu",
                        divergence_policy="skip_batch")
        if spec is None:
            tr.train(lambda: iter(batches))
        else:
            with faults.inject(spec):
                tr.train(lambda: iter(batches))
        return tr

    data = [s2s(s) for s in range(3)]
    guarded, clean = run(data, "nan_loss:step=1"), run([data[0], data[2]])
    assert int(guarded.state["diverged"]) == 1
    assert_bitwise(snapshot(guarded), snapshot(clean))


def extras_trainer(device="cpu"):
    tgraph.reset_name_scope()
    x = TL.Data("x", shape=(DIM,))
    lbl = TL.Data("label", shape=())
    logits = TL.Fc(TL.Fc(x, 16, act="relu"), CLASSES, act=None, name="logits")
    return SGDTrainer(TC.ClassificationCost(logits, lbl), SGD(learning_rate=0.2), seed=11,
                      device=device, extra_outputs=[logits])


def test_extra_outputs_reach_end_iteration_metrics():
    """extra_outputs= (the JAX trainer's): each EndIteration's lazy metrics
    hold the layer's value of that step, at the parameters before it."""
    batches = dict_batches(3)
    tr = extras_trainer()
    tr.init_state(batches[0])
    want = []
    for b in batches:
        outs = tr.network.apply(tr.state["params"], b, train=True)
        want.append(outs["logits"].value.detach().clone())
        tr.step(b)
    got = []
    tr2 = extras_trainer()
    tr2.train(lambda: iter(batches), num_passes=1,
              event_handler=lambda e: got.append(e.metrics) if isinstance(e, EndIteration)
              else None)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert set(g) == {"logits"}
        np.testing.assert_array_equal(g["logits"], w.numpy())


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_poisoned_replay_reverts_bitwise(cuda):
    batches = dict_batches(5)
    with faults.inject("nan_loss:step=3"):
        guarded = trainer(policy="skip_batch", guard_every=2, device=cuda)
        guarded.train(lambda: iter(batches), num_passes=1)
    clean = trainer(policy="skip_batch", guard_every=2, device=cuda)
    clean.train(lambda: iter(batches[:3] + batches[4:]), num_passes=1)
    assert next(iter(guarded.graphs.values())).replays == 4
    assert int(guarded.state["diverged"]) == 1
    a, b = snapshot(guarded), snapshot(clean)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert os.environ.get("PADDLE_TPU_FAULTS", "") == ""


@pytest.mark.cuda
def test_cuda_extras_survive_the_next_replay(cuda):
    batches = dict_batches(4)
    got, want = [], []
    tr = extras_trainer(cuda)
    tr.train(lambda: iter(batches), num_passes=1,
             event_handler=lambda e: got.append(e) if isinstance(e, EndIteration) else None)
    ref = extras_trainer("cpu")
    ref.train(lambda: iter(batches), num_passes=1,
              event_handler=lambda e: want.append(e) if isinstance(e, EndIteration) else None)
    assert next(iter(tr.graphs.values())).replays == 3
    for g, w in zip(got, want):  # read only now, after every replay ran
        np.testing.assert_allclose(g.metrics["logits"], w.metrics["logits"], rtol=1e-5,
                                   atol=1e-6)
