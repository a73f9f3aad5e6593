"""The preemption drain and mid-pass resume on the port (`core/preempt.py`,
`SGDTrainer.train`), mirroring tests/test_cluster.py's preempt tests and
tests/test_faults.py's durable-drain test.

On the CPU:
  * the `preempt` fault site: the flagged dispatch still steps, the next
    boundary writes a CRC-valid mid-pass checkpoint (mid_pass,
    batches_done) and raises Preempted; a fresh trainer with auto_resume
    replays the rest of the pass and ends bitwise equal to an unbroken run
    (parameters, slots, averages, counters), with steps_per_dispatch 1 and 3;
  * a real SIGTERM to a trainer process (this file run as a script): exit
    code EXIT_PREEMPTED, then a resumed process ends bitwise equal to a
    clean one;
  * the drain's checkpoint is durable before Preempted propagates with the
    async writer; past the grace deadline no checkpoint is written; a second
    signal escalates to the previous handler; a resize request reaching the
    port's mesh-less trainer is taken and ignored, as the JAX package's
    trainer without a mesh ignores it (ROADMAP §3 fault 21): both packages
    train on to the same parameters;
  * a mid-pass checkpoint with model averages and the key loads both ways
    between the packages: each package resumes the other's drain and ends
    where its own unbroken run ends (1e-5).

On the card (`cuda`, skipped elsewhere): preempted and resumed training
through the step graph is bitwise equal to an unbroken run."""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import faults, preempt, stats
from paddle_tpu_torch.nn import costs as TC
from paddle_tpu_torch.nn import graph as tgraph
from paddle_tpu_torch.nn import layers as TL
from paddle_tpu_torch.optim import SGD, ModelAverage
from paddle_tpu_torch.trainer import EndIteration, Preempted, SGDTrainer
from paddle_tpu_torch.trainer import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM, CLASSES, BATCH, N = 8, 3, 8, 64


@pytest.fixture(autouse=True)
def _fresh():
    preempt.reset()
    stats.FT_EVENTS._counts.clear()
    yield
    preempt.reset()


def trainer(device="cpu", avg=0.5):
    tgraph.reset_name_scope()
    x = TL.Data("x", shape=(DIM,))
    lbl = TL.Data("label", shape=())
    logits = TL.Fc(TL.Fc(x, 16, act="relu"), CLASSES, act=None)
    return SGDTrainer(TC.ClassificationCost(logits, lbl), SGD(learning_rate=0.1, momentum=0.9),
                      seed=3, device=device, model_average=ModelAverage(avg))


def toy_reader():
    rs = np.random.RandomState(7)
    xs = rs.randn(N, DIM).astype(np.float32)
    ys = (np.arange(N) % CLASSES).astype(np.int32)

    def reader():
        for i in range(0, N, BATCH):
            yield {"x": xs[i:i + BATCH], "label": ys[i:i + BATCH]}

    return reader


def snapshot(tr):
    flat = {f"{name}/{k}": v.detach().cpu().clone() for name, tree in tr._trees().items()
            for k, v in tree.items()}
    for k in ("samples", "lr_scale", "rng", "diverged"):
        flat[k] = tr.state[k].detach().cpu().clone()
    return flat


def assert_bitwise(a, b, what=""):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), f"{what}{k}"


@pytest.mark.parametrize("k", [1, 3])
def test_preempt_fault_drains_midpass_and_resumes_bitwise(tmp_path, k):
    reader = toy_reader()
    clean = trainer()
    clean.train(reader, num_passes=3, steps_per_dispatch=k)
    d = str(tmp_path / "ckpt")
    victim = trainer()
    with faults.inject(f"preempt:step={4 // k}"):
        with pytest.raises(Preempted) as ei:
            victim.train(reader, num_passes=3, save_dir=d, steps_per_dispatch=k)
    done = 5 if k == 1 else 6  # the flagged dispatch finished; the drain is after it
    assert ei.value.pass_id == 0 and ei.value.batches_done == done
    assert ei.value.checkpoint_dir is not None
    man = ckpt.pass_manifest(d, 0)
    assert man["extra"]["mid_pass"] is True and man["extra"]["batches_done"] == done
    assert ckpt.find_latest_valid_pass(d) == 0
    assert stats.FT_EVENTS.get("preempt_drain") == 1
    preempt.reset()
    resumed = trainer()
    resumed.train(reader, num_passes=3, save_dir=d, auto_resume=True, steps_per_dispatch=k)
    assert_bitwise(snapshot(resumed), snapshot(clean))


def test_drain_checkpoint_durable_with_async_writer(tmp_path):
    d = str(tmp_path / "drain")
    with faults.inject("preempt:step=2"):
        tr = trainer()
        with pytest.raises(Preempted) as ei:
            tr.train(toy_reader(), num_passes=3, save_dir=d, async_checkpoint=True)
    assert ckpt.verify_pass(ei.value.checkpoint_dir)
    man = ckpt.pass_manifest(d, ei.value.pass_id)
    assert man["extra"]["mid_pass"] is True
    assert man["extra"]["batches_done"] == ei.value.batches_done == 3


def test_drain_past_the_grace_deadline_writes_no_checkpoint(tmp_path):
    d = str(tmp_path / "late")
    preempt.get().grace_s = -1.0
    with faults.inject("preempt:step=1"):
        tr = trainer()
        with pytest.raises(Preempted) as ei:
            tr.train(toy_reader(), num_passes=1, save_dir=d)
    assert ei.value.checkpoint_dir is None
    assert ckpt.find_latest_valid_pass(d) is None


def test_second_signal_escalates():
    hits = []
    prev = signal.signal(signal.SIGTERM, lambda *a: hits.append(1))
    try:
        guard = preempt.install(grace_s=30.0)
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.requested and hits == []
        os.kill(os.getpid(), signal.SIGTERM)
        assert hits == [1]
    finally:
        preempt.reset()
        signal.signal(signal.SIGTERM, prev)


def test_resize_request_raises_named_error(caplog):
    """No longer raises (fault 21): a pending resize on the mesh-less trainer
    is taken at the next dispatch boundary and ignored with the JAX
    package's warning, and the run equals one without the request."""
    clean = trainer()
    clean.train(toy_reader(), num_passes=1)
    assert preempt.get().request_resize(2)
    tr = trainer()
    with caplog.at_level("WARNING", logger="paddle_tpu_torch.trainer"):
        tr.train(toy_reader(), num_passes=1)
    assert "ignored: this trainer has no DataParallel mesh" in caplog.text
    assert not preempt.resize_requested()
    assert_bitwise(snapshot(tr), snapshot(clean))


def test_resize_on_a_mesh_less_trainer_is_ignored_as_in_jax():
    """The same resize order, parked mid-pass, on a JAX trainer and a port
    trainer with the same parameters: both take it, ignore it and end at
    the same parameters and averages (1e-5)."""
    from paddle_tpu.core import preempt as jpreempt

    from paddle_tpu_torch.nn.convert import params_from_jax

    reader = toy_reader()

    def order(guard):
        def handler(ev):
            if type(ev).__name__ == "EndIteration" and (ev.pass_id, ev.batch_id) == (0, 2):
                assert guard.get().request_resize(4, reason="parity order")
        return handler

    jt = _jax_trainer()
    _jax_init(jt)
    params0 = {k: np.asarray(v) for k, v in jt.state["params"].items()}
    try:
        jt.train(reader, num_passes=2, event_handler=order(jpreempt), log_period=1000)
        assert not jpreempt.resize_requested()
    finally:
        jpreempt.reset()
    tr = trainer()
    tr.init_state(next(reader()))
    tr.load_params(params_from_jax(params0, device="cpu"))
    for k, a in tr.state["avg"]["avg"].items():
        a.copy_(tr.state["params"][k])
    tr.train(reader, num_passes=2, event_handler=order(preempt))
    assert not preempt.resize_requested()
    _close({k: v.numpy() for k, v in tr.state["params"].items()},
           {k: np.asarray(v) for k, v in jt.state["params"].items()}, "params")
    _close({k: v.numpy() for k, v in tr.state["avg"]["avg"].items()},
           {k: np.asarray(v) for k, v in jt.state["avg"]["avg"].items()}, "averages")


def _child(outdir, mode):
    """A trainer process: run (SIGTERM to itself after pass 1 batch 2),
    resume or clean; saves its final parameters."""
    tr = trainer()
    handler = None
    if mode == "run":
        preempt.install(grace_s=30.0)

        def handler(ev):
            if isinstance(ev, EndIteration) and (ev.pass_id, ev.batch_id) == (1, 2):
                os.kill(os.getpid(), signal.SIGTERM)
    try:
        tr.train(toy_reader(), num_passes=3, event_handler=handler,
                 save_dir=None if mode == "clean" else os.path.join(outdir, "ckpt"),
                 auto_resume=mode == "resume")
    except Preempted as p:
        print(f"preempted: {p}", flush=True)
        sys.exit(preempt.EXIT_PREEMPTED)
    np.savez(os.path.join(outdir, f"params_{mode}.npz"),
             **{k: v.numpy() for k, v in snapshot(tr).items()})


def test_sigterm_subprocess_resume_bitwise(tmp_path):
    out = str(tmp_path)

    def run(mode):
        return subprocess.run(
            [sys.executable, os.path.abspath(__file__), "child", out, mode],
            env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, timeout=120)

    r = run("run")
    assert r.returncode == preempt.EXIT_PREEMPTED, r.stdout[-2000:]
    assert ckpt.pass_manifest(os.path.join(out, "ckpt"), 1)["extra"]["batches_done"] == 3
    assert run("resume").returncode == 0
    assert run("clean").returncode == 0
    got = dict(np.load(os.path.join(out, "params_resume.npz")))
    want = dict(np.load(os.path.join(out, "params_clean.npz")))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)


def _jax_trainer():
    from paddle_tpu.nn import costs as JC
    from paddle_tpu.nn import layers as JL
    from paddle_tpu.nn.graph import reset_name_scope
    from paddle_tpu.optim import SGD as JaxSGD
    from paddle_tpu.optim import ModelAverage as JaxAverage
    from paddle_tpu.trainer import SGDTrainer as JaxTrainer

    reset_name_scope()
    x = JL.Data("x", shape=(DIM,))
    lbl = JL.Data("label", shape=())
    cost = JC.ClassificationCost(JL.Fc(JL.Fc(x, 16, act="relu"), CLASSES, act=None), lbl)
    return JaxTrainer(cost, JaxSGD(learning_rate=0.1, momentum=0.9), seed=3,
                      model_average=JaxAverage(0.5))


def _jax_init(jt, params0=None):
    """init_state, with the averages in buffers of their own (the reference's
    f32 astype aliases the parameters, which its donating step rejects)."""
    import jax.numpy as jnp

    jt.init_state(next(toy_reader()()))
    if params0 is not None:
        jt.state["params"] = {k: jnp.asarray(v) for k, v in params0.items()}
    jt.state["avg"]["avg"] = {k: jnp.array(v, copy=True) for k, v in jt.state["params"].items()}


def _close(got, want, what):
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6, err_msg=f"{what} {k}")


def test_midpass_checkpoint_loads_both_ways(tmp_path):
    from paddle_tpu.core import faults as jfaults
    from paddle_tpu.core import preempt as jpreempt
    from paddle_tpu.trainer import Preempted as JaxPreempted

    from paddle_tpu_torch.nn.convert import params_from_jax

    reader = toy_reader()
    jt = _jax_trainer()
    _jax_init(jt)
    params0 = {k: np.asarray(v) for k, v in jt.state["params"].items()}

    def port_from_jax_init():
        tr = trainer()
        tr.init_state(next(reader()))
        tr.load_params(params_from_jax(params0, device="cpu"))
        for k, a in tr.state["avg"]["avg"].items():
            a.copy_(tr.state["params"][k])
        return tr

    # the JAX package drains, the port resumes
    jdir = str(tmp_path / "jax")
    try:
        with jfaults.inject("preempt:step=4"):
            with pytest.raises(JaxPreempted):
                jt.train(reader, num_passes=2, save_dir=jdir, log_period=1000)
    finally:
        jpreempt.reset()
    port_resumed = port_from_jax_init()
    port_resumed.train(reader, num_passes=2, save_dir=jdir, auto_resume=True)
    port_clean = port_from_jax_init()
    port_clean.train(reader, num_passes=2)
    _close(snapshot(port_resumed), {k: v.numpy() for k, v in snapshot(port_clean).items()},
           "port resuming the JAX drain")
    # the port drains, the JAX package resumes
    pdir = str(tmp_path / "port")
    with faults.inject("preempt:step=4"):
        with pytest.raises(Preempted):
            port_from_jax_init().train(reader, num_passes=2, save_dir=pdir)
    man = ckpt.pass_manifest(pdir, 0)
    assert man["extra"]["mid_pass"] and man["extra"]["batches_done"] == 5
    assert len(man["extra"]["rng"]) == 2
    jr = _jax_trainer()
    _jax_init(jr, params0)
    jr.train(reader, num_passes=2, save_dir=pdir, auto_resume=True, log_period=1000)
    jc = _jax_trainer()
    _jax_init(jc, params0)
    jc.train(reader, num_passes=2, log_period=1000)
    for tree in ("params",):
        _close({k: np.asarray(v) for k, v in jr.state[tree].items()},
               {k: np.asarray(v) for k, v in jc.state[tree].items()}, "JAX resuming the port")
    _close({k: np.asarray(v) for k, v in jr.state["avg"]["avg"].items()},
           {k: np.asarray(v) for k, v in jc.state["avg"]["avg"].items()}, "averages")
    assert int(jr.state["samples"]) == int(jc.state["samples"]) == 2 * N


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_preempted_graph_run_resumes_bitwise(cuda, tmp_path):
    reader = toy_reader()
    clean = trainer(cuda)
    clean.train(reader, num_passes=2)
    d = str(tmp_path / "g")
    with faults.inject("preempt:step=5"):
        with pytest.raises(Preempted):
            trainer(cuda).train(reader, num_passes=2, save_dir=d)
    preempt.reset()
    resumed = trainer(cuda)
    resumed.train(reader, num_passes=2, save_dir=d, auto_resume=True)
    assert next(iter(resumed.graphs.values())).replays > 0
    assert_bitwise(snapshot(resumed), snapshot(clean))


if __name__ == "__main__" and sys.argv[1:2] == ["child"]:
    _child(sys.argv[2], sys.argv[3])
