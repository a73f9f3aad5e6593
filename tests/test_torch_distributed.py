"""Multi-process data parallelism on the port (`parallel/distributed.py`,
the CLI's `--trainer_count`) — the counterpart of `tests/test_distributed.py`
and of the JAX CLI's `--trainer_count`.

  * `barrier` returns once every rank arrived; its timeout names the ranks
    that never did.
  * `python -m paddle_tpu_torch train --trainer_count=2 --device=cpu` starts
    two rank processes over gloo; from the JAX package's initial parameters
    its pass costs and evaluator equal the JAX CLI's `--trainer_count=2`
    (two forced CPU devices) within rtol 1e-5 (sums in another order), and
    only rank 0 prints. More ranks than visible GPUs raise, naming both
    counts.
  * The two-process cluster of `tests/test_distributed.py`: two rank
    processes (this file run as a script) pull recordio tasks from one
    `MasterServer` across the process boundary, exactly once, then train
    data-parallel over gloo; both end with identical parameters, equal
    within rtol 2e-4 / atol 2e-5 to a single-process run over the same
    global batches (the JAX test's bound)."""

from __future__ import annotations

import json
import os
import pickle
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- barrier -----------------------------------------------------------------


def test_barrier_and_its_timeout():
    from torch.distributed import HashStore

    from paddle_tpu_torch.parallel import distributed

    store = HashStore()
    done, errors = [], []

    def rank(r, n, arrive=True, timeout=10.0):
        try:
            if arrive:
                distributed.barrier("t", timeout_s=timeout, _store_override=store,
                                    _rank=r, _world=n)
                done.append(r)
        except distributed.BarrierTimeout as e:
            errors.append(str(e))

    ts = [threading.Thread(target=rank, args=(r, 3)) for r in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert sorted(done) == [0, 1, 2] and not errors
    # rank 2 never comes: ranks 0 and 1 time out, naming it
    t0 = time.monotonic()
    ts = [threading.Thread(target=rank, args=(r, 3, r != 2, 0.3)) for r in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert time.monotonic() - t0 < 10
    assert len(errors) == 2
    for msg in errors:
        assert "waiting for process(es) [2]" in msg and "of 3" in msg
    distributed.barrier("one process: no-op")  # no store, one rank


# -- the CLI's --trainer_count ------------------------------------------------


@pytest.fixture(scope="module")
def conf_dir(tmp_path_factory):
    from test_torch_cli_train import CONF, PROVIDER

    d = tmp_path_factory.mktemp("dp_conf")
    (d / "bigru_provider.py").write_text(PROVIDER)
    (d / "conf.py").write_text(CONF)
    (d / "train.list").write_text("dummy\n")
    (d / "test.list").write_text("dummy\n")
    return d


def _pass_lines(text):
    return [dict(re.findall(r"(\w+)=([-\d.e]+)", line))
            for line in text.splitlines() if line.startswith("pass ")]


def test_cli_trainer_count_2_matches_the_jax_cli(conf_dir, monkeypatch, capsys):
    from paddle_tpu import cli as jcli
    from paddle_tpu.config import build_optimizer as jbuild
    from paddle_tpu.config import parse_config as jparse
    from paddle_tpu.trainer.trainer import SGDTrainer as JaxTrainer

    monkeypatch.chdir(conf_dir)
    monkeypatch.syspath_prepend(str(conf_dir))
    # both CLIs start from the JAX package's initial parameters
    init_dir = conf_dir / "init"
    jpc = jparse(str(conf_dir / "conf.py"), emit_proto=False)
    jb = jbuild(jpc.trainer_config.opt_config)
    jt = JaxTrainer(jpc.outputs, jb.optimizer, schedule=jb.schedule,
                    model_average=jb.model_average)
    from paddle_tpu_torch import cli

    job = cli.prepare_train(cli.parse_args(["train", "--device=cpu", "--config=conf.py"]))
    jt.init_state(job.feeder(next(iter(job.reader()))))
    jt.save(str(init_dir), 0)

    common = ["train", "--config=conf.py", "--num_passes=2", "--log_period=1",
              f"--init_model_path={init_dir}", "--trainer_count=2"]
    env = {**os.environ, "PYTHONPATH": f"{REPO}:{conf_dir}"}
    r = subprocess.run([sys.executable, "-m", "paddle_tpu_torch", *common, "--device=cpu",
                        f"--save_dir={conf_dir / 'out'}"],
                       cwd=conf_dir, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    port = _pass_lines(r.stdout)
    assert [p["avg_cost"] is not None for p in port] == [True, True]  # rank 0 only
    assert (conf_dir / "out" / "pass-00001").is_dir()

    capsys.readouterr()
    assert jcli.main(common) == 0
    ref = _pass_lines(capsys.readouterr().out)
    assert len(ref) == len(port) == 2
    for p, j in zip(port, ref):
        for key in ("avg_cost", "test_cost"):
            assert float(p[key]) == pytest.approx(float(j[key]), rel=1e-5), key
        assert float(p["ClassificationErrorEvaluator"]) == \
            float(j["ClassificationErrorEvaluator"])


def test_trainer_count_beyond_the_visible_gpus_raises(conf_dir, monkeypatch):
    from paddle_tpu_torch import cli, device

    monkeypatch.chdir(conf_dir)
    monkeypatch.setattr(device, "resolve_device", lambda d=None: __import__("torch").device(
        "cuda", 0))
    monkeypatch.setattr(cli, "torch_cuda_device_count", lambda: 1)
    with pytest.raises(RuntimeError, match=r"--trainer_count=3 needs 3 GPUs.*1 are visible"):
        cli.main(["train", "--config=conf.py", "--trainer_count=3"])


# -- the two-process cluster ----------------------------------------------------

DIM, CLASSES, BATCH_LOCAL = 16, 4, 8


def _cluster_data():
    rs = np.random.RandomState(0)
    xs = rs.randn(96, DIM).astype(np.float32)
    ys = (rs.rand(96) * CLASSES).astype(np.int32)
    return xs, ys


def _cluster_net():
    from paddle_tpu_torch.nn import costs as C
    from paddle_tpu_torch.nn import layers as L

    x = L.Data("x", shape=(DIM,))
    lbl = L.Data("label", shape=())
    h = L.Fc(x, 32, act="relu", name="h")
    logits = L.Fc(h, CLASSES, act=None, name="out")
    return C.ClassificationCost(logits, lbl, name="cost")


def _global_batches(xs, ys):
    """Step j's global batch: host 0's rows (even ids), then host 1's (odd
    ids), as the JAX test's two processes feed their halves."""
    for j in range(96 // (2 * BATCH_LOCAL)):
        idx = ([16 * j + 2 * t for t in range(BATCH_LOCAL)]
               + [16 * j + 2 * t + 1 for t in range(BATCH_LOCAL)])
        yield {"x": xs[idx], "label": ys[idx]}


def _worker(pid: int, nprocs: int, coord: str, master_port: int, outdir: str) -> None:
    from paddle_tpu_torch.optim.optimizers import SGD
    from paddle_tpu_torch.parallel import DataParallel, distributed, make_mesh
    from paddle_tpu_torch.runtime.master import MasterServer, TaskMaster, cluster_reader
    from paddle_tpu_torch.trainer.trainer import SGDTrainer

    distributed.initialize(coord, nprocs, pid, backend="gloo")
    assert distributed.process_count() == nprocs and distributed.process_index() == pid
    shards = sorted(os.path.join(outdir, f) for f in os.listdir(outdir)
                    if f.endswith(".recordio"))
    server = None
    if pid == 0:
        master = TaskMaster(timeout_s=30.0, failure_max=3)
        master.set_dataset(shards, chunks_per_task=1)
        server = MasterServer(master, port=master_port).start()
    distributed.barrier("master up")
    consumed = []
    for s in cluster_reader(("127.0.0.1", master_port), pickle.loads)():
        consumed.append(s["sid"])
        time.sleep(0.05)  # both hosts pull while the other does
    with open(os.path.join(outdir, f"consumed_{pid}.json"), "w") as f:
        json.dump(sorted(consumed), f)

    xs, ys = _cluster_data()
    dp = DataParallel(make_mesh({"data": nprocs}, device="cpu"))
    tr = SGDTrainer(_cluster_net(), SGD(learning_rate=0.1), seed=11, device="cpu",
                    parallel=dp)
    for batch in _global_batches(xs, ys):
        if tr.state is None:
            tr.init_state(batch)
        tr.step(batch)
    distributed.barrier("trained")
    np.savez(os.path.join(outdir, f"params_{pid}.npz"),
             **{k: v.numpy() for k, v in tr.state["params"].items()})
    if server is not None:
        server.stop()
    print(f"worker {pid}: done", flush=True)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_cluster_trains_identically(tmp_path):
    from paddle_tpu_torch.runtime import recordio
    from paddle_tpu_torch.trainer.trainer import SGDTrainer
    from paddle_tpu_torch.optim.optimizers import SGD

    outdir = str(tmp_path)
    recordio.convert(outdir, lambda: ({"sid": i} for i in range(24)), records_per_file=3)
    coord, master_port = _free_port(), _free_port()
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "worker", str(p),
                               "2", f"127.0.0.1:{coord}", str(master_port), outdir],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for p in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    consumed = [json.load(open(os.path.join(outdir, f"consumed_{i}.json")))
                for i in range(2)]
    assert sorted(consumed[0] + consumed[1]) == list(range(24))
    assert consumed[0] and consumed[1]
    p0 = dict(np.load(os.path.join(outdir, "params_0.npz")))
    p1 = dict(np.load(os.path.join(outdir, "params_1.npz")))
    assert set(p0) == set(p1)
    for k in p0:
        np.testing.assert_array_equal(p0[k], p1[k])
    xs, ys = _cluster_data()
    tr = SGDTrainer(_cluster_net(), SGD(learning_rate=0.1), seed=11, device="cpu")
    for batch in _global_batches(xs, ys):
        if tr.state is None:
            tr.init_state(batch)
        tr.step(batch)
    for k, v in tr.state["params"].items():
        np.testing.assert_allclose(p0[k], v.numpy(), rtol=2e-4, atol=2e-5)


if __name__ == "__main__" and len(sys.argv) > 1 and sys.argv[1] == "worker":
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], int(sys.argv[5]), sys.argv[6])
