"""`python -m paddle_tpu_torch train|dump_config` (the port's `cli.py`) on a
small v1 bi-GRU text config, on the CPU.

  * `train --device=cpu --num_passes=2 --save_dir` (one subprocess) prints
    the reference's pass lines with the evaluator's statistic and writes
    pass directories; the JAX package's `SGDTrainer.load` reads the last
    one, and the port loads what the JAX package saves from it.
  * `dump_config` (the second subprocess) prints exactly what the JAX
    package's `dump_config` prints.
  * In process: `--job=time` prints {"ms_per_batch", "batches"},
    `--job=test` (after `--init_model_path`) {"test_cost", "samples"};
    `--use_gpu=0` means the CPU; with no card and no `--device=cpu` train
    raises; `--trainer_count=2` trains over two rank processes and exits
    0 (while `serve --tp 2` still names ROADMAP.md §1 item 8), and
    `--compile_cache` exits 2 naming its missing counterpart; evaluators
    turn `--steps_per_dispatch > 1` back to 1, loudly;
    `--master_endpoints` trains on a task master's shards exactly as on the
    provider; `--elastic` at one trainer prints the reference's message and
    trains, and at `--trainer_count=2` with `--master_endpoints` follows
    the master's resize epochs (grown to 3 ranks, a joining rank process,
    then shrunk to 2, a leaving one); `--profile=pass:N` writes profile.json (and with `--job=time`
    joins the timing line).
  * On a card (marked `cuda`, skipped here): the config trains through the
    step graph and reaches both GRU kernels for both directions on every
    step, and its pass cost agrees with the CPU's.
jax is imported inside the CPU tests only."""

import json
import logging
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from paddle_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROVIDER = textwrap.dedent("""
    import numpy as np
    from paddle.trainer.PyDataProvider2 import *

    @provider(input_types={'word': integer_value_sequence(40), 'label': integer_value(2)},
              should_shuffle=False)
    def process(settings, filename):
        rs = np.random.RandomState(11)
        for _ in range(24):
            n = rs.randint(4, 10)
            yield {'word': rs.randint(0, 40, size=n).tolist(), 'label': int(rs.randint(2))}
    """)

CONF = textwrap.dedent("""
    from paddle.trainer_config_helpers import *
    size = get_config_arg('size', int, 8)
    settings(batch_size=8, learning_rate=1e-2, learning_method=AdamOptimizer())
    define_py_data_sources2(train_list='train.list', test_list='test.list',
                            module='bigru_provider', obj='process')
    word = data_layer(name='word', size=40)
    label = data_layer(name='label', size=2)
    emb = embedding_layer(input=word, size=size)
    bi = bidirectional_gru(input=emb, size=size)
    out = fc_layer(input=bi, size=2, act=SoftmaxActivation())
    outputs(classification_cost(input=out, label=label))
    """)


@pytest.fixture(scope="module")
def conf_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("bigru_conf")
    (d / "bigru_provider.py").write_text(PROVIDER)
    (d / "conf.py").write_text(CONF)
    (d / "train.list").write_text("dummy\n")
    (d / "test.list").write_text("dummy\n")
    return d


def _run(conf_dir, *args):
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}:{conf_dir}"
    return subprocess.run([sys.executable, "-m", "paddle_tpu_torch", *args],
                          cwd=conf_dir, env=env, capture_output=True, text=True,
                          timeout=600)


@pytest.fixture(scope="module")
def trained(conf_dir):
    """One CLI training run: two passes, checkpoints under out/."""
    out = conf_dir / "out"
    r = _run(conf_dir, "train", "--config=conf.py", "--device=cpu", "--num_passes=2",
             f"--save_dir={out}", "--log_period=1")
    assert r.returncode == 0, r.stderr[-2000:]
    return out, r


@pytest.fixture
def in_conf_dir(conf_dir, monkeypatch):
    monkeypatch.chdir(conf_dir)
    monkeypatch.syspath_prepend(str(conf_dir))
    return conf_dir


def _job(*argv):
    """A `train` command on the CPU, built in process (`cli.prepare_train`)."""
    return cli.prepare_train(cli.parse_args(["train", "--device=cpu", *argv]))


def _port_trainer(conf_dir):
    """The config's trainer, built as `train` builds it, its state made
    from the first batch."""
    job = _job(f"--config={conf_dir / 'conf.py'}")
    job.trainer.init_state(job.feeder(next(iter(job.reader()))))
    return job.trainer, job.feeder, job.reader


def test_train_prints_pass_lines_and_saves_pass_dirs(trained):
    out, r = trained
    lines = [l for l in r.stdout.splitlines() if l.startswith("pass ")]
    assert [l.split(":")[0] for l in lines] == ["pass 0", "pass 1"]
    for line in lines:
        assert "avg_cost=" in line and "test_cost=" in line
        assert "ClassificationErrorEvaluator=" in line
    assert (out / "pass-00001").is_dir()
    # --log_period=1: one "pass P batch B cost=" line per batch (3 a pass)
    assert r.stderr.count(" cost=") == 6


def test_pass_dir_loads_into_the_jax_package_and_back(trained, in_conf_dir, tmp_path):
    from paddle_tpu.config import build_optimizer as jbuild, parse_config as jparse
    from paddle_tpu.trainer.trainer import SGDTrainer as JaxTrainer

    out, _ = trained
    tr, feeder, reader = _port_trainer(in_conf_dir)
    tr.load(str(out))
    port = {k: v.numpy() for k, v in tr.state["params"].items()}

    jpc = jparse(str(in_conf_dir / "conf.py"), emit_proto=False)
    jb = jbuild(jpc.trainer_config.opt_config)
    jt = JaxTrainer(jpc.outputs, jb.optimizer, schedule=jb.schedule,
                    model_average=jb.model_average)
    jt.init_state(feeder(next(iter(reader()))))
    jt.load(str(out))
    ref = {k: np.asarray(v) for k, v in jt.state["params"].items()}
    assert set(ref) == set(port)
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k])

    jt.save(str(tmp_path), 0)
    fresh, _, _ = _port_trainer(in_conf_dir)
    fresh.load(str(tmp_path))
    for k, v in fresh.state["params"].items():
        np.testing.assert_array_equal(v.numpy(), ref[k])


def test_dump_config_matches_the_jax_cli(conf_dir, in_conf_dir, capsys):
    from paddle_tpu import cli as jcli

    r = _run(conf_dir, "dump_config", "--config=conf.py", "--config_args=size=6")
    assert r.returncode == 0, r.stderr[-2000:]
    assert jcli.main(["dump_config", "--config=conf.py", "--config_args=size=6"]) == 0
    ref = capsys.readouterr().out
    assert r.stdout == ref and 'type: "gated_recurrent"' in ref


def test_job_time_and_job_test(trained, in_conf_dir, capsys):
    out, _ = trained
    assert cli.main(["train", "--config=conf.py", "--device=cpu", "--job=time",
                     "--num_batches=2"]) == 0
    timed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(timed) == {"ms_per_batch", "batches"} and timed["batches"] == 2
    assert timed["ms_per_batch"] > 0
    assert cli.main(["train", "--config=conf.py", "--device=cpu", "--job=test",
                     f"--init_model_path={out}", "--start_pass=2"]) == 0
    tested = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tested["samples"] == 24 and np.isfinite(tested["test_cost"])
    # the loaded pass-00001 model, not a fresh one
    job = _job("--config=conf.py")
    job.trainer.init_state(job.feeder(next(iter(job.reader()))))
    job.trainer.load(str(out), 1)
    assert job.trainer.test(job.test_reader, job.feeder)["cost"] == \
        pytest.approx(tested["test_cost"], rel=1e-6)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_use_gpu_0_means_the_cpu(in_conf_dir, no_cuda, capsys):
    for flag in ("--use_gpu=0", "--use_tpu=0"):
        job = cli.prepare_train(cli.parse_args(
            ["train", "--config=conf.py", flag, "--job=time", "--num_batches=1"]))
        assert job.run() == 0
        assert job.trainer.device.type == "cpu"


def test_train_without_a_card_or_device_cpu_raises(in_conf_dir, no_cuda):
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["train", "--config=conf.py", "--job=time"])


@pytest.mark.parametrize("flag,item", [
    ("--trainer_count=2", r"item 8"), ("--compile_cache=cache", r"no counterpart"),
])
def test_unported_flags_exit_2_naming_their_item(flag, item, in_conf_dir, capfd):
    """--compile_cache exits 2 naming what it lacks. --trainer_count=2 is
    ported: it trains over two rank processes, rank 0 printing the pass
    line, and exits 0; so is the rest of ROADMAP item 8 (a mesh trainer's
    re-shard, item 8c): a one-rank same-size resize_to builds a new group
    and leaves the parameters bitwise as they were."""
    argv = ["train", "--config=conf.py", "--device=cpu", "--num_passes=1", flag]
    if flag.startswith("--trainer_count"):
        assert cli.main(argv) == 0
        out = capfd.readouterr().out
        assert sum(line.startswith("pass 0:") for line in out.splitlines()) == 1
        from paddle_tpu_torch.nn import costs as C
        from paddle_tpu_torch.nn import layers as L
        from paddle_tpu_torch.optim.optimizers import SGD
        from paddle_tpu_torch.parallel import DataParallel, make_mesh
        from paddle_tpu_torch.trainer.trainer import SGDTrainer

        cost = C.SquareError(L.Fc(L.Data("x", shape=(4,)), 1, act=None, name="o"),
                             L.Data("y", shape=(1,)))
        tr = SGDTrainer(cost, SGD(), device="cpu",
                        parallel=DataParallel(make_mesh({"data": 1}, device="cpu")))
        tr.init_state({"x": np.ones((2, 4), np.float32), "y": np.ones((2, 1), np.float32)})
        before, old = {k: v.clone() for k, v in tr.state["params"].items()}, tr.mesh
        tr.resize_to(1)
        assert tr.mesh is not old and old.closed and tr.parallel.data_axis_size == 1
        for k, v in tr.state["params"].items():
            assert torch.equal(v, before[k]), k
        return
    assert cli.main(argv) == 2
    err = capfd.readouterr().err
    assert "NotPorted" in err
    assert __import__("re").search(item, err), err


def _samples():
    """The provider's 24 samples, as `process` yields them."""
    rs = np.random.RandomState(11)
    out = []
    for _ in range(24):
        n = rs.randint(4, 10)
        out.append({'word': rs.randint(0, 40, size=n).tolist(), 'label': int(rs.randint(2))})
    return out


def _pass_line(out: str) -> str:
    return next(l for l in out.splitlines() if l.startswith("pass 0:"))


def test_master_endpoints_trains_on_the_masters_tasks(in_conf_dir, tmp_path, capsys):
    """--master_endpoints takes the samples from the task master (pickled
    provider-format samples in recordio shards, one task a shard): the
    pass line equals the provider's run on the same samples, and every
    task is done exactly once."""
    from paddle_tpu_torch.runtime import recordio
    from paddle_tpu_torch.runtime.master import MasterClient, MasterServer, TaskMaster

    assert cli.main(["train", "--config=conf.py", "--device=cpu", "--num_passes=1"]) == 0
    want = _pass_line(capsys.readouterr().out)
    shards = recordio.convert(str(tmp_path / "ds"), _samples, records_per_file=8)
    srv = MasterServer(TaskMaster()).start()
    try:
        c = MasterClient(srv.address)
        c.call("set_dataset", shards=shards, chunks_per_task=1)
        assert cli.main(["train", "--config=conf.py", "--device=cpu", "--num_passes=1",
                         "--master_endpoints=%s:%d" % srv.address]) == 0
        assert _pass_line(capsys.readouterr().out) == want
        st = c.call("stats")
        assert st["done"] == len(shards) == 3 and st["discarded"] == 0
        c.close()
    finally:
        srv.stop()


@pytest.mark.parametrize("argv", [
    ["--elastic=1"], ["--profile=pass:1"], ["--profile=pass:0", "--job=time", "--num_batches=2"],
])
def test_elastic_and_profile_flags_train(argv, in_conf_dir, tmp_path, capsys):
    """--elastic at one trainer prints the reference's message and trains;
    --profile=pass:N writes profile.json (a capture of pass N, the step's
    FLOP and byte buckets); with --job=time the buckets join the line."""
    import os

    pdir = str(tmp_path / "prof")
    assert cli.main(["train", "--config=conf.py", "--device=cpu", "--num_passes=2",
                     f"--profile_dir={pdir}", *argv]) == 0
    out = capsys.readouterr()
    last = out.out.strip().splitlines()[-1]
    if argv[0] == "--elastic=1":
        assert "--elastic needs --master_endpoints" in out.err
        assert "continuing without elastic resize" in out.err
        assert last.startswith("pass 1:")
        return
    got = json.loads(last)
    if "--job=time" in argv:
        assert got["batches"] == 2 and got["trace_dir"] == pdir
        assert got["hlo_cost"]["flops"] > 0 and got["hlo_cost"]["bytes_accessed"] > 0
        assert os.path.exists(os.path.join(pdir, "trace.json"))
        return
    assert got["trace_dir"] == pdir
    report = json.load(open(got["profile_json"]))
    assert report["captured"] is True and report["profile"] == "pass:1"
    step = report["executables"]["train_step"]
    assert step["flops"] > 0 and 0 < len(step["top_buckets"]) <= report["top_k"] == 3
    assert {"generated_unix_s", "top_k", "executables"} <= set(report)


@pytest.mark.timeout(240)
def test_elastic_trainer_count_follows_the_masters_resize_epochs(in_conf_dir, capfd):
    """--elastic=1 --trainer_count=2 --master_endpoints: rank 0 holds the
    job's one ResizeClient; the master grows the job to 3 (the launcher
    starts the joining rank process, which receives the state and trains
    on) and then shrinks it to 2 (that rank leaves and exits 0). Both
    epochs complete on the master, rank 0 prints every pass line, and the
    command exits 0. Each batch's copy is slowed (h2d_delay) so the passes
    outlast the epochs."""
    import threading
    import time

    from paddle_tpu_torch.runtime.master import MasterClient, MasterServer, TaskMaster

    srv = MasterServer(TaskMaster(), lease_s=2.0).start()
    boot = MasterClient(srv.address)
    log_, done = [], threading.Event()

    def wait(pred, what, timeout=90.0):
        deadline = time.monotonic() + timeout
        while not done.is_set() and time.monotonic() < deadline:
            st = boot.call("stats")
            if pred(st):
                return True
            time.sleep(0.05)
        log_.append(f"timed out waiting for {what}")
        return False

    def drive():
        if not wait(lambda st: st["live_trainers"] >= 1, "rank 0's lease"):
            return
        for world, n in ((3, 1), (2, 2)):
            log_.append(boot.call("resize", world=world))
            if not wait(lambda st: st["resize"]["completed"] >= n, f"epoch {n}"):
                return

    th = threading.Thread(target=drive, daemon=True)
    th.start()
    host, port = srv.address
    try:
        rc = cli.main(["train", "--config=conf.py", "--device=cpu", "--num_passes=40",
                       "--trainer_count=2", "--elastic=1", "--log_period=0",
                       f"--master_endpoints={host}:{port}", "--prefetch_depth=1",
                       "--faults=h2d_delay:60ms"])
        done.set()
        th.join(5)
        st = boot.call("stats")["resize"]
    finally:
        done.set()
        boot.close()
        srv.stop()
    out = capfd.readouterr().out
    assert rc == 0
    assert [d["state"] for d in log_ if isinstance(d, dict)] == ["draining", "draining"], log_
    assert st["state"] == "idle" and st["completed"] == 2, (st, log_)
    lines = [l for l in out.splitlines() if l.startswith("pass ")]
    assert len(lines) == 40 and lines[-1].startswith("pass 39: avg_cost=")


def test_shard_update_at_one_trainer_warns_and_trains(in_conf_dir, caplog, capsys):
    with caplog.at_level(logging.WARNING, logger="paddle_tpu_torch.cli"):
        assert cli.main(["train", "--config=conf.py", "--device=cpu", "--job=time",
                         "--num_batches=1", "--shard_update=1",
                         "--grad_compression=bf16"]) == 0
    assert "ignoring them" in caplog.text


def test_evaluators_turn_steps_per_dispatch_back_to_1(in_conf_dir, caplog, capsys):
    with caplog.at_level(logging.WARNING, logger="paddle_tpu_torch.cli"):
        job = _job("--config=conf.py", "--steps_per_dispatch=2", "--log_period=0")
        assert job.run() == 0
    assert "falling back to steps_per_dispatch=1" in caplog.text
    ((ev, _),) = job.evaluators
    assert ev.total == 24  # every example of the pass was counted
    assert "ClassificationErrorEvaluator=" in capsys.readouterr().out


def test_job_time_keeps_the_loaded_model(trained, in_conf_dir, capsys):
    """--job=time --init_model_path times the loaded model: the JAX CLI's
    `_job_time` calls init_state again after the load (ROADMAP.md §3),
    the port keeps the state (48 samples after two passes of 24, then 3
    timed and warm-up steps of 8)."""
    out, _ = trained
    job = _job("--config=conf.py", "--job=time", "--num_batches=2",
               f"--init_model_path={out}", "--start_pass=2")
    assert job.run() == 0
    assert int(job.trainer.state["samples"]) == 48 + 3 * 8


def test_a_failing_evaluator_stops_training(in_conf_dir, tmp_path, capsys):
    """The JAX CLI's handler wraps evaluator updates in `except Exception`
    and prints statistics over what did not fail; the port's raises. A
    pnpair evaluator declared without its query_id input fails its first
    update."""
    conf = (in_conf_dir / "conf.py").read_text().replace(
        "outputs(classification_cost(input=out, label=label))",
        "outputs(classification_cost(input=out, label=label))\n"
        "pnpair_evaluator(input=out, label=label)")
    (in_conf_dir / "pnpair_conf.py").write_text(conf)
    with pytest.raises(ValueError):
        cli.main(["train", "--config=pnpair_conf.py", "--device=cpu", "--log_period=0"])


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_bigru_config_reaches_both_gru_kernels(cuda, in_conf_dir, capsys):
    from paddle_tpu_torch.ops import rnn_kernels

    def run(device):
        f0, b0 = rnn_kernels.FWD_LAUNCHES, rnn_kernels.BWD_LAUNCHES
        job = cli.prepare_train(cli.parse_args(
            ["train", "--config=conf.py", f"--device={device}", "--num_passes=1",
             "--log_period=0"]))
        assert job.run() == 0
        line = [l for l in capsys.readouterr().out.splitlines() if l.startswith("pass 0")]
        cost = float(line[0].split("avg_cost=")[1].split()[0])
        return job, cost, rnn_kernels.FWD_LAUNCHES - f0, rnn_kernels.BWD_LAUNCHES - b0

    _, cpu_cost, cpu_fwd, cpu_bwd = run("cpu")
    job, card_cost, fwd, bwd = run("cuda")
    trainer = job.trainer
    steps = tests = 3  # 24 examples in batches of 8, trained and tested
    assert (cpu_fwd, cpu_bwd) == (0, 0)
    # both directions: forward and backward every step, forward at the
    # parameters' init and at each test batch
    assert (fwd, bwd) == (2 * (steps + tests + 1), 2 * steps)
    (graph,) = trainer.graphs.values()
    assert graph.replays == steps - 1
    assert card_cost == pytest.approx(cpu_cost, rel=1e-4)
    assert job.evaluators[0][0].total == 24
