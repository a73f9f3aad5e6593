"""The elastic re-shard of a data-parallel port trainer
(`SGDTrainer.resize_to` / `_drain_resize`, `parallel/distributed.py`'s
rendezvous) against the JAX package's `tests/test_resize.py` contract, on
the CPU.

The port's ranks are gloo threads over one HashStore (`run_elastic`): when
rank 0 announces a grown world in the job's store, the harness starts the
joining ranks as threads (`distributed.join`), as the CLI's launcher starts
processes. Every run starts from the JAX package's initial parameters and
sees the same numpy batches; rank 0 requests the resize after batch 1 (the
JAX test's `at_batch`), so the pass drains at batch 2.

  * grow 2->4 and shrink 4->2 mid-pass end allclose to the fixed-size run
    (parameters rtol 1e-5 / atol 1e-7, the pass avg_cost rel 1e-6, the same
    batches), the port's and the JAX package's, with the drain / reshard /
    resume split in EndPass `resizes`;
  * a same-size `resize_to` (a new group, the canonical round trip) and a
    drain-only epoch are bitwise;
  * zero1 grows with its flat geometry rebuilt (`updater.n == 4`); K = 2;
    a DevicePrefetcher's in-flight stacked groups are re-cut from their host
    copies and the prefetcher is rebound;
  * a world whose joiners never arrive is rejected after the drain: bitwise,
    `resize_rejected == 1`, no epoch;
  * `reshard_kill` after the drain checkpoint: the job dies on every rank,
    and a four-rank auto-resume lands bitwise on the uninterrupted grown run;
  * `resize_drain_stall` fires in the local drain;
  * a real `MasterServer` announcing world 4 to rank 0's `ResizeClient`
    grows the job through the fleet barrier."""

from __future__ import annotations

import threading
import time
import traceback
import types

import numpy as np
import pytest
import torch
from torch.distributed import HashStore, PrefixStore

from paddle_tpu_torch.core import faults, preempt, stats
from paddle_tpu_torch.nn import costs as TC
from paddle_tpu_torch.nn import layers as TL
from paddle_tpu_torch.nn.graph import reset_name_scope
from paddle_tpu_torch.optim import optimizers as topt
from paddle_tpu_torch.parallel import DataParallel, distributed, make_mesh
from paddle_tpu_torch.parallel import mesh as tmesh
from paddle_tpu_torch.trainer import checkpoint as ckpt
from paddle_tpu_torch.trainer.events import EndIteration, EndPass
from paddle_tpu_torch.trainer.trainer import SGDTrainer

DIM, CLASSES, BATCH, N = 12, 3, 24, 144  # tests/test_resize.py's sizes
RTOL, ATOL, COST_REL = 1e-5, 1e-7, 1e-6


@pytest.fixture(autouse=True)
def _fresh():
    preempt.reset()
    stats.FT_EVENTS.reset()
    yield
    preempt.reset()


def _data():
    rs = np.random.RandomState(0)
    xs = rs.randn(N, DIM).astype(np.float32)
    return xs, (xs.sum(-1) > 0).astype(np.int32)


def _reader():
    xs, ys = _data()

    def reader():
        for i in range(0, N, BATCH):
            yield {"x": xs[i:i + BATCH], "label": ys[i:i + BATCH]}

    return reader


def _net(L, C):
    x = L.Data("x", shape=(DIM,))
    lbl = L.Data("label", shape=())
    h = L.Fc(x, 24, act="relu", name="h")
    return C.ClassificationCost(L.Fc(h, CLASSES, act=None, name="out"), lbl, name="cost")


# -- the JAX package's runs (tests/test_resize.py's own `_run`) ----------------


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX oracle, once for the file: the initial parameters and the
    fixed / resized runs the tests compare with."""
    import test_resize as jr

    from paddle_tpu.nn.graph import reset_name_scope as jreset

    jreset()
    tr = jr._build(2)
    xs, ys = _data()
    tr.init_state(tr.parallel.shard_batch({"x": xs[:BATCH], "label": ys[:BATCH]}))
    init = {k: np.asarray(v) for k, v in tr.state["params"].items()}

    def run(*a, **kw):
        t, m = jr._run(*a, **kw)
        return jr._params(t), m

    out = {"init": init, "fixed2": run(2), "grow": run(2, target=4), "fixed4": run(4),
           "shrink": run(4, target=2), "fixed2_k2": run(2, steps_per_dispatch=2),
           "grow_k2": run(2, target=4, steps_per_dispatch=2),
           "fixed2_zero1": run(2, shard=True), "fixed2_2pass": run(2, passes=2)}
    preempt.reset()
    return out


# -- the port's runs -------------------------------------------------------------


def run_elastic(n, fn, timeout=120, joiners=True):
    """fn(rank, mesh, plan) in n gloo rank threads over one HashStore (plan
    None), and, whenever rank 0 announces a grown world in the job's store,
    in a thread for each joining rank (plan: its `ElasticPlan`; none with
    joiners=False) -> {rank: result of its last thread}, with `.errors`
    {rank: (exception, traceback)} of the threads that raised."""
    store = HashStore()
    results, errors, threads = {}, {}, []

    def guarded(r, body):
        try:
            results[r] = body()
        except BaseException as e:  # handed to the test
            errors[r] = (e, traceback.format_exc())

    def member(r):
        g = tmesh.new_gloo_group(PrefixStore("dp", store), r, n, timeout_s=60)
        return fn(r, make_mesh({"data": n}, group=g, device="cpu"), None)

    def joiner(r, attempt):
        try:
            g, plan = distributed.join(PrefixStore("dp", store), attempt, r,
                                       torch.device("cpu"))
        except ValueError:  # the attempt was rejected: the job went on without it
            return None
        return fn(r, make_mesh(plan.axes, group=g, device="cpu"), plan)

    def start(r, body):
        t = threading.Thread(target=guarded, args=(r, body), daemon=True)
        t.start()
        threads.append(t)

    for r in range(n):
        start(r, lambda r=r: member(r))
    job, seen = PrefixStore("dp", store), 0
    deadline = time.monotonic() + timeout
    while any(t.is_alive() for t in threads):
        assert time.monotonic() < deadline, "a rank hung"
        plan = distributed.latest_plan(job)
        if joiners and plan is not None and plan.attempt > seen:
            seen = plan.attempt
            for r in range(plan.old_world, plan.world):
                start(r, lambda r=r, a=plan.attempt: joiner(r, a))
        time.sleep(0.005)
    out = types.SimpleNamespace(results=results, errors=errors)
    return out


def _trainer(cost, mesh, init, shard=False, **kw):
    tr = SGDTrainer(cost, topt.SGD(learning_rate=0.125, momentum=0.5), seed=5,
                    device="cpu", parallel=DataParallel(mesh), shard_update=shard, **kw)
    if init is not None:
        xs, ys = _data()
        tr.init_state({"x": xs[:BATCH], "label": ys[:BATCH]})
        tr.load_params(init)
    return tr


def _canonical(tr):
    return {k: v.numpy().copy() for k, v in tr.canonical_params().items()}


def port_run(world, init, target=None, at_batch=1, shard=False, passes=1, reader=None,
             before=None, rank0=None, then=None, expect_errors=False, joiners=True,
             **train_kw):
    """The port's counterpart of tests/test_resize.py `_run`: `world` rank
    threads from `init`, rank 0 requesting a resize to `target` after
    (pass 0, batch `at_batch`); `reader(trainer)` makes a rank's reader,
    `before(event)` sees rank 0's events, `rank0` adds train() arguments on
    rank 0, `then(trainer)` runs on every rank after training -> the run,
    with rank 0's canonical parameters (`.params`), EndPass metrics
    (`.metrics`) and trainer."""
    preempt.reset()
    reset_name_scope()
    cost = _net(TL, TC)

    def fn(r, mesh, plan):
        tr = _trainer(cost, mesh, init if plan is None else None, shard)
        metrics = []

        def handler(ev):
            if (r == 0 and target is not None and isinstance(ev, EndIteration)
                    and (ev.pass_id, ev.batch_id) == (0, at_batch)):
                preempt.get().request_resize(target, reason="test resize")
            if r == 0 and before is not None:
                before(ev)
            if isinstance(ev, EndPass):
                metrics.append(ev.metrics)

        read = reader(tr) if reader is not None else _reader()
        tr.train(read, num_passes=passes, event_handler=handler, log_period=0,
                 elastic=True, join=plan, **{**train_kw, **((rank0 or {}) if r == 0 else {})})
        if then is not None:
            then(tr)
        params = _canonical(tr) if tr.left is None else None
        return types.SimpleNamespace(trainer=tr, metrics=metrics, params=params, read=read)

    run = run_elastic(world, fn, joiners=joiners)
    if not expect_errors:
        assert not run.errors, next(iter(run.errors.values()))[1]
    if 0 in run.results:
        lead = run.results[0]
        run.params, run.metrics, run.trainer = lead.params, lead.metrics, lead.trainer
    return run


def _bitwise(a, b, what):
    for k in a:
        assert np.array_equal(a[k].view(np.uint32), b[k].view(np.uint32)), \
            f"{what}: {k} differs by {np.abs(a[k] - b[k]).max()}"


def _close(a, b, what):
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=ATOL, err_msg=f"{what}: {k}")


@pytest.fixture(scope="module")
def port_fixed(jax_runs):
    return {w: port_run(w, jax_runs["init"]) for w in (2, 4)}


@pytest.fixture(scope="module")
def port_grow(jax_runs):
    preempt.reset()
    stats.FT_EVENTS.reset()
    run = port_run(2, jax_runs["init"], target=4)
    run.epochs = stats.FT_EVENTS.get("resize_epoch")
    return run


# -- grow and shrink ----------------------------------------------------------------


@pytest.mark.timeout(120)
def test_grow_mid_pass_matches_fixed_size_run(jax_runs, port_fixed, port_grow):
    run = port_grow
    assert sorted(run.results) == [0, 1, 2, 3]
    for r, res in run.results.items():
        assert res.trainer.parallel.data_axis_size == 4 and res.trainer.mesh.rank == r
        _bitwise(run.params, res.params, f"rank {r} after the grow")
    fixed = port_fixed[2]
    _close(fixed.params, run.params, "port grow 2->4 vs the port's fixed 2")
    _close(jax_runs["fixed2"][0], run.params, "port grow vs the JAX package's fixed 2")
    _close(jax_runs["grow"][0], run.params, "port grow vs the JAX package's grow")
    m = run.metrics[0]
    assert m["avg_cost"] == pytest.approx(fixed.metrics[0]["avg_cost"], rel=COST_REL)
    assert m["avg_cost"] == pytest.approx(jax_runs["grow"][1][0]["avg_cost"], rel=COST_REL)
    assert m["batches"] == fixed.metrics[0]["batches"] == jax_runs["grow"][1][0]["batches"]
    assert m["resize_epochs"] == 1 and run.epochs == 1
    (split,) = m["resizes"]
    assert (split["world"], split["pass"], split["batch"]) == (4, 0, 2)
    assert all(split[leg] >= 0.0 for leg in ("drain_s", "reshard_s", "resume_s"))
    assert set(split) == set(jax_runs["grow"][1][0]["resizes"][0])


@pytest.mark.timeout(120)
def test_shrink_mid_pass_matches_fixed_size_run(jax_runs, port_fixed):
    run = port_run(4, jax_runs["init"], target=2)
    assert run.trainer.parallel.data_axis_size == 2
    for r in (2, 3):  # left after the canonical gather, at the drained batch
        assert run.results[r].trainer.left == {"rank": r, "world": 2, "pass": 0, "batch": 2}
        assert run.results[r].trainer.mesh.closed
    _bitwise(run.params, run.results[1].params, "rank 1 after the shrink")
    _close(port_fixed[4].params, run.params, "port shrink 4->2 vs the port's fixed 4")
    _close(jax_runs["shrink"][0], run.params, "port shrink vs the JAX package's shrink")
    assert run.metrics[0]["avg_cost"] == pytest.approx(
        jax_runs["fixed4"][1][0]["avg_cost"], rel=COST_REL)
    assert run.metrics[0]["batches"] == jax_runs["fixed4"][1][0]["batches"]
    assert run.metrics[0]["resize_epochs"] == 1


# -- the seam itself -----------------------------------------------------------------


def _roundtrip(tr):
    """A same-size resize_to on a trained rank: a new group, the canonical
    round trip -> the parameters after it."""
    old, before = tr.mesh, _canonical(tr)
    tr.resize_to(tr.mesh.size)
    assert tr.mesh is not old and old.closed and tr.mesh.size == old.size
    tr.roundtrip = (before, _canonical(tr))


@pytest.mark.timeout(120)
def test_same_size_resize_roundtrip_is_bitwise(jax_runs, port_fixed):
    """A same-size `resize_to` (a new group, the canonical round trip, a
    re-laid state) changes nothing; a drained epoch to the size already
    running is drain-only: no re-shard, bitwise."""
    run = port_run(2, jax_runs["init"], then=_roundtrip)
    for res in run.results.values():
        _bitwise(*res.trainer.roundtrip, "2->2 resize_to round trip")
    _bitwise(port_fixed[2].params, run.params, "2->2 resize_to vs the fixed run")
    drained = port_run(2, jax_runs["init"], target=2)
    assert drained.metrics[0]["resize_epochs"] == 1
    assert not drained.trainer._resized  # drain-only: the mesh stayed
    _bitwise(port_fixed[2].params, drained.params, "2->2 drain-only epoch")
    assert drained.metrics[0]["avg_cost"] == port_fixed[2].metrics[0]["avg_cost"]


@pytest.mark.timeout(120)
def test_resize_composes_with_shard_update(jax_runs):
    """zero1's flat rows re-flatten for the new shard count through the
    canonical seams; the grown run matches the fixed-size one, and the
    same-size seam stays bitwise under zero1."""
    fixed = port_run(2, jax_runs["init"], shard=True, then=_roundtrip)
    for res in fixed.results.values():
        _bitwise(*res.trainer.roundtrip, "zero1 2->2 round trip")
    grown = port_run(2, jax_runs["init"], target=4, shard=True)
    assert grown.trainer.parallel.data_axis_size == 4
    assert grown.trainer.updater.n == 4 and grown.trainer.updater.mode == "zero1"
    for r, res in grown.results.items():
        assert res.trainer.updater.rank == r
    _close(fixed.trainer.roundtrip[0], grown.params, "zero1 grow vs the port's fixed")
    _close(jax_runs["fixed2_zero1"][0], grown.params, "zero1 grow vs the JAX package")
    assert grown.metrics[0]["avg_cost"] == pytest.approx(
        jax_runs["fixed2_zero1"][1][0]["avg_cost"], rel=COST_REL)


@pytest.mark.timeout(120)
def test_resize_composes_with_k_step_dispatch(jax_runs):
    grown = port_run(2, jax_runs["init"], target=4, steps_per_dispatch=2)
    assert grown.trainer.parallel.data_axis_size == 4
    fixed_p, fixed_m = jax_runs["fixed2_k2"]
    _close(fixed_p, grown.params, "K=2 grow vs the JAX package's fixed")
    _close(jax_runs["grow_k2"][0], grown.params, "K=2 grow vs the JAX package's grow")
    assert grown.metrics[0]["batches"] == fixed_m[0]["batches"]
    assert grown.metrics[0]["avg_cost"] == pytest.approx(fixed_m[0]["avg_cost"],
                                                         rel=COST_REL)
    assert grown.metrics[0]["resizes"][0]["batch"] == 2  # the pending pair flushed first


@pytest.mark.timeout(120)
def test_resize_with_prefetcher_stacked_straggler(jax_runs, monkeypatch):
    """The prefetcher's in-flight stacked groups were cut for the old plan
    (this rank's rows of the old world); the trainer re-cuts them from their
    host copies for the new plan, then rebinds the prefetcher, so only those
    take the straggler path. The result matches the fixed-size run."""
    from paddle_tpu_torch.data.pipeline import DevicePrefetcher

    def prefetcher(tr):
        return DevicePrefetcher(_reader(), parallel=tr.parallel, prefetch_depth=2,
                                stack_k=2, device="cpu")

    recut = []  # the trainer pads a batch itself only to re-cut a straggler
    pad = DataParallel.maybe_pad_batch

    def counted(self, batch, where="batch"):
        if where != "prefetch":
            recut.append(self.data_axis_size)
        return pad(self, batch, where)

    monkeypatch.setattr(DataParallel, "maybe_pad_batch", counted)
    fixed = port_run(2, jax_runs["init"], reader=prefetcher, steps_per_dispatch=2)
    assert not recut
    grown = port_run(2, jax_runs["init"], target=4, reader=prefetcher,
                     steps_per_dispatch=2)
    assert recut and set(recut) == {4}  # re-cut for the new plan only
    for res in grown.results.values():
        assert res.trainer.parallel.data_axis_size == 4
        assert res.read.parallel is res.trainer.parallel  # rebound (joiners: built so)
    assert grown.metrics[0]["batches"] == fixed.metrics[0]["batches"]
    _close(fixed.params, grown.params, "prefetched grow vs the prefetched fixed run")
    _close(jax_runs["fixed2_k2"][0], grown.params, "prefetched grow vs the JAX package")
    assert grown.metrics[0]["avg_cost"] == pytest.approx(fixed.metrics[0]["avg_cost"],
                                                         rel=COST_REL)


# -- rejection, kill, stall ------------------------------------------------------


@pytest.mark.timeout(120)
def test_resize_rejected_when_joiners_never_arrive(jax_runs, port_fixed, monkeypatch):
    """Joiners that never arrive within the rendezvous timeout: the resize
    is rejected after the drain on every rank, the pass finishes on the old
    group with untouched results, and no epoch is recorded."""
    monkeypatch.setenv(distributed.RENDEZVOUS_TIMEOUT_ENV, "0.3")
    stats.FT_EVENTS.reset()
    run = port_run(2, jax_runs["init"], target=4, joiners=False)
    assert run.trainer.parallel.data_axis_size == 2
    assert run.metrics[0].get("resize_epochs", 0) == 0
    assert stats.FT_EVENTS.get("resize_rejected") == 1
    assert stats.FT_EVENTS.get("resize_epoch") == 0
    _bitwise(port_fixed[2].params, run.params, "rejected resize")
    assert run.metrics[0]["avg_cost"] == port_fixed[2].metrics[0]["avg_cost"]
    assert sorted(run.results) == [0, 1] and not run.trainer._resized


@pytest.mark.chaos
@pytest.mark.timeout(120)
def test_reshard_kill_auto_resume_bitwise(jax_runs, port_grow, tmp_path):
    """`reshard_kill` fires on rank 0 after the drain checkpoint and the
    canonical gather; every rank of the job dies with it, before any group
    is built. A four-rank run auto-resumes from the drained boundary and
    lands bitwise on the uninterrupted grown run."""
    with faults.inject("reshard_kill:step=0") as inj:
        killed = port_run(2, jax_runs["init"], target=4, save_dir=str(tmp_path),
                          expect_errors=True)
        assert inj.fired["reshard_kill"] == 1
    assert sorted(killed.errors) == [0, 1]
    assert all(isinstance(e, faults.InjectedKill) for e, _ in killed.errors.values())
    assert ckpt.find_latest_valid_pass(str(tmp_path)) == 0
    extra = ckpt.pass_manifest(str(tmp_path), 0)["extra"]
    assert extra["mid_pass"] and extra["batches_done"] == 2 and extra["world_size"] == 2
    resumed = port_run(4, None, save_dir=str(tmp_path), auto_resume=True)
    _bitwise(port_grow.params, resumed.params, "reshard_kill resume")
    assert resumed.metrics[0]["batches"] == port_grow.metrics[0]["batches"] - 2


@pytest.mark.chaos
@pytest.mark.timeout(120)
def test_resize_drain_stall_site_fires_locally(jax_runs, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_RESIZE_STALL_S", "0.05")
    with faults.inject("resize_drain_stall:step=0") as inj:
        run = port_run(2, jax_runs["init"], target=4)
        assert inj.fired["resize_drain_stall"] == 1
    assert run.trainer.parallel.data_axis_size == 4
    assert run.metrics[0]["resize_epochs"] == 1
    assert run.metrics[0]["resizes"][0]["drain_s"] >= 0.05


# -- the fleet -----------------------------------------------------------------------


@pytest.mark.timeout(120)
def test_resize_client_drives_trainer_end_to_end(jax_runs):
    """A real master announces world 4; rank 0's ResizeClient (the job's
    one member) parks the order, the job drains at a boundary, rank 0 acks
    the barrier, every rank re-shards, the joiners come in, and the result
    matches the fixed-size run; the epoch completes on the master."""
    from paddle_tpu_torch.runtime.master import (
        MasterClient, MasterServer, ResizeClient, TaskMaster)

    srv = MasterServer(TaskMaster(), lease_s=0.45).start()
    rc = None
    try:
        rc = ResizeClient(srv.address, poll_s=0.05)
        boot = MasterClient(srv.address)
        announced = []

        def before(ev):
            if isinstance(ev, EndIteration):
                if ev.pass_id == 0 and ev.batch_id == 1 and not announced:
                    announced.append(boot.call("resize", world=4))
                time.sleep(0.05)  # stretch the pass past a heartbeat period

        run = port_run(2, jax_runs["init"], passes=2, before=before,
                       rank0={"resize_barrier": rc.barrier})
        assert announced and announced[0]["state"] == "draining"
        assert announced[0]["barrier"] == 1  # one member: the job
        assert run.trainer.parallel.data_axis_size == 4
        _close(jax_runs["fixed2_2pass"][0], run.params, "fleet grow vs the JAX package")
        assert sum(m.get("resize_epochs", 0) for m in run.metrics) == 1
        st = boot.call("stats")["resize"]
        assert st["state"] == "idle" and st["completed"] == 1
        boot.close()
    finally:
        if rc is not None:
            rc.close()
        srv.stop()
