"""The port's native runtime (`paddle_tpu_torch/runtime/{build,native,recordio,
allocator,optimizer}.py`, `master.TaskMaster`, over its own copy of the C++
in `paddle_tpu_torch/csrc/native/`) against the JAX package's, on the CPU.

  * The build: g++ writes one library into `build/paddle_tpu_torch/`, named
    by a hash of the sources and flags; a source that does not compile
    raises with the compiler's output; no compiler raises too.
  * tests/test_runtime.py case for case on the port: the buddy pool
    (alloc, free, coalescing, double free, views outliving release,
    exhaustion), recordio (round trip, a corrupt chunk skipped and counted,
    an oversized chunk header read as corruption), `convert` /
    `read_shards`, the task master (leases, timeouts, the failure cap,
    passes, snapshot and restore, a truncated snapshot leaving the live
    queues alone), the native optimizer (against the port's `optim/` for
    sgd with momentum and adam, serialisation, the linear lr policy).
  * Across the packages: files the port writes read by the JAX package's
    `Reader` and the Python oracle, and the JAX package's files read by the
    port's, record for record; shards the same both ways; a port
    `TaskMaster` snapshot restored by the JAX package's and back; the
    native optimizer equal to the JAX package's, bit for bit, for sgd,
    adagrad, adadelta and adam and the linear lr policy.
  * A HostPool array stages a batch that a port network takes as is.
jax is imported inside the tests only (the JAX package's runtime imports
it)."""

import os
import struct
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.runtime import build, recordio
from paddle_tpu_torch.runtime.allocator import HostPool
from paddle_tpu_torch.runtime.master import TaskMaster
from paddle_tpu_torch.runtime.optimizer import NativeOptimizer


# -- the build -----------------------------------------------------------------


def test_build_writes_one_hashed_library_under_build():
    lib = build.build()
    assert lib.parent == build.BUILD_DIR
    assert lib.parent.parts[-2:] == ("build", "paddle_tpu_torch")
    assert lib.name.startswith(build.NAME + "-") and lib.exists()
    assert all(s.parent == build.NATIVE_DIR for s in build.sources())
    assert {s.name for s in build.sources()} == {"allocator.cc", "master.cc", "optimizer.cc",
                                                 "recordio.cc"}
    assert build.build() == lib  # reused, not rebuilt


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    (tmp_path / "broken.cc").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(build, "NATIVE_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="broken.cc"):
        build.build()
    monkeypatch.setenv("CXX", "no-such-compiler")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        build.find_cxx()


# -- the pool ------------------------------------------------------------------


def test_buddy_allocator_alloc_free_coalesce():
    pool = HostPool(total_bytes=1 << 20, min_block=256)
    addrs = [pool.alloc(1000) for _ in range(64)]
    assert len(set(addrs)) == 64
    assert pool.stats()["in_use"] == 64 * 1024
    for a in addrs:
        pool.free(a)
    st = pool.stats()
    assert st["in_use"] == 0 and st["n_frees"] == 64
    pool.free(pool.alloc((1 << 20) - 1))  # fully coalesced
    a = pool.alloc(128)
    pool.free(a)
    with pytest.raises(ValueError):
        pool.free(a)
    pool.close()


def test_pool_ndarray_outlives_release_until_its_views_die():
    pool = HostPool(total_bytes=1 << 20)
    arr = pool.ndarray((16, 32), np.float32)
    arr[:] = np.arange(512, dtype=np.float32).reshape(16, 32)
    assert float(arr.sum()) == float(np.arange(512).sum())
    pool.release(arr)
    assert pool.stats()["in_use"] > 0
    with pytest.raises(RuntimeError, match="view"):
        pool.close()
    view = arr[2:4]
    del arr
    assert pool.stats()["in_use"] > 0
    del view
    assert pool.stats()["in_use"] == 0
    pool.close()


def test_pool_exhaustion_raises():
    pool = HostPool(total_bytes=1 << 16)
    a, b = pool.alloc(1 << 15), pool.alloc(1 << 15)
    with pytest.raises(MemoryError):
        pool.alloc(1024)
    pool.free(a)
    pool.free(b)
    pool.close()


def test_pool_stages_a_batch_for_a_network():
    from paddle_tpu_torch.nn import graph as tgraph
    from paddle_tpu_torch.nn import layers as TL

    tgraph.reset_name_scope()
    net = tgraph.Network([TL.Fc(TL.Data("x", shape=(6,)), 3, act=None, name="fc")])
    pool = HostPool(total_bytes=1 << 20)
    staged = pool.ndarray((4, 6), np.float32)
    staged[:] = np.random.RandomState(0).randn(4, 6)
    params = net.init({"x": staged}, device="cpu")
    x = torch.from_numpy(staged)  # shares the pool's memory
    assert x.data_ptr() == staged.__array_interface__["data"][0]
    got = net.apply(params, {"x": x})["fc"].value
    want = torch.from_numpy(staged.copy()) @ params["fc.w"] + params["fc.b"]
    torch.testing.assert_close(got, want)
    pool.release(staged)
    del staged, x
    assert pool.stats()["in_use"] == 0
    pool.close()


# -- recordio ------------------------------------------------------------------


def _records(seed=0, n=257):
    rs = np.random.RandomState(seed)
    return [rs.bytes(int(rs.randint(1, 2000))) for _ in range(n)]


def test_recordio_round_trip_across_impls_and_packages(tmp_path):
    from paddle_tpu.runtime import recordio as jrecordio

    records = _records()
    port = str(tmp_path / "port.recordio")
    with recordio.Writer(port, chunk_records=50) as w:
        for r in records:
            w.write(r)
    assert list(recordio.Reader(port)) == records
    assert list(recordio._py_read(port)) == records
    assert list(jrecordio.Reader(port)) == records
    ref = str(tmp_path / "ref.recordio")
    with jrecordio.Writer(ref, chunk_records=50) as w:
        for r in records:
            w.write(r)
    assert open(ref, "rb").read() == open(port, "rb").read()  # byte for byte
    assert list(recordio.Reader(ref)) == records
    py = str(tmp_path / "py.recordio")
    pw = recordio._PyWriter(py, 50, 8 << 20)
    for r in records:
        pw.write(r)
    pw.close()
    assert list(recordio.Reader(py)) == records


def test_recordio_corrupt_chunk_skipped(tmp_path):
    path = str(tmp_path / "corrupt.recordio")
    with recordio.Writer(path, chunk_records=10) as w:
        for i in range(30):
            w.write(f"rec-{i:03d}".encode())
    raw = bytearray(open(path, "rb").read())
    raw[16 + 10 * (4 + 7) + 16 + 8] ^= 0xFF  # a byte of the second chunk's data
    open(path, "wb").write(bytes(raw))
    r = recordio.Reader(path)
    got = list(r)
    assert [g.decode() for g in got[:10]] == [f"rec-{i:03d}" for i in range(10)]
    assert len(got) == 20 and r.errors == 1
    box = [0]
    assert list(recordio._py_read(path, box)) == got and box[0] == 1


def test_recordio_oversized_chunk_header_is_corruption(tmp_path):
    path = str(tmp_path / "x.recordio")
    with recordio.Writer(path) as w:
        for i in range(5):
            w.write(f"rec{i}".encode())
    blob = bytearray(open(path, "rb").read())
    struct.pack_into("<I", blob, 8, 0xF0000000)
    open(path, "wb").write(bytes(blob))
    r = recordio.Reader(path)
    assert list(r) == [] and r.errors == 1


def test_convert_and_read_shards_across_packages(tmp_path):
    from paddle_tpu.runtime import recordio as jrecordio

    samples = [(i, float(i) * 0.5, f"s{i}") for i in range(100)]
    paths = recordio.convert(str(tmp_path / "port"), lambda: iter(samples), records_per_file=32)
    assert len(paths) == 4
    assert list(recordio.read_shards(paths)) == samples
    assert list(jrecordio.read_shards(paths)) == samples
    jpaths = jrecordio.convert(str(tmp_path / "ref"), lambda: iter(samples),
                               records_per_file=32)
    assert [os.path.basename(p) for p in jpaths] == [os.path.basename(p) for p in paths]
    assert list(recordio.read_shards(jpaths)) == samples


# -- the task master -----------------------------------------------------------


def test_master_lifecycle_timeout_failure():
    m = TaskMaster(timeout_s=0.15, failure_max=1)
    m.set_dataset(["a", "b", "c", "d"], chunks_per_task=2)
    t1, t2 = m.get_task(), m.get_task()
    assert t1[1] == ["a", "b"] and t2[1] == ["c", "d"]
    assert m.get_task() is None
    assert m.task_finished(t1[0])
    time.sleep(0.2)  # t2's lease expires: re-queued with one failure
    t2b = m.get_task()
    assert t2b[1] == ["c", "d"]
    assert m.task_failed(t2b[0])  # past failure_max: discarded
    assert m.get_task() == (TaskMaster.PASS_FINISHED, [])
    st = m.stats()
    assert st["done"] == 1 and st["discarded"] == 1
    assert m.pass_finished(start_next=True)
    st = m.stats()
    assert st["todo"] == 2 and st["pass"] == 1
    m.close()
    assert m.closed


def _drain(m):
    seen = []
    while True:
        got = m.get_task()
        if got is None or got[0] == m.PASS_FINISHED:
            return seen
        seen.append(tuple(got[1]))
        m.task_finished(got[0])


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_master_snapshot_restores_across_packages(tmp_path, writer, reader):
    from paddle_tpu.runtime.master import TaskMaster as JTaskMaster

    make = {"port": TaskMaster, "jax": JTaskMaster}
    snap = str(tmp_path / "master.snap")
    m = make[writer](timeout_s=60, failure_max=3)
    m.set_dataset([f"s{i}" for i in range(6)], chunks_per_task=2)
    leased = m.get_task()
    m.task_finished(m.get_task()[0])
    m.snapshot(snap)
    m.close()
    m2 = make[reader](timeout_s=60, failure_max=3)
    m2.restore(snap)
    st = m2.stats()
    assert st["done"] == 1 and st["pending"] == 0 and st["todo"] == 2
    assert tuple(leased[1]) in _drain(m2)  # the lost lease came back
    m2.close()


def test_master_restore_truncated_snapshot_preserves_state(tmp_path):
    snap, bad = str(tmp_path / "good.snap"), str(tmp_path / "bad.snap")
    m = TaskMaster(timeout_s=60, failure_max=3)
    m.set_dataset([f"s{i}" for i in range(6)], chunks_per_task=2)
    m.snapshot(snap)
    blob = open(snap, "rb").read()
    open(bad, "wb").write(blob[:len(blob) // 2])
    before = m.stats()
    assert before["todo"] == 3
    with pytest.raises(OSError):
        m.restore(bad)
    assert m.stats() == before
    assert m.get_task() is not None
    m.close()


# -- the native optimizer ------------------------------------------------------


def test_native_optimizer_matches_the_ports_optim():
    from paddle_tpu_torch.optim import SGD, Adam

    rs = np.random.RandomState(0)
    p0 = rs.randn(64).astype(np.float32)
    grads = [rs.randn(64).astype(np.float32) for _ in range(5)]
    for kind, kw, opt in [("sgd", {"learning_rate": 0.1, "momentum": 0.9},
                           SGD(learning_rate=0.1, momentum=0.9)),
                          ("adam", {"learning_rate": 0.05}, Adam(learning_rate=0.05))]:
        nat = NativeOptimizer(kind, **kw)
        p_nat = p0.copy()
        params = {"w": torch.from_numpy(p0.copy())}
        state = opt.init_state(params)
        for g in grads:
            nat.update(p_nat, g)
            opt.update({"w": torch.from_numpy(g)}, state, params, kw["learning_rate"])
        np.testing.assert_allclose(p_nat, params["w"].numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=kind)
        nat.close()


@pytest.mark.parametrize("kind,kw", [
    ("sgd", dict(learning_rate=0.1, momentum=0.9, nesterov=True, weight_decay=1e-3)),
    ("adagrad", dict(learning_rate=0.1, epsilon=1e-6)),
    ("adadelta", dict(learning_rate=1.0, rho=0.9, epsilon=1e-6)),
    ("adam", dict(learning_rate=0.05)),
    ("sgd", dict(learning_rate=1.0, lr_policy="linear", lr_decay_a=0.25, lr_decay_b=0.1)),
])
def test_native_optimizer_equals_jax_bit_for_bit(kind, kw):
    from paddle_tpu.runtime.optimizer import NativeOptimizer as JNativeOptimizer

    rs = np.random.RandomState(1)
    p0 = rs.randn(97).astype(np.float32)
    port, ref = NativeOptimizer(kind, **kw), JNativeOptimizer(kind, **kw)
    pa, pb = p0.copy(), p0.copy()
    for _ in range(6):
        g = rs.randn(97).astype(np.float32)
        port.update(pa, g)
        ref.update(pb, g)
        assert port.current_lr == ref.current_lr
    np.testing.assert_array_equal(pa, pb)
    assert port.serialize() == ref.serialize()


def test_native_optimizer_serialize_round_trip():
    rs = np.random.RandomState(1)
    p = rs.randn(32).astype(np.float32)
    a = NativeOptimizer("adam", learning_rate=0.01)
    for _ in range(3):
        a.update(p, rs.randn(32).astype(np.float32))
    b = NativeOptimizer("adam", learning_rate=0.01)
    b.deserialize(a.serialize())
    g = rs.randn(32).astype(np.float32)
    pa, pb = p.copy(), p.copy()
    a.update(pa, g)
    b.update(pb, g)
    np.testing.assert_array_equal(pa, pb)
    with pytest.raises(ValueError):
        NativeOptimizer("sgd").deserialize(a.serialize())
    with pytest.raises(TypeError):
        a.update(p.astype(np.float64), g)


def test_native_optimizer_linear_lr_policy():
    o = NativeOptimizer("sgd", learning_rate=1.0, lr_policy="linear", lr_decay_a=0.25,
                        lr_decay_b=0.1)
    p, g = np.zeros(4, np.float32), np.ones(4, np.float32)
    assert o.current_lr == 1.0
    o.update(p, g)
    assert abs(o.current_lr - 0.75) < 1e-9
    for _ in range(10):
        o.update(p, g)
    assert abs(o.current_lr - 0.1) < 1e-9
