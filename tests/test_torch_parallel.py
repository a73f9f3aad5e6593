"""Data parallelism in the port (`paddle_tpu_torch/parallel/`) against the
JAX package's `DataParallel` on its forced 8-device CPU mesh — the
counterpart of `tests/test_parallel.py`, on the `data` axis.

The port's ranks run as threads, each with its own gloo group over one
`HashStore` (`run_ranks`); the JAX side trains `DataParallel(make_mesh(
{"data": n}))`. Both start from the JAX package's initial parameters,
moved across by name, and see the same numpy batches. Tolerances: f32
parameters and costs rtol 1e-5 / atol 1e-6 (the reductions sum in another
order: the port sums each rank's rows, then the ranks); the rules table
and the mesh's errors exactly; the batch-norm net's moving statistics rtol
1e-5 / atol 1e-6; dropout's masks exactly (the trained parameters, which
a single different mask bit would move by ~1e-2, rtol 1e-5 / atol 1e-6).

The helpers here (`run_ranks`, `port_train`, `jax_train`, the nets and
the data) are shared by `test_torch_shard_update.py`,
`test_torch_collectives.py` and `test_torch_distributed.py`."""

from __future__ import annotations

import functools
import threading
import traceback
import types
import warnings

import numpy as np
import pytest
import torch
from torch.distributed import HashStore, PrefixStore

from paddle_tpu_torch.nn import costs as TC
from paddle_tpu_torch.nn import layers as TL
from paddle_tpu_torch.nn.graph import ParamAttr as TParamAttr
from paddle_tpu_torch.optim import optimizers as topt
from paddle_tpu_torch.parallel import DataParallel as TDataParallel
from paddle_tpu_torch.parallel import make_mesh as t_make_mesh
from paddle_tpu_torch.parallel import mesh as tmesh
from paddle_tpu_torch.parallel import rules as trules
from paddle_tpu_torch.trainer.events import EndPass
from paddle_tpu_torch.trainer.trainer import SGDTrainer as TTrainer

DIM, CLASSES = 16, 4
RTOL, ATOL = 1e-5, 1e-6


# -- the harness ---------------------------------------------------------------


def run_ranks(n, fn, timeout=120, axes=None):
    """fn(rank, mesh) in n threads, each rank with its own gloo group over
    one HashStore -> the n results; a rank's exception re-raises here. The
    mesh is {"data": n}, or `axes` over the n ranks."""
    store = HashStore()
    results, errors = [None] * n, []

    def main(r):
        try:
            group = tmesh.new_gloo_group(PrefixStore("dp", store), r, n, timeout_s=60)
            results[r] = fn(r, t_make_mesh(axes or {"data": n}, group=group, device="cpu"))
        except BaseException as e:  # handed to the test thread
            errors.append((r, e, traceback.format_exc()))

    threads = [threading.Thread(target=main, args=(r,), daemon=True) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    if errors:
        r, e, tb = errors[0]
        raise AssertionError(f"rank {r} failed:\n{tb}") from e
    return results


def data(n=96, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, DIM).astype(np.float32)
    y = (x.sum(-1) > 0).astype(np.int32) + 2 * (x[:, 0] > 0).astype(np.int32)
    return x, y


def reader(x, y, bs=32):
    def read():
        for i in range(0, len(x), bs):
            yield {"x": x[i:i + bs], "label": y[i:i + bs]}
    return read


def fc_net(pkg_layers, pkg_costs, attr=None, extra_layer=False):
    L, C = pkg_layers, pkg_costs
    x = L.Data("x", shape=(DIM,))
    lbl = L.Data("label", shape=())
    h = L.Fc(x, 48, act="relu", name="h", param_attr=attr)
    if extra_layer:
        h = L.Fc(h, 32, act="relu", name="h3")
    logits = L.Fc(h, CLASSES, act=None, name="out")
    return C.ClassificationCost(logits, lbl, name="cost")


def port_net(**kw):
    return fc_net(TL, TC, **kw)


def jax_net(**kw):
    from paddle_tpu.nn import costs as JC
    from paddle_tpu.nn import layers as JL

    return fc_net(JL, JC, **kw)


PORT_OPT = {
    "sgd": lambda: topt.SGD(learning_rate=0.125, momentum=0.5),
    "sgd_plain": lambda: topt.SGD(learning_rate=0.0625),
    "adam": lambda: topt.Adam(learning_rate=1e-3),
}


def jax_opt(name):
    from paddle_tpu.optim import SGD, Adam

    return {"sgd": lambda: SGD(learning_rate=0.125, momentum=0.5),
            "sgd_plain": lambda: SGD(learning_rate=0.0625),
            "adam": lambda: Adam(learning_rate=1e-3)}[name]()


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_np_tree(v) for v in tree)
    return np.array(tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree)


def result_of(tr, metrics):
    """What a test compares, read inside the rank (the canonical seams are
    collectives)."""
    opt = tr.updater.to_canonical(tr.state["opt"])
    return types.SimpleNamespace(
        params=_np_tree(tr.canonical_params()), slots=_np_tree(opt["slots"]),
        ef=_np_tree(opt.get("ef", {})), samples=int(tr.state["samples"]),
        metrics=metrics, trainer=tr)


def port_train(n, shard=False, comp=None, opt="sgd", init=None, passes=2, bs=32,
               n_samples=96, build=port_net, batches=None, train=True, **train_kw):
    """The port's trainer over n thread ranks (n = 0: no mesh) from `init`
    (the JAX package's parameters) -> rank 0's result, with `.ranks` the
    others'."""
    cost = build()
    x, y = data(n_samples)
    read = (lambda: iter(batches)) if batches is not None else reader(x, y, bs)

    def fn(r, mesh):
        dp = TDataParallel(mesh) if mesh is not None else None
        tr = TTrainer(cost, PORT_OPT[opt](), seed=5, device="cpu", parallel=dp,
                      shard_update=shard, grad_compression=comp)
        if init is not None:
            tr.init_state({"x": x[:bs], "label": y[:bs]})
            tr.load_params(init)
        metrics = []
        if train:
            tr.train(read, num_passes=passes, log_period=0,
                     event_handler=lambda e: metrics.append(e.metrics)
                     if isinstance(e, EndPass) else None, **train_kw)
        return result_of(tr, metrics)

    res = run_ranks(n, fn) if n else [fn(0, None)]
    out = res[0]
    out.ranks = res
    return out


@functools.lru_cache(maxsize=None)
def jax_train(n, shard=False, comp=None, opt="sgd", passes=2, bs=32, n_samples=96, k=1):
    """The JAX package's DataParallel run on n forced CPU devices ->
    (initial params, result); cached per configuration."""
    from paddle_tpu.nn.graph import reset_name_scope
    from paddle_tpu.parallel import DataParallel, make_mesh
    from paddle_tpu.trainer import SGDTrainer
    from paddle_tpu.trainer.events import EndPass as JEndPass

    reset_name_scope()
    cost = jax_net()
    dp = DataParallel(make_mesh({"data": n}))
    tr = SGDTrainer(cost, jax_opt(opt), parallel=dp, seed=5, shard_update=shard,
                    grad_compression=comp)
    x, y = data(n_samples)
    tr.init_state(dp.shard_batch({"x": x[:bs], "label": y[:bs]}))
    init = {k: np.asarray(v) for k, v in tr.updater.params_to_canonical(
        tr.state["params"]).items()}
    metrics = []
    tr.train(reader(x, y, bs), num_passes=passes, steps_per_dispatch=k,
             event_handler=lambda e: metrics.append(e.metrics)
             if isinstance(e, JEndPass) else None)
    opt_c = tr.updater.to_canonical(tr.state["opt"])
    res = types.SimpleNamespace(
        params={k: np.asarray(v) for k, v in
                tr.updater.params_to_canonical(tr.state["params"]).items()},
        slots={k: tuple(np.asarray(s) for s in ss) for k, ss in opt_c["slots"].items()},
        ef={k: np.asarray(v) for k, v in opt_c.get("ef", {}).items()},
        samples=int(tr.state["samples"]), metrics=metrics)
    return init, res


def assert_close(a, b, rtol=RTOL, atol=ATOL, what=""):
    assert set(a) == set(b), what
    for k in a:
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]), rtol=rtol,
                                   atol=atol, err_msg=f"{what}: {k}")


def assert_bitwise(a, b, what=""):
    assert set(a) == set(b), what
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert np.array_equal(x.view(np.uint32), y.view(np.uint32)), \
            f"{what}: {k} differs (max abs {np.abs(x - y).max()})"


# -- the mesh --------------------------------------------------------------------


def test_mesh_shapes_and_named_errors():
    meshes = run_ranks(2, lambda r, m: (m.axis_names, m.shape, m.rank, m.size, m.backend))
    assert meshes == [(("data",), {"data": 2}, r, 2, "gloo") for r in range(2)]
    one = t_make_mesh({"data": 1}, device="cpu")  # a one-rank group of its own
    assert (one.shape, one.size, one.rank, one.backend) == ({"data": 1}, 1, 0, "gloo")
    t = torch.ones(3)
    one.all_reduce_(t)
    assert t.tolist() == [1.0, 1.0, 1.0] and one.counts()["all_reduce"] == 1
    with pytest.raises(RuntimeError, match=r"parallel\.distributed\.initialize"):
        t_make_mesh({"data": 2}, device="cpu")
    # the model, seq and expert axes are ported: without a group they need
    # ranks, as a data axis of 2 does; over one they build (below)
    for axes in ({"data": 2, "model": 2}, {"data": 1, "seq": 2}, {"expert": 4}):
        with pytest.raises(RuntimeError, match=r"parallel\.distributed\.initialize"):
            t_make_mesh(axes, device="cpu")
    with pytest.raises(RuntimeError, match=r"parallel\.distributed\.initialize"):
        trules.make_tp_mesh(2)
    with pytest.raises(AssertionError, match="spans 4 ranks"):  # a rank's ValueError
        run_ranks(2, lambda r, m: m, axes={"data": 2, "model": 2})
    # {"data": 4, "model": 2} over 8 ranks: data outermost, as the JAX
    # package reshapes its devices; each axis' line of ranks is its group
    got = run_ranks(8, lambda r, m: (m.coords, m.axis_ranks("data"), m.axis_ranks("model"),
                                     m.all_reduce_(torch.ones(1), "model").item(),
                                     m.all_reduce_(torch.ones(1), "data").item(),
                                     m.counts("model")["all_reduce"]),
                    axes={"data": 4, "model": 2})
    for r, (coords, data_line, model_line, m_sum, d_sum, n_model) in enumerate(got):
        assert coords == {"data": r // 2, "model": r % 2}
        assert data_line == [r % 2 + 2 * i for i in range(4)]
        assert model_line == [r // 2 * 2, r // 2 * 2 + 1]
        assert (m_sum, d_sum, n_model) == (2.0, 4.0, 1)
    tp = run_ranks(2, lambda r, m: (trules.make_tp_mesh(2, group=m.group, device="cpu").shape))
    assert tp == [{"data": 1, "model": 2}] * 2
    with pytest.raises(ValueError, match="no axis"):
        tmesh.resize_mesh(one, "model", 2)
    with pytest.raises(ValueError, match="2 rank"):
        tmesh.resize_mesh(one, "data", 2)


def test_one_rank_mesh_collectives_run_on_its_group():
    """On a one-rank world every named axis is the whole group, so its
    collectives are issued (the card's world-1 NCCL step graph holds them);
    an axis of extent 1 inside a larger world has no group and issues
    none."""
    one = t_make_mesh({"data": 1}, device="cpu")
    assert one.axis_group("data") is one.group and one.axis_group("model") is None
    issued = []

    class Spy:
        def __getattr__(self, name):
            issued.append(name)
            return getattr(one.group, name)

    one._axis_groups["data"] = Spy()
    x = torch.arange(6.0).reshape(1, 6)
    one.all_reduce_(x.clone())
    assert one.reduce_scatter(x).tolist() == x.tolist()
    assert one.all_gather(x).tolist() == x.tolist()
    assert issued == ["allreduce", "_reduce_scatter_base", "_allgather_base"]
    got = run_ranks(2, lambda r, m: (m.axis_group("data") is None,
                                     m.axis_group("model") is m.group),
                    axes={"data": 1, "model": 2})
    assert got == [(True, True)] * 2


# -- DataParallel against single-device training ------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_dp_matches_single_device(n):
    """The port's n-rank DataParallel run equals the JAX package's
    single-device run (and its n-device one) from the same parameters."""
    init, single = jax_train(1)
    _, mesh = jax_train(n)
    got = port_train(n, init=init)
    assert_close(got.params, single.params, what=f"port n={n} vs JAX single")
    assert_close(got.params, mesh.params, what=f"port n={n} vs JAX n={n}")
    np.testing.assert_allclose(got.metrics[-1]["avg_cost"], mesh.metrics[-1]["avg_cost"],
                               rtol=RTOL, atol=ATOL)
    for other in got.ranks[1:]:  # replicated: every rank holds the same values
        assert_bitwise(got.params, other.params, "ranks")


def test_param_sharding_resolves_through_the_rules_like_jax():
    from paddle_tpu.parallel import rules as jrules
    from paddle_tpu.parallel.mesh import make_mesh as j_make_mesh

    assert trules.DEFAULT_RULES == jrules.DEFAULT_RULES
    jmesh = j_make_mesh({"data": 4})
    port = trules.ShardingRules()
    ref = jrules.ShardingRules()
    import importlib

    from paddle_tpu.models.resnet import BN_AXES, CONV_W_AXES

    tresnet = importlib.import_module("paddle_tpu_torch.models.resnet")

    assert (tresnet.CONV_W_AXES, tresnet.BN_AXES) == (CONV_W_AXES, BN_AXES)

    def check(tmesh_):
        for axes, ndim in [(CONV_W_AXES, 4), (BN_AXES, 1), (("vocab", "embed"), 2),
                           (("embed", "vocab"), 2), (("batch", None), 2), (("heads",), 3),
                           (("data",), 2), ((None, "model"), 2), (("expert",), 2)]:
            want = tuple(ref.spec_for(axes, jmesh, ndim=ndim, param="p"))
            assert port.spec_for(axes, tmesh_, ndim=ndim, param="p") == want, axes
        with pytest.raises(KeyError, match="'p'"):
            port.spec_for(("heds",), tmesh_, param="p")
        with pytest.raises(ValueError, match="rank"):
            port.spec_for(("embed", "mlp"), tmesh_, ndim=1, param="p")
        dp = TDataParallel(tmesh_, param_attrs={
            "w": TParamAttr(logical_axes=CONV_W_AXES), "b": TParamAttr()})
        assert dp.param_sharding("w", 4) == (None,) * 4
        assert dp.param_sharding("b", 1) == (None,)
        return True

    assert run_ranks(4, lambda r, m: check(m)) == [True] * 4


def test_legacy_sharding_shim_warns_exactly_once_per_process(monkeypatch):
    monkeypatch.setattr(trules, "_legacy_sharding_warned", False)
    dp = TDataParallel(t_make_mesh({"data": 1}, device="cpu"), param_attrs={
        f"p{i}": TParamAttr(sharding=(None, "model")) for i in range(3)})
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i in range(3):
            assert dp.param_sharding(f"p{i}", 2) == (None, None)
    dep = [w for w in caught if issubclass(w.category, DeprecationWarning)]
    assert len(dep) == 1 and "p0" in str(dep[0].message)


# -- batch norm over the global batch, dropout on the global bits -------------


def _bn_net(L, C, ParamAttr, dropout=0.0):
    """A ResNet-style block: conv -> batch norm -> relu, a second conv_bn, a
    residual add, global pooling and a classifier."""
    img = L.Data("image", shape=(6, 6, 3))
    lbl = L.Data("label", shape=())
    a = L.BatchNorm(L.Conv2D(img, 8, 3, padding=1, bias=False, name="a.conv"), act="relu",
                    name="a.bn")
    b = L.BatchNorm(L.Conv2D(a, 8, 3, padding=1, bias=False, name="b.conv"), name="b.bn")
    h = L.Addto([a, b], act="relu", name="add")
    h = L.GlobalPool(h, name="gap")
    if dropout:
        h = L.Dropout(h, dropout, name="drop")
    logits = L.Fc(h, CLASSES, act=None, name="logits")
    return C.ClassificationCost(logits, lbl, name="cost")


def _image_batches(n_batches=3, bs=16, seed=3):
    rs = np.random.RandomState(seed)
    return [{"image": rs.randn(bs, 6, 6, 3).astype(np.float32),
             "label": rs.randint(0, CLASSES, bs).astype(np.int32)}
            for _ in range(n_batches)]


def _jax_image_run(n, dropout=0.0, batches=None):
    from paddle_tpu.nn import costs as JC
    from paddle_tpu.nn import layers as JL
    from paddle_tpu.nn.graph import ParamAttr, reset_name_scope
    from paddle_tpu.optim import SGD
    from paddle_tpu.parallel import DataParallel, make_mesh
    from paddle_tpu.trainer import SGDTrainer

    reset_name_scope()
    cost = _bn_net(JL, JC, ParamAttr, dropout)
    dp = DataParallel(make_mesh({"data": n})) if n else None
    tr = SGDTrainer(cost, SGD(learning_rate=0.125, momentum=0.5), parallel=dp, seed=7)
    b0 = batches[0]
    tr.init_state(dp.shard_batch(b0) if dp else b0)
    init = {k: np.asarray(v) for k, v in tr.state["params"].items()}
    states0 = {k: np.asarray(v) for k, v in tr.state["states"].items()}
    tr.train(lambda: iter(batches), num_passes=1)
    return init, states0, tr


def _port_image_run(n, init, states0, dropout=0.0, batches=None):
    cost = _bn_net(TL, TC, TParamAttr, dropout)

    def fn(r, mesh):
        tr = TTrainer(cost, topt.SGD(learning_rate=0.125, momentum=0.5), seed=7,
                      device="cpu", parallel=TDataParallel(mesh))
        tr.init_state(batches[0])
        tr.load_params(init)
        tr.load_states(states0)
        tr.train(lambda: iter(batches), num_passes=1, log_period=0)
        return (_np_tree(tr.canonical_params()), _np_tree(tr.state["states"]))

    return run_ranks(n, fn)


def test_batch_norm_moving_statistics_are_the_global_batch_ones():
    """n = 4: the moving statistics equal the JAX package's on its 4-device
    mesh (its jit reduces the batch-sharded activations over the global
    batch) and a single device's; every rank holds the same."""
    batches = _image_batches()
    init, states0, jtr = _jax_image_run(4, batches=batches)
    _, _, single = _jax_image_run(0, batches=batches)
    ranks = _port_image_run(4, init, states0, batches=batches)
    ref_states = {k: np.asarray(v) for k, v in jtr.state["states"].items()}
    params, states = ranks[0]
    assert_close(states, ref_states, what="moving statistics vs JAX n=4")
    assert_close(states, {k: np.asarray(v) for k, v in single.state["states"].items()},
                 what="moving statistics vs one device")
    assert_close(params, {k: np.asarray(v) for k, v in jtr.state["params"].items()},
                 what="params vs JAX n=4")
    for p, s in ranks[1:]:
        assert_bitwise(states, s, "ranks' moving statistics")


def test_dropout_masks_equal_the_jax_package_at_n2():
    """n = 2: each rank draws the global batch's threefry bits and keeps its
    rows, so the masks (and so the trained parameters) are the JAX
    package's."""
    batches = _image_batches(n_batches=2, bs=8, seed=5)
    init, states0, jtr = _jax_image_run(2, dropout=0.5, batches=batches)
    ranks = _port_image_run(2, init, states0, dropout=0.5, batches=batches)
    ref = {k: np.asarray(v) for k, v in jtr.state["params"].items()}
    assert_close(ranks[0][0], ref, what="dropout params vs JAX n=2")
    moved = max(float(np.abs(ranks[0][0][k] - init[k]).max()) for k in ref)
    assert moved > 1e-3  # the run trained through the masks
