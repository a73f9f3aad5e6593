"""The port's replicated and ZeRO-1/2/3 updaters and compressed
collectives (`paddle_tpu_torch/parallel/{updaters,compression}.py`) against
the JAX package's — the counterpart of `tests/test_shard_update.py`, case
for case on the `data` axis.

Ranks are threads over gloo (`test_torch_parallel.run_ranks`); every run
starts from the JAX package's initial parameters. Tolerances:
  * port vs JAX, f32 (`none`): parameters and slots rtol 1e-5 / atol 1e-6
    (Adam's slots rtol 1e-4 / atol 1e-7, as the JAX test holds its own);
  * the port's ZeRO modes vs its replicated updater, SGD at a power-of-two
    lr: bitwise at n = 1 and 2 (the same elementwise update on each
    element; two ranks' partial sums add up the same in any order); at n = 4
    rtol 1e-6 / atol 1e-7, because gloo's all-reduce and its reduce-scatter
    associate four ranks' partial gradients in different orders (1 ulp
    apart after a step, measured; the JAX package reduces in one global sum
    and is bitwise);
  * compressed modes vs the JAX package's same mode: at n = 1 the same
    arithmetic, rtol 1e-5 / atol 1e-6 (bf16) and 1e-4 / 1e-5 (int8: a
    rounding step of an f32 input 1 ulp away moves one int8 level); at
    n > 1 the port quantizes each rank's share before the crossing where
    the JAX package quantizes the reduced gradient (compression.py), so the
    JAX test's own bounds against the replicated run hold: bf16 rtol 0.05 /
    atol 5e-3, int8 rtol 0.2 / atol 5e-2;
  * checkpoints: exact (bitwise) across modes, world sizes and packages;
  * the byte model: equal to the JAX package's numbers."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import stats as tstats
from paddle_tpu_torch.nn.graph import SAMPLE_COUNT_KEY, SAMPLE_MASK_KEY
from paddle_tpu_torch.nn.graph import ParamAttr as TParamAttr
from paddle_tpu_torch.parallel import DataParallel as TDataParallel
from paddle_tpu_torch.parallel import compression as tcomp
from paddle_tpu_torch.parallel import updaters as tupd
from paddle_tpu_torch.trainer.trainer import SGDTrainer as TTrainer

from test_torch_parallel import (
    ATOL, PORT_OPT, RTOL, _np_tree, assert_bitwise, assert_close, data, jax_train,
    port_net, port_train, reader, result_of, run_ranks,
)

COMP_TOL = {("bf16", 1): (1e-5, 1e-6), ("int8", 1): (1e-4, 1e-5),
            ("bf16", 2): (0.05, 5e-3), ("int8", 2): (0.2, 5e-2),
            ("bf16", 4): (0.05, 5e-3), ("int8", 4): (0.2, 5e-2)}


def _jax_mode(shard):
    # zero2 at K = 1 is zero1's arithmetic in the JAX package (its test pins
    # that bitwise): one JAX run serves both
    return "zero1" if shard == "zero2" else shard


# -- the grid against the JAX package ---------------------------------------


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("shard,comp", [(False, None)] + [
    (m, c) for m in ("zero1", "zero2", "zero3") for c in ("none", "bf16", "int8")])
def test_updater_matches_jax(n, shard, comp):
    """Parameters and optimizer slots after two passes equal the JAX
    package's DataParallel run in the same mode and compression."""
    jcomp = None if comp in (None, "none") else comp
    init, _ = jax_train(n)
    _, ref = (jax_train(n) if jcomp is None else jax_train(n, _jax_mode(shard), jcomp))
    got = port_train(n, shard, comp, init=init)
    rtol, atol = (RTOL, ATOL) if jcomp is None else COMP_TOL[(jcomp, n)]
    assert_close(got.params, ref.params, rtol, atol, f"{shard}/{comp} n={n}")
    for k, slots in ref.slots.items():
        for a, b in zip(got.slots[k], slots):
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
    for other in got.ranks[1:]:
        assert_bitwise(got.params, other.params, "ranks")


def _same(a, b, n, what):
    if n <= 2:
        assert_bitwise(a, b, what)
        return
    assert_close(a, b, 1e-6, 1e-7, what)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sgd_bitwise_equal_replicated(n):
    init, _ = jax_train(n)
    rep = port_train(n, False, init=init)
    for mode in ("zero1", "zero2", "zero3"):
        got = port_train(n, mode, init=init)
        _same(rep.params, got.params, n, f"{mode} n={n}")
        for k in rep.slots:
            _same(dict(enumerate(rep.slots[k])), dict(enumerate(got.slots[k])), n, k)


def test_sgd_plain_bitwise_equal():
    init, ref = jax_train(4, opt="sgd_plain")
    rep = port_train(2, False, opt="sgd_plain", init=init)
    for mode in ("zero1", "zero3"):
        assert_bitwise(rep.params, port_train(2, mode, opt="sgd_plain", init=init).params,
                       f"plain SGD {mode}")
    assert_close(rep.params, ref.params, what="plain SGD vs JAX")


@pytest.mark.parametrize("mode", ["zero1", "zero3"])
def test_adam_allclose_replicated_and_jax(mode):
    init, ref = jax_train(4, opt="adam")
    rep = port_train(4, False, opt="adam", init=init)
    got = port_train(4, mode, opt="adam", init=init)
    for other in (rep, ref):
        assert_close(got.params, other.params, 1e-5, 1e-7, f"Adam {mode}")
        for k, slots in other.slots.items():
            for a, b in zip(got.slots[k], slots):
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-7)


def test_opt_state_bytes_shrink_n_times_and_bytes_model_equals_jax():
    init, _ = jax_train(4)
    rep = port_train(4, False, init=init, passes=1)
    sh = port_train(4, "zero1", init=init, passes=1)
    rep_bytes = rep.metrics[-1]["opt_state_bytes"]
    sh_bytes = sh.metrics[-1]["opt_state_bytes"]
    assert rep_bytes >= 3.2 * sh_bytes, (rep_bytes, sh_bytes)
    assert sh.metrics[-1]["collective_bytes_per_step"] == \
        rep.metrics[-1]["collective_bytes_per_step"]
    for mode, comp in [(False, None), ("zero1", None), ("zero1", "bf16"),
                       ("zero2", "int8"), ("zero3", None), ("zero3", "int8")]:
        _, jref = jax_train(4, _jax_mode(mode) if mode != "zero2" else "zero2", comp,
                            passes=1)
        got = port_train(4, mode, comp, init=init, passes=1)
        assert got.metrics[-1]["collective_bytes_per_step"] == \
            jref.metrics[-1]["collective_bytes_per_step"], (mode, comp)
        assert got.metrics[-1].get("collective_bytes_detail") == \
            jref.metrics[-1].get("collective_bytes_detail"), (mode, comp)


# -- compression ---------------------------------------------------------------


def test_int8_block_quantize_matches_jax():
    import jax.numpy as jnp
    from paddle_tpu.parallel import compression as jcomp

    rs = np.random.RandomState(0)
    x = rs.randn(4, 2 * tcomp.BLOCK).astype(np.float32)
    x[1, :tcomp.BLOCK] = 0.0  # an all-zero block
    q, scale = tcomp._block_quantize(torch.from_numpy(x))
    jq, jscale = jcomp._block_quantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and tuple(scale.shape) == (4, 2)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    err = np.abs(tcomp._block_dequantize(q, scale).numpy() - x)
    assert err.max() <= float(scale.max()) * 0.51
    with pytest.raises(ValueError, match="grad_compression"):
        tcomp.make("fp4")


@pytest.mark.parametrize("mode", ["zero1", "zero3"])
def test_int8_error_feedback_residual_carried(mode):
    init, _ = jax_train(2)
    got = port_train(2, mode, "int8", init=init, passes=1)
    assert got.ef and any(np.abs(e).max() > 0 for e in got.ef.values())
    for k, e in got.ef.items():
        assert e.shape == got.params[k].shape  # the canonical residual


# -- the padded trailing batch -------------------------------------------------


def test_trailing_batch_padded_not_dropped():
    """90 samples: batches 32, 32, 26; 26 % 4 != 0 pads to 28."""
    init, _ = jax_train(4)
    before = tstats.DATA_EVENTS.get("padded_batches")
    got = port_train(4, False, init=init, passes=1, n_samples=90)
    assert tstats.DATA_EVENTS.get("padded_batches") == before + 4  # once a rank
    m = got.metrics[-1]
    assert m["padded_batches"] >= 1 and m["batches"] == 3
    assert got.samples == 90  # real rows only


@pytest.mark.parametrize("mode", [False, "zero3"])
def test_padded_cost_matches_unsharded(mode):
    """The padded trailing batch's masked cost and gradients are the
    unpadded batch's: pass cost and parameters equal a single device's
    (the JAX package's, and the port's without a mesh)."""
    init, jsingle = jax_train(1, passes=1, n_samples=90)
    got = port_train(4, mode, init=init, passes=1, n_samples=90)
    plain = port_train(0, init=init, passes=1, n_samples=90)
    np.testing.assert_allclose(got.metrics[-1]["avg_cost"],
                               jsingle.metrics[-1]["avg_cost"], rtol=2e-5, atol=1e-7)
    assert_close(got.params, jsingle.params, what="padded vs JAX single")
    assert_close(got.params, plain.params, what="padded vs port single")


def test_prefetcher_pads_trailing_batch():
    from paddle_tpu_torch.data.pipeline import DevicePrefetcher

    init, _ = jax_train(4)
    x, y = data(90)
    cost = port_net()

    def fn(r, mesh):
        dp = TDataParallel(mesh)
        before = tstats.DATA_EVENTS.get("padded_batches")
        batches = list(DevicePrefetcher(reader(x, y), parallel=dp, prefetch_depth=2)())
        grew = tstats.DATA_EVENTS.get("padded_batches") - before
        last = batches[-1]
        assert dp.is_sharded_batch(last) and last["x"].shape[0] == 7  # 28 / 4
        mask = last[SAMPLE_MASK_KEY].numpy()
        assert float(last[SAMPLE_COUNT_KEY][0]) == 26.0
        tr = TTrainer(cost, PORT_OPT["sgd"](), seed=5, device="cpu", parallel=dp)
        tr.init_state({"x": x[:32], "label": y[:32]})
        tr.load_params(init)
        tr.train(DevicePrefetcher(reader(x, y), parallel=dp), num_passes=1, log_period=0)
        return grew, mask, int(tr.state["samples"]), _np_tree(tr.canonical_params())

    out = run_ranks(4, fn)
    assert all(g >= 1 for g, *_ in out)
    masks = np.concatenate([m for _, m, _, _ in out])
    assert masks.shape == (28,) and masks.sum() == 26  # the rank's rows of the mask
    assert [s for _, _, s, _ in out] == [90] * 4
    plain = port_train(4, False, init=init, passes=1, n_samples=90)
    assert_bitwise(out[0][3], plain.params, "prefetched vs placed")


def test_struct_cost_masked_mean_matches_jax():
    """The structured costs' mean honours the mask like the JAX package's
    `_mean_over_examples`: padded rows drop out, a per-timestep flattening
    repeats the mask, an undividable layout keeps the plain mean."""
    import jax.numpy as jnp
    from paddle_tpu.nn.graph import Context as JContext
    from paddle_tpu.nn.struct_costs import _mean_over_examples as jmean

    from paddle_tpu_torch.nn.graph import Context
    from paddle_tpu_torch.nn.struct_costs import _mean_over_examples

    ctx = Context("apply", {})
    jctx = JContext("apply", {}, {}, None, train=True)
    vecs = [[1.0, 2.0, 3.0, 99.0], [1.0, 1.0, 2.0, 2.0, 3.0, 3.0, 99.0, 99.0],
            [1.0, 2.0, 3.0]]
    assert float(_mean_over_examples(ctx, torch.tensor(vecs[0]))) == \
        pytest.approx(float(jmean(jctx, jnp.asarray(vecs[0]))))
    ctx.sample_mask = torch.tensor([1.0, 1.0, 1.0, 0.0])
    jctx.sample_mask = jnp.asarray([1.0, 1.0, 1.0, 0.0])
    for v in vecs:
        assert float(_mean_over_examples(ctx, torch.tensor(v))) == \
            pytest.approx(float(jmean(jctx, jnp.asarray(v))), rel=1e-7), v
    assert float(_mean_over_examples(ctx, torch.tensor(vecs[0]))) == pytest.approx(2.0)


def test_pad_batch_helper():
    dp = TDataParallel(run_ranks(1, lambda r, m: m)[0])
    dp.mesh.shape["data"] = 4  # the helper reads only the axis' extent
    batch = {"x": np.arange(12, dtype=np.float32).reshape(6, 2),
             "label": np.arange(6, dtype=np.int32)}
    padded, n_pad = dp.pad_batch(batch)
    assert n_pad == 2
    assert padded["x"].shape == (8, 2) and padded["label"].shape == (8,)
    np.testing.assert_array_equal(padded["x"][6:], [[10, 11], [10, 11]])
    np.testing.assert_array_equal(padded[SAMPLE_MASK_KEY], [1, 1, 1, 1, 1, 1, 0, 0])
    already, n = dp.pad_batch({"x": np.zeros((8, 2), np.float32)})
    assert n == 0 and SAMPLE_MASK_KEY not in already
    # re-padding extends the mask with zero rows
    again, _ = dp.pad_batch({**{k: v[:7] for k, v in padded.items()}})
    np.testing.assert_array_equal(again[SAMPLE_MASK_KEY], [1, 1, 1, 1, 1, 1, 0, 0])


# -- checkpoints across layouts, world sizes and packages -----------------------


def _save_then_resume(tmp_path, n_save, save_mode, n_load, load_mode, opt="sgd"):
    """A pass saved by one layout, two passes resumed by another, and the
    straight two-pass run of the loading layout."""
    init, _ = jax_train(max(n_save, n_load), opt=opt)
    port_train(n_save, save_mode, opt=opt, init=init, passes=1, save_dir=str(tmp_path))
    resumed = port_train(n_load, load_mode, opt=opt, init=init, passes=2,
                         save_dir=str(tmp_path), auto_resume=True)
    straight = port_train(n_load, load_mode, opt=opt, init=init, passes=2)
    return resumed, straight


@pytest.mark.parametrize("save_mode,load_mode", [
    (False, "zero1"), ("zero1", False), ("zero3", False), (False, "zero3"),
    ("zero1", "zero3"), ("zero3", "zero2"), ("zero2", "zero3")])
def test_checkpoint_roundtrip_across_zero_modes(tmp_path, save_mode, load_mode):
    resumed, straight = _save_then_resume(tmp_path, 2, save_mode, 2, load_mode)
    assert_bitwise(straight.params, resumed.params, f"{save_mode}->{load_mode}")
    for k, slots in straight.slots.items():
        for a, b in zip(slots, resumed.slots[k]):
            assert np.array_equal(a, b), k


def test_checkpoint_roundtrip_adam_moments(tmp_path):
    resumed, straight = _save_then_resume(tmp_path, 4, "zero1", 4, False, opt="adam")
    assert_close(straight.params, resumed.params, 1e-5, 1e-7)
    for k, slots in straight.slots.items():
        for a, b in zip(slots, resumed.slots[k]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-7)


def test_checkpoint_roundtrip_async_sharded(tmp_path):
    init, _ = jax_train(4)
    port_train(4, "zero1", init=init, passes=1, save_dir=str(tmp_path),
               async_checkpoint=True)
    resumed = port_train(4, "zero1", init=init, passes=2, save_dir=str(tmp_path),
                         auto_resume=True, async_checkpoint=True)
    straight = port_train(4, "zero1", init=init, passes=2)
    assert_bitwise(straight.params, resumed.params, "async sharded resume")


@pytest.mark.parametrize("mode", ["zero1", "zero3"])
def test_cross_world_size_load_is_exact_and_records_world(tmp_path, mode):
    from paddle_tpu_torch.trainer import checkpoint as ckpt

    init, _ = jax_train(4)
    saved = port_train(2, mode, init=init, passes=1, n_samples=64, save_dir=str(tmp_path))
    assert ckpt.pass_manifest(str(tmp_path), 0)["extra"]["world_size"] == 2
    x, y = data(64)
    cost = port_net()

    def fn(r, mesh):
        tr = TTrainer(cost, PORT_OPT["sgd"](), seed=5, device="cpu",
                      parallel=TDataParallel(mesh), shard_update=mode)
        tr.init_state({"x": x[:32], "label": y[:32]})
        tr.load(str(tmp_path), 0)
        return result_of(tr, [])

    loaded = run_ranks(4, fn)[0]
    assert_bitwise(saved.params, loaded.params, f"{mode} 2->4")
    for k, slots in saved.slots.items():
        for a, b in zip(slots, loaded.slots[k]):
            assert np.array_equal(a, b), k


def test_jax_zero1_checkpoint_resumes_in_port_zero3_and_back(tmp_path):
    """A JAX ZeRO-1 pass directory resumes in the port's zero3 on 2 ranks;
    the port's save of that resumed run loads back into a JAX ZeRO-1
    trainer; values exact both ways."""
    from paddle_tpu.nn.graph import reset_name_scope
    from paddle_tpu.optim import SGD
    from paddle_tpu.parallel import DataParallel, make_mesh
    from paddle_tpu.trainer import SGDTrainer

    from test_torch_parallel import jax_net

    x, y = data(64)
    reset_name_scope()
    jdp = DataParallel(make_mesh({"data": 4}))
    jtr = SGDTrainer(jax_net(), SGD(learning_rate=0.125, momentum=0.5), parallel=jdp,
                     seed=5, shard_update="zero1")
    jtr.train(reader(x, y), num_passes=1, save_dir=str(tmp_path / "jax"))
    jtr.checkpoint_wait()
    jparams = {k: np.asarray(v) for k, v in jtr.state["params"].items()}
    jslots = {k: [np.asarray(s) for s in ss] for k, ss in
              jtr.updater.to_canonical(jtr.state["opt"])["slots"].items()}
    cost = port_net()

    def fn(r, mesh):
        tr = TTrainer(cost, PORT_OPT["sgd"](), seed=5, device="cpu",
                      parallel=TDataParallel(mesh), shard_update="zero3")
        tr.init_state({"x": x[:32], "label": y[:32]})
        tr.load(str(tmp_path / "jax"), 0)
        res = result_of(tr, [])
        tr.save(str(tmp_path / "port"), 0)
        tr.checkpoint_wait()
        return res

    got = run_ranks(2, fn)[0]
    assert_bitwise(jparams, got.params, "JAX zero1 -> port zero3")
    for k, ss in jslots.items():
        for a, b in zip(ss, got.slots[k]):
            assert np.array_equal(a, b), k
    reset_name_scope()
    back = SGDTrainer(jax_net(), SGD(learning_rate=0.125, momentum=0.5),
                      parallel=DataParallel(make_mesh({"data": 4})), seed=5,
                      shard_update="zero1")
    back.init_state(back.parallel.shard_batch({"x": x[:32], "label": y[:32]}))
    back.load(str(tmp_path / "port"), 0)
    assert_bitwise(jparams, {k: np.asarray(v) for k, v in back.state["params"].items()},
                   "port zero3 -> JAX zero1")


def _raw_opt_checkpoint(tmp_path, opt_tree):
    from paddle_tpu_torch.trainer import checkpoint as ckpt

    init, _ = jax_train(4)
    x, y = data(64)
    params = {k: v for k, v in init.items()}
    ckpt.save_pass(str(tmp_path), 0, params, {}, opt_tree,
                   extra_meta={"samples": 64, "world_size": 4})
    cost = port_net()

    def fn(r, mesh):
        tr = TTrainer(cost, PORT_OPT["sgd"](), seed=5, device="cpu",
                      parallel=TDataParallel(mesh), shard_update=True)
        tr.init_state({"x": x[:32], "label": y[:32]})
        with pytest.raises(ValueError) as ei:
            tr.load(str(tmp_path), 0)
        return str(ei.value)

    return run_ranks(2, fn)[0]


def test_mismatched_world_size_opt_state_fails_loudly(tmp_path):
    """A raw per-rank opt tree (flat [1, chunk] rows of a 4-rank run, not
    the canonical layout) fails the resume naming shapes and world sizes."""
    init, _ = jax_train(4)
    raw = {}

    def fn(r, mesh):
        tr = TTrainer(port_net(), PORT_OPT["sgd"](), seed=5, device="cpu",
                      parallel=TDataParallel(mesh), shard_update=True)
        tr.init_state({"x": data(32)[0], "label": data(32)[1]})
        return {f"opt/slots/{k}/{i}": s.numpy().copy()
                for k, ss in tr.state["opt"]["slots"].items() for i, s in enumerate(ss)}

    raw = run_ranks(4, fn)[0]
    raw["opt/t"] = np.zeros((), np.int32)
    msg = _raw_opt_checkpoint(tmp_path, raw)
    assert "expected" in msg and "found" in msg
    assert "world_size=4" in msg and "world_size=2" in msg
    assert "to_canonical" in msg


def test_disjoint_key_opt_state_fails_loudly(tmp_path):
    msg = _raw_opt_checkpoint(tmp_path, {"alien_slot": np.zeros(3, np.float32)})
    assert "no entry for" in msg
    assert "world_size=4" in msg and "world_size=2" in msg
    assert "to_canonical" in msg


def test_optimizer_structure_growth_still_resumes(tmp_path):
    """A checkpoint saved before momentum was on resumes: the new slots start
    fresh with a warning, the parameters restore."""
    init, _ = jax_train(1)
    x, y = data(64)
    a = TTrainer(port_net(), PORT_OPT["sgd_plain"](), seed=5, device="cpu")
    a.train(reader(x, y), num_passes=1, log_period=0)
    a.save(str(tmp_path), 0)
    b = TTrainer(port_net(), PORT_OPT["sgd"](), seed=6, device="cpu")
    b.init_state({"x": x[:32], "label": y[:32]})
    b.load(str(tmp_path), 0)
    assert_bitwise(_np_tree(a.state["params"]), _np_tree(b.state["params"]))


# -- composition: K-step dispatch, the guard, zero2's window -------------------


@pytest.mark.parametrize("mode", ["zero1", "zero3"])
def test_k_step_dispatch_composes(mode):
    init, _ = jax_train(4)
    p1 = port_train(4, mode, init=init, passes=1, steps_per_dispatch=1)
    p3 = port_train(4, mode, init=init, passes=1, steps_per_dispatch=3)
    assert_bitwise(p1.params, p3.params, f"K-fused {mode}")


@pytest.mark.parametrize("mode", ["zero1", "zero3"])
def test_divergence_guard_reverts_on_every_rank(mode):
    """A poisoned batch: the guard reverts parameters and the flat slots on
    every rank; the clean batches alone decide the result."""
    init, _ = jax_train(4)
    x, y = data(96)
    batches = [{"x": x[i:i + 32].copy(), "label": y[i:i + 32].copy()}
               for i in range(0, 96, 32)]
    poisoned = batches[:1] + [{"x": batches[0]["x"] * np.float32("nan"),
                               "label": batches[0]["label"]}] + batches[1:]
    before = tstats.FT_EVENTS.get("divergence")
    runs = [_guarded(4, mode, init, b) for b in (batches, poisoned)]
    assert tstats.FT_EVENTS.get("divergence") >= before + 4  # one a rank
    clean, dirty = runs
    assert_bitwise(clean.params, dirty.params, f"guarded {mode}")
    for k, slots in clean.slots.items():
        for a, b in zip(slots, dirty.slots[k]):
            assert np.array_equal(a, b), k
    for other in dirty.ranks[1:]:
        assert_bitwise(dirty.params, other.params, "ranks")


def _guarded(n, mode, init, batches, k=1):
    x, y = data(96)
    cost = port_net()

    def fn(r, mesh):
        tr = TTrainer(cost, PORT_OPT["sgd"](), seed=5, device="cpu",
                      parallel=TDataParallel(mesh), shard_update=mode,
                      divergence_policy="skip_batch", guard_check_every=1)
        tr.init_state({"x": x[:32], "label": y[:32]})
        tr.load_params(init)
        metrics = []
        tr.train(lambda: iter(batches), num_passes=1, log_period=0, steps_per_dispatch=k,
                 event_handler=lambda e: metrics.append(e.metrics)
                 if hasattr(e, "metrics") and "divergence_events" in e.metrics else None)
        return result_of(tr, metrics)

    res = run_ranks(n, fn)
    res[0].ranks = res
    return res[0]


def test_zero2_fused_window_is_gradient_accumulation():
    """zero2 at K = 3: one update on the window's mean gradient, as the JAX
    package's zero2 window and as one 96-row batch under zero1."""
    init, _ = jax_train(4)
    _, jref = jax_train(4, "zero2", passes=1, k=3)
    z2 = port_train(4, "zero2", init=init, passes=1, steps_per_dispatch=3)
    big = port_train(4, "zero1", init=init, passes=1, bs=96)
    assert_close(z2.params, big.params, 1e-5, 1e-7, "zero2 window vs one big batch")
    assert_close(z2.params, jref.params, what="zero2 window vs JAX")
    assert z2.samples == 96


def test_zero2_remainder_runs_single_updates():
    init, _ = jax_train(4)
    rem = port_train(4, "zero2", init=init, passes=1, steps_per_dispatch=4)
    z1 = port_train(4, "zero1", init=init, passes=1)
    assert_bitwise(z1.params, rem.params, "zero2 remainder")


def test_zero2_poisoned_window_reverts_and_counts_k():
    init, _ = jax_train(4)
    x, y = data(96)
    x[40] = np.float32("nan")  # inside the one K = 3 window
    batches = [{"x": x[i:i + 32], "label": y[i:i + 32]} for i in range(0, 96, 32)]
    got = _guarded(4, "zero2", init, batches, k=3)
    assert got.metrics[-1]["divergence_events"] == 3
    assert got.metrics[-1]["batches"] == 0
    assert_bitwise(init, got.params, "reverted window")


# -- API validation and the flat geometry --------------------------------------


def test_api_validation():
    cost = port_net()
    with pytest.raises(ValueError, match="DataParallel"):
        TTrainer(cost, PORT_OPT["sgd"](), device="cpu", shard_update=True)

    def fn(r, mesh):
        dp = TDataParallel(mesh)
        with pytest.raises(ValueError, match="shard_update"):
            TTrainer(cost, PORT_OPT["sgd"](), device="cpu", parallel=dp,
                     grad_compression="bf16")
        opt = PORT_OPT["sgd"]()
        with pytest.raises(ValueError, match="updater"):
            TTrainer(cost, opt, device="cpu", parallel=dp,
                     updater=tupd.IciAllReduceUpdater(opt, dp), shard_update=True)
        with pytest.raises(ValueError, match="zero1"):
            TTrainer(cost, PORT_OPT["sgd"](), device="cpu", parallel=dp,
                     shard_update="zero9")
        with pytest.raises(ValueError, match="grad_compression"):
            TTrainer(cost, PORT_OPT["sgd"](), device="cpu", parallel=dp,
                     shard_update=True, grad_compression="fp4")
        return True

    assert run_ranks(2, fn) == [True, True]


@pytest.mark.parametrize("mode,comp", [("zero1", None), ("zero3", "int8")])
def test_sharded_updater_flat_geometry(mode, comp):
    """Flat slots (and zero3's parameters) are this rank's [1, chunk] row,
    chunk = ceil(size / n) aligned to the compression's block; the JAX
    package's geometry for the same net."""
    init, _ = jax_train(4)
    got = port_train(4, mode, comp, init=init, passes=1)
    tr = got.trainer
    assert isinstance(tr.updater, tupd.ShardedUpdater) and tr.updater.mode == mode
    for k, g in tr.updater._geom.items():
        size = int(np.prod(g.shape))
        align = 64 if comp == "int8" else 1
        assert g.flat and g.chunk == -(-(-(-size // 4)) // align) * align
        for s in tr.state["opt"]["slots"][k]:
            assert tuple(s.shape) == (1, g.chunk)
        if mode == "zero3":
            assert tuple(tr.state["params"][k].shape) == (1, g.chunk)


def test_flat_geometry_resolves_through_rules():
    """A parameter declaring tensor-parallel logical axes takes the flat
    layout on the data-only mesh, where "mlp" does not bite."""
    cost = port_net(attr=TParamAttr(logical_axes=("embed", "mlp")))
    x, y = data(32)

    def fn(r, mesh):
        tr = TTrainer(cost, PORT_OPT["sgd"](), seed=5, device="cpu",
                      parallel=TDataParallel(mesh), shard_update="zero3")
        tr.init_state({"x": x, "label": y})
        return tr.updater._geom["h.w"].flat

    assert run_ranks(4, fn) == [True] * 4


def test_zero3_composes_with_bf16_precision():
    init, _ = jax_train(4)
    x, y = data(96)
    cost = port_net()

    def fn(r, mesh):
        tr = TTrainer(cost, PORT_OPT["sgd"](), seed=5, device="cpu", precision="bf16",
                      parallel=TDataParallel(mesh), shard_update="zero3")
        tr.init_state({"x": x[:32], "label": y[:32]})
        tr.load_params(init)
        tr.train(reader(x, y), num_passes=1, log_period=0)
        dtypes = {p.dtype for p in tr.state["params"].values()}
        return dtypes, tr.test(reader(x, y))["cost"]

    for dtypes, test_cost in run_ranks(4, fn):
        assert dtypes == {torch.float32} and np.isfinite(test_cost)


def test_resize_to_names_item_8c():
    """Item 8c is ported: a same-size resize_to of a trained zero1 rank
    pair re-shards onto a new group through the canonical seams, bitwise;
    a mesh-less trainer still has nothing to re-shape."""
    cost = port_net()
    x, y = data(96)

    def fn(r, mesh):
        tr = TTrainer(cost, PORT_OPT["sgd"](), device="cpu", parallel=TDataParallel(mesh),
                      shard_update="zero1")
        tr.train(reader(x, y), num_passes=1, log_period=0)
        before = {k: v.clone() for k, v in tr.canonical_params().items()}
        slots = {k: tuple(t.clone() for t in s)
                 for k, s in tr.updater.to_canonical(tr.state["opt"])["slots"].items()}
        old = tr.mesh
        tr.resize_to(2)
        assert tr.mesh is not old and old.closed and tr.updater.n == 2
        after = tr.canonical_params()
        new_slots = tr.updater.to_canonical(tr.state["opt"])["slots"]
        return (all(torch.equal(after[k], v) for k, v in before.items())
                and all(torch.equal(a, b) for k, s in slots.items()
                        for a, b in zip(s, new_slots[k])))

    assert run_ranks(2, fn) == [True, True]
    with pytest.raises(ValueError, match="DataParallel"):
        TTrainer(cost, PORT_OPT["sgd"](), device="cpu").resize_to(2)
