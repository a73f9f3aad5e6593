"""Tensor-parallel serving in the port (`ServableLM(mesh=)`, the serving
session leading `serving/tp.TPWorker` ranks) against the JAX package's
tensor-parallel sessions on its forced 8-device CPU mesh: the twin of
`tests/test_tp_serving.py`.

The port's ranks run as threads, each with its own gloo group over one
store (`test_torch_parallel.run_ranks`) on a {"data": 1, "model": tp}
mesh. Every port session gets the JAX package's seed-0 parameters, moved
across by name (`load_canonical(params_from_jax(...))`), whatever its
layout. Tolerances: tokens equal (greedy, and sampled with per-request
seeds through chunked prefill), checkpoints bitwise (a zero1 run's
against its replicated twin within 1e-6 at four data ranks), byte counts exactly
(the pool) or within the JAX test's >= 0.6 N bound (the parameters).

The port's rules table resolves an axis of extent 1 to None:
`("batch", "embed")` on a tp mesh with a data axis of 1 is (None, None),
where the JAX package says P("data", None); both replicate."""

import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch.nn.graph import ParamAttr as TParamAttr
from paddle_tpu_torch.parallel import DataParallel
from paddle_tpu_torch.parallel.rules import DEFAULT_RULES, ShardingRules
from paddle_tpu_torch.serving.convert import params_from_jax
from paddle_tpu_torch.serving.model import LMConfig, ServableLM
from paddle_tpu_torch.serving.session import ServingSession, make_demo_session
from paddle_tpu_torch.serving.tp import TPWorker
from paddle_tpu_torch.serving.workload import (
    make_mixed_prompts,
    make_prompts,
    run_closed_loop,
)

from test_torch_parallel import run_ranks

pytestmark = pytest.mark.timeout(300)

_DEMO = dict(vocab=64, n_layers=2, d_model=32, n_heads=4, seed=0,
             max_slots=4, page_size=8, max_new_limit=8)
_SESSION = dict(max_slots=4, page_size=8, max_new_limit=8)


def _tp_axes(tp):
    return {"data": 1, "model": tp}


def _cfg(max_len):
    return LMConfig(vocab=64, n_layers=2, d_model=32, n_heads=4, max_len=max_len)


def port_run(tp, params, max_len, drive, **session_kw):
    """drive(session) on a port session at `tp` (0: one rank) holding the
    canonical `params` (JAX names) -> drive's result on the leading rank."""
    kw = {**_SESSION, **session_kw}
    if not tp:
        model = ServableLM(_cfg(max_len), device="cpu").load_canonical(params)
        return drive(ServingSession(model, device="cpu", **kw))

    def rank(r, mesh):
        model = ServableLM(_cfg(max_len), device="cpu", mesh=mesh).load_canonical(params)
        if r:
            TPWorker(model).run()
            return None
        session = ServingSession(model, device="cpu", **kw)
        try:
            return drive(session)
        finally:
            session.stop()

    return run_ranks(tp, rank, axes=_tp_axes(tp))[0]


def _closed(prompts):
    def drive(session):
        res = run_closed_loop(session, prompts, 8, concurrency=4)
        return res.pop("results"), session.stats()
    return drive


def _greedy_prompts():
    return make_prompts(6, lengths=(5, 11, 16, 23), vocab=64, bos_id=1, seed=0)


def _mixed_prompts():
    return make_mixed_prompts(6, short_lengths=(5, 11), long_len=40, long_every=3,
                              burst=1, vocab=64, bos_id=1, seed=1)


_SAMPLED = dict(prefill_buckets=(16,), prefill_chunk=8, default_temperature=0.8,
                default_top_k=12)


_JAX_PARAMS = {}


def jax_params_at(max_len):
    """The JAX package's seed-0 demo parameters at `max_len` positions
    (canonical arrays; the positions' draw depends on max_len)."""
    if max_len not in _JAX_PARAMS:
        import jax

        from paddle_tpu.serving.model import LMConfig as JaxConfig
        from paddle_tpu.serving.model import ServableLM as JaxLM

        m = JaxLM(JaxConfig(vocab=64, n_layers=2, d_model=32, n_heads=4, max_len=max_len))
        _JAX_PARAMS[max_len] = {k: np.asarray(v) for k, v in
                                m.init_params(jax.random.PRNGKey(0)).items()}
    return _JAX_PARAMS[max_len]


@pytest.fixture(scope="module")
def jax_params():
    return jax_params_at(40)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's TP sessions (tp 2 and 4): greedy and sampled."""
    import jax
    from jax.experimental.compilation_cache import compilation_cache

    from paddle_tpu.serving.session import make_demo_session as jax_demo
    from paddle_tpu.serving.workload import run_closed_loop as jax_closed

    # multi-device programs must not come from the persistent cache (the
    # JAX test's own fixture, tests/test_tp_serving.py)
    prev = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    compilation_cache.reset_cache()
    try:
        out = {}
        for tp in (2, 4):
            g = jax_demo(prefill_buckets=(16, 32), tp=tp, **_DEMO)
            out[("greedy", tp)] = jax_closed(g, _greedy_prompts(), 8,
                                             concurrency=4)["results"]
            s = jax_demo(max_len=64, tp=tp, **_SAMPLED, **_DEMO)
            out[("sampled", tp)] = jax_closed(s, _mixed_prompts(), 8,
                                              concurrency=4)["results"]
        return out
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)
        compilation_cache.reset_cache()


@pytest.fixture(scope="module")
def greedy_runs(jax_params):
    params = params_from_jax(jax_params)
    return {tp: port_run(tp, params, 40, _closed(_greedy_prompts()),
                         prefill_buckets=(16, 32)) for tp in (0, 2, 4)}


@pytest.fixture(scope="module")
def sampled_runs():
    params = params_from_jax(jax_params_at(64))
    return {tp: port_run(tp, params, 64, _closed(_mixed_prompts()), **_SAMPLED)
            for tp in (0, 2, 4)}


# -- the rules table --------------------------------------------------------------


def test_default_rules_resolution():
    def fn(r, mesh):
        rules = ShardingRules()
        return (rules.spec_for(("embed", "mlp"), mesh),
                rules.spec_for(("vocab", "embed"), mesh),
                rules.spec_for(("batch", "embed"), mesh),
                rules.spec_for(("heads",), mesh, ndim=3))

    for got in run_ranks(2, fn, axes=_tp_axes(2)):
        assert got == ((None, "model"), ("model", None), (None, None),
                       ("model", None, None))


def test_rules_axis_absent_from_mesh_replicates():
    def fn(r, mesh):
        rules = ShardingRules()
        return rules.spec_for(("embed", "mlp"), mesh), rules.spec_for(("batch", "heads"), mesh)

    assert run_ranks(4, fn) == [((None, None), ("data", None))] * 4


def test_rules_unknown_axis_raises_naming_param():
    with pytest.raises(KeyError, match=r"heds.*h\.w"):
        ShardingRules().spec_for(("embed", "heds"), param="h.w")


def test_rules_pipeline_axis_reserved():
    assert "pipeline" in DEFAULT_RULES and DEFAULT_RULES["pipeline"] is None
    got = run_ranks(2, lambda r, m: ShardingRules().with_overrides(pipeline="model")
                    .spec_for(("pipeline",), m), axes=_tp_axes(2))
    assert got == [("model",)] * 2


def test_legacy_mesh_axis_tuples_translate_through_table():
    def fn(r, mesh):
        dp = DataParallel(mesh, param_attrs={
            "w": TParamAttr(sharding=(None, "model")),
            "e": TParamAttr(logical_axes=("embed", "mlp")),
        })
        return (dp.param_sharding("w", 2), dp.param_sharding("e", 2),
                dp.param_sharding("unlisted", 2))

    got = run_ranks(8, fn, axes={"data": 4, "model": 2})
    assert got == [((None, "model"), (None, "model"), (None, None))] * 8


# -- tokens and bytes against tp 0 and the JAX package ----------------------------


def test_tp_greedy_tokens_identical(greedy_runs, jax_runs):
    tok0 = greedy_runs[0][0]
    assert all(t for t in tok0)
    for tp in (2, 4):
        assert greedy_runs[tp][0] == tok0, f"TP={tp} greedy tokens diverged"
        assert jax_runs[("greedy", tp)] == tok0, f"JAX TP={tp} differs from the port"


def test_tp_sampled_chunked_tokens_identical(sampled_runs, jax_runs):
    tok0 = sampled_runs[0][0]
    for tp in (2, 4):
        assert sampled_runs[tp][0] == tok0, f"TP={tp} sampled/chunked tokens diverged"
        assert jax_runs[("sampled", tp)] == tok0, f"JAX TP={tp} differs from the port"
    assert all(st["prefill_chunks_committed"] > 0 for _, st in sampled_runs.values())


def test_tp_one_decode_signature(greedy_runs, sampled_runs):
    for runs in (greedy_runs, sampled_runs):
        for tp, (_, st) in runs.items():
            assert st["decode_shape_signatures"] == 1, (tp, st)
            assert st["decode_graph"] == "eager: cpu"


def test_tp_param_and_pool_bytes_shrink(greedy_runs):
    base = greedy_runs[0][1]
    assert base["tp"] == 1
    for tp in (2, 4):
        st = greedy_runs[tp][1]
        assert st["tp"] == tp
        assert st["pool_bytes_per_chip"] * tp == base["pool_bytes_per_chip"]
        ratio = base["param_bytes_per_chip"] / st["param_bytes_per_chip"]
        assert ratio >= 0.6 * tp, (tp, ratio)


def test_tp_pool_reinit_keeps_the_shard(jax_params):
    """Recovery's re-init lands on the rank's kv_dim / tp columns, on the
    leading rank and (through its header) on the workers."""
    params = params_from_jax(jax_params)

    def drive(session):
        h = session.submit([1, 5, 9, 11], 4)
        session.run_until_idle()
        k2, v2 = session.cache.make_pools(session.device)
        assert k2.shape[-1] == v2.shape[-1] == 32 // 2
        assert session.k_pages.abs().sum() > 0
        session.cache.reset()
        session._reset_device_state()
        assert float(session.k_pages.abs().sum()) == 0
        again = session.submit([1, 5, 9, 11], 4)
        session.run_until_idle()
        return h.tokens, again.tokens, tuple(session.k_pages.shape)

    first, again, shape = port_run(2, params, 40, drive, prefill_buckets=(16,))
    assert first == again and shape[-1] == 16


def test_tp_rejects_indivisible_heads_and_vocab():
    def fn(r, mesh):
        errs = []
        for cfg in (LMConfig(vocab=64, n_layers=1, d_model=32, n_heads=2, max_len=32),
                    LMConfig(vocab=50257, n_layers=1, d_model=32, n_heads=4, max_len=32)):
            with pytest.raises(ValueError) as ei:
                ServableLM(cfg, device="cpu", mesh=mesh)
            errs.append(str(ei.value))
        return errs

    heads, vocab = run_ranks(4, fn, axes=_tp_axes(4))[0]
    assert "n_heads" in heads and "vocab" in vocab and "50257" in vocab
    with pytest.raises(RuntimeError, match="every rank"):
        make_demo_session(tp=2, device="cpu")


def test_tp_unknown_param_raises_not_replicates():
    def fn(r, mesh):
        model = ServableLM(LMConfig(vocab=64, n_layers=1, d_model=32, n_heads=4,
                                    max_len=64), device="cpu", mesh=mesh)
        with pytest.raises(KeyError, match="mystery"):
            model.param_sharding("mystery", 2)
        return model.param_sharding("l0.wq", 2)

    assert run_ranks(2, fn, axes=_tp_axes(2)) == [(None, "model")] * 2
    single = ServableLM(LMConfig(vocab=64, n_layers=1, d_model=32, n_heads=4, max_len=64),
                        device="cpu")
    assert single.param_sharding("mystery", 2) is None


# -- cross-layout checkpoints -------------------------------------------------------


def test_servable_checkpoint_cross_layout_bitwise(tmp_path, jax_params, greedy_runs):
    """A checkpoint written from a TP=2 model (its slices gathered) loads
    bitwise onto one card and onto TP=4, and the TP=4 session decodes the
    oracle's tokens."""
    path = os.path.join(str(tmp_path), "tp2.npz")
    params = params_from_jax(jax_params)

    def save(r, mesh):
        model = ServableLM(_cfg(40), device="cpu", mesh=mesh).load_canonical(params)
        model.save(path)

    run_ranks(2, save, axes=_tp_axes(2))
    single = ServableLM.load(path, device="cpu").canonical_params()
    for k, v in jax_params.items():
        np.testing.assert_array_equal(single[k].numpy().view(np.uint32), v.view(np.uint32))

    def load4(r, mesh):
        model = ServableLM.load(path, device="cpu", mesh=mesh)
        full = model.canonical_params()
        if r:
            TPWorker(model).run()
            return full, None
        session = ServingSession(model, device="cpu", prefill_buckets=(16, 32), **_SESSION)
        try:
            prompts = make_prompts(4, lengths=(5, 11, 16), vocab=64, bos_id=1, seed=0)
            return full, run_closed_loop(session, prompts, 8, concurrency=4)["results"]
        finally:
            session.stop()

    full, got = run_ranks(4, load4, axes=_tp_axes(4))[0]
    for k in single:
        np.testing.assert_array_equal(full[k].numpy().view(np.uint32),
                                      single[k].numpy().view(np.uint32))
    want = port_run(0, params, 40, lambda s: run_closed_loop(
        s, make_prompts(4, lengths=(5, 11, 16), vocab=64, bos_id=1, seed=0), 8,
        concurrency=4)["results"], prefill_buckets=(16, 32))
    assert got == want


@pytest.mark.parametrize("n_data", [4, 2])
def test_shard_update_checkpoint_places_onto_tp_mesh_bitwise(tmp_path, n_data):
    """A zero1 run's async checkpoint holds canonical params equal to the
    replicated twin's (bitwise at two data ranks; within 1e-6 at four, the
    JAX test's size, where gloo's reduce-scatter and all-reduce add the
    partial gradients in different orders, 1 ulp apart: ROADMAP.md §3, "Not
    a fault"), and a dp x tp trainer restores them as its slices (logical
    axes through the rules table) and gathers them back bitwise."""
    from paddle_tpu_torch.nn import costs as TC
    from paddle_tpu_torch.nn import layers as TL
    from paddle_tpu_torch.nn.graph import reset_name_scope
    from paddle_tpu_torch.optim import optimizers as topt
    from paddle_tpu_torch.trainer.trainer import SGDTrainer

    def build(axes=False):
        reset_name_scope()
        x = TL.Data("x", shape=(8,))
        lbl = TL.Data("label", shape=())
        h = TL.Fc(x, 16, act="relu", name="h",
                  param_attr=TParamAttr(logical_axes=("embed", "mlp")) if axes else None)
        logits = TL.Fc(h, 4, act=None, name="out",
                       param_attr=TParamAttr(logical_axes=("mlp", "embed")) if axes else None)
        return TC.ClassificationCost(logits, lbl, name="cost")

    rs = np.random.RandomState(0)
    x = rs.randn(32, 8).astype(np.float32)
    y = rs.randint(0, 4, 32)

    def reader():
        for i in range(0, 32, 16):
            yield {"x": x[i:i + 16], "label": y[i:i + 16]}

    save_dir = str(tmp_path)

    def train(shard):
        def fn(r, mesh):
            tr = SGDTrainer(build(), topt.SGD(learning_rate=0.125), seed=3,
                            parallel=DataParallel(mesh), shard_update=shard)
            tr.train(reader, num_passes=1, save_dir=save_dir if shard else None,
                     async_checkpoint=bool(shard))
            tr.checkpoint_wait()
            return {k: v.clone() for k, v in tr.canonical_params().items()}
        return run_ranks(n_data, fn)[0]

    train(True)
    twin = train(False)
    with np.load(os.path.join(save_dir, "pass-00000", "params.npz")) as z:
        saved = {k: np.array(z[k]) for k in z.files}
    for k, v in twin.items():
        if n_data == 2:
            np.testing.assert_array_equal(saved[k].view(np.uint32),
                                          v.numpy().view(np.uint32))
        else:
            np.testing.assert_allclose(saved[k], v.numpy(), rtol=1e-6, atol=1e-7)

    def place(r, mesh):
        tr = SGDTrainer(build(axes=True), topt.SGD(learning_rate=0.125), seed=3,
                        parallel=DataParallel(mesh))
        tr.init_state({"x": x[:16], "label": y[:16]})
        tr.load(save_dir, 0)
        return tuple(tr.state["params"]["h.w"].shape), tr.canonical_params()

    for shape, params in run_ranks(4, place, axes={"data": 2, "model": 2}):
        assert shape == (8, 8)  # this rank's mlp columns
        for k, v in saved.items():
            np.testing.assert_array_equal(params[k].numpy().view(np.uint32),
                                          v.view(np.uint32))


# -- shared-prefix cache x TP -----------------------------------------------------


def _prefix_drive(session):
    sys_prompt = list(range(2, 26))  # 24 shared tokens = 3 pages of 8
    handles = []
    for i in range(4):
        handles.append(session.submit(sys_prompt + [30 + i, 31 + i], 6,
                                      seed=50 + i, temperature=0.6, top_k=12))
        session.run_until_idle()
    return [h.tokens for h in handles], session.stats()


def test_tp_prefix_cache_tokens_identical():
    """The prefix cache is the leading rank's host state: aliased pages are
    page ids in the one block table every rank reads."""
    params = params_from_jax(jax_params_at(96))
    kw = dict(prefill_buckets=(16,), prefill_chunk=8)
    ref, _ = port_run(0, params, 96, _prefix_drive, **kw)
    for tp in (0, 2):
        out, st = port_run(tp, params, 96, _prefix_drive, prefix_cache=True, **kw)
        assert out == ref, f"tp={tp} cache-on tokens diverged"
        assert st["prefix_hit_rate"] > 0.3, (tp, st["prefix_hit_rate"])
        assert st["prefix_pages_shared"] >= 9, (tp, st["prefix_pages_shared"])
        assert st["decode_shape_signatures"] == 1


def test_demo_session_tp_over_a_group_matches_tp_0():
    """make_demo_session(tp=2, group=...) on both ranks: rank 0 gets the
    session, rank 1 a TPWorker; seeded weights are the same as tp 0's, so
    the tokens are too."""
    want = make_demo_session(prefill_buckets=(16,), device="cpu", **_DEMO)
    h = want.submit([1, 5, 9], 6)
    want.run_until_idle()

    def fn(r, mesh):
        s = make_demo_session(prefill_buckets=(16,), device="cpu", tp=2, group=mesh.group,
                              **_DEMO)
        if isinstance(s, TPWorker):
            return s.run().calls
        got = s.submit([1, 5, 9], 6)
        s.run_until_idle()
        s.stop()
        return got.tokens

    tokens, calls = run_ranks(2, fn)
    assert tokens == h.tokens and calls == 6  # one prefill + five decode steps


@pytest.mark.cuda
def test_cuda_tp_2_on_one_card_matches_tp_0():
    """Two rank threads on cuda:0 over one gloo group: the decode step runs
    eagerly (a gloo group cannot be captured), the kernel launches at 2
    heads a rank, and the tokens equal a tp 0 session's on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the paged-attention kernel has no CPU mode")
    from paddle_tpu_torch.ops import paged_attention as pa

    kw = dict(prefill_buckets=(16,), **_DEMO)
    want = make_demo_session(device="cuda", **kw)
    h = want.submit([1, 5, 9], 6)
    want.run_until_idle()

    def fn(r, mesh):
        s = make_demo_session(device="cuda", tp=2, group=mesh.group, **kw)
        if isinstance(s, TPWorker):
            return s.run().decode_mode
        got = s.submit([1, 5, 9], 6)
        s.run_until_idle()
        s.stop()
        return got.tokens, s.stats()["decode_graph"]

    before = pa.LAUNCHES
    (tokens, mode), worker_mode = run_ranks(2, fn)
    assert tokens == h.tokens
    assert mode == worker_mode == "eager: gloo group"
    assert pa.LAUNCHES - before == 2 * 5 * _DEMO["n_layers"]
