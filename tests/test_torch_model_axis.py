"""Model-axis training and the expert-sharded embedding in the port
(`paddle_tpu_torch/parallel/{updaters,embedding}.py`) against the JAX
package on its forced 8-device CPU mesh: the twins of
`tests/test_parallel.py:81-164` and `tests/test_distributed.py:24-60`,
CTR's `embedding_sharding` and seq2seq's vocab axes on a model mesh.

The port's ranks are threads (`test_torch_parallel.run_ranks`). A
parameter whose logical axes resolve to the model (or expert) axis is
stored as this rank's slice and gathered for the step's compute; the JAX
package's GSPMD partitions the compute instead (ROADMAP.md §3 difference
26). Tolerances: the JAX tests' (costs and parameters rtol 2e-4 / atol
2e-5 against single-device training, lookups atol 1e-6, gradients atol
1e-5), and rtol 1e-5 / atol 1e-6 between the port's sharded and unsharded
runs."""

import warnings

import numpy as np
import pytest
import torch

from paddle_tpu_torch.nn.graph import ParamAttr as TParamAttr
from paddle_tpu_torch.nn.graph import reset_name_scope as t_reset
from paddle_tpu_torch.optim import optimizers as topt
from paddle_tpu_torch.parallel import DataParallel, rules as trules
from paddle_tpu_torch.parallel.embedding import (
    ShardedEmbeddingState,
    shard_table,
    sharded_lookup,
)
from paddle_tpu_torch.trainer.trainer import SGDTrainer

from test_torch_parallel import data, jax_net, port_net, reader, run_ranks

DP_TP = {"data": 4, "model": 2}


def _jax_dp_tp(shard_fc=True):
    """The JAX package: SGD(0.1) over two batches of 32 on a 4 x 2 mesh
    (h.w sharded over model) -> (initial params, final params, last cost)."""
    from paddle_tpu.nn.graph import ParamAttr, reset_name_scope
    from paddle_tpu.optim import SGD
    from paddle_tpu.parallel import DataParallel as JDP, make_mesh
    from paddle_tpu.trainer import SGDTrainer as JTrainer
    from paddle_tpu.trainer.events import EndIteration

    reset_name_scope()
    cost = jax_net(attr=ParamAttr(sharding=(None, "model")) if shard_fc else None)
    dp = JDP(make_mesh(DP_TP))
    tr = JTrainer(cost, SGD(learning_rate=0.1), parallel=dp, seed=5)
    x, y = data(64)
    tr.init_state(dp.shard_batch({"x": x[:32], "label": y[:32]}))
    init = {k: np.asarray(v) for k, v in tr.state["params"].items()}
    costs = []
    tr.train(reader(x, y, 32), num_passes=1,
             event_handler=lambda e: costs.append(e.cost) if isinstance(e, EndIteration)
             else None)
    return init, {k: np.asarray(v) for k, v in tr.state["params"].items()}, costs


def _port_run(init, axes=None, shard_fc=True, shard=False):
    """The port over `axes` thread ranks (None: one rank, no mesh) from
    `init` -> rank 0's (canonical params, costs, h.w's stored shape), with
    every rank's canonical params."""
    x, y = data(64)

    def fn(r, mesh):
        t_reset()
        cost = port_net(attr=TParamAttr(sharding=(None, "model")) if shard_fc else None)
        tr = SGDTrainer(cost, topt.SGD(learning_rate=0.1), seed=5, device="cpu",
                        parallel=DataParallel(mesh) if mesh is not None else None,
                        shard_update=shard)
        tr.init_state({"x": x[:32], "label": y[:32]})
        tr.load_params(init)
        costs = [float(tr.step({"x": x[i:i + 32], "label": y[i:i + 32]}))
                 for i in range(0, 64, 32)]
        return ({k: v.numpy() for k, v in tr.canonical_params().items()}, costs,
                tuple(tr.state["params"]["h.w"].shape))

    if axes is None:
        return fn(0, None), None
    res = run_ranks(int(np.prod(list(axes.values()))), fn, axes=axes)
    return res[0], res


@pytest.fixture(scope="module")
def jax_dp_tp():
    return _jax_dp_tp()


@pytest.mark.parametrize("shard", [False, "zero1", "zero3"])
def test_dp_plus_tp_matches_single_device_and_jax(jax_dp_tp, shard):
    """data 4 x model 2, h.w's columns over model: the same costs and
    parameters as one device (and as the JAX package's 4 x 2 run), under
    the replicated, zero1 and zero3 updaters (h.w stays out of the flat
    buffers in its slice layout)."""
    init, jax_final, jax_costs = jax_dp_tp
    (single, single_costs, _), _ = _port_run(init, shard_fc=False)
    (got, costs, shape), ranks = _port_run(init, DP_TP, shard=shard)
    assert shape == (16, 24)  # this rank's 24 of h's 48 columns
    np.testing.assert_allclose(costs, single_costs, rtol=2e-4)
    np.testing.assert_allclose(costs[-1], float(jax_costs[-1]), rtol=2e-4)
    for k in single:
        np.testing.assert_allclose(got[k], single[k], rtol=2e-4, atol=2e-5, err_msg=k)
        np.testing.assert_allclose(got[k], jax_final[k], rtol=2e-4, atol=2e-5, err_msg=k)
    for other, _, _ in ranks[1:]:  # every rank gathers the same parameters
        for k in got:
            np.testing.assert_array_equal(other[k], got[k])


def test_sharded_param_layout():
    """h.w (16 x 48) declared (None, "model"): each rank of the 4 x 2 mesh
    stores its 24 columns, and its optimizer slots match."""
    x, y = data(32)

    def fn(r, mesh):
        t_reset()
        cost = port_net(attr=TParamAttr(sharding=(None, "model")))
        tr = SGDTrainer(cost, topt.SGD(learning_rate=0.1, momentum=0.9), seed=0,
                        device="cpu", parallel=DataParallel(mesh))
        tr.init_state({"x": x, "label": y})
        full = tr.canonical_params()["h.w"]
        local = tr.state["params"]["h.w"]
        cols = mesh.index("model") * 24
        return (dp_spec(tr), tuple(local.shape),
                tuple(tr.state["opt"]["slots"]["h.w"][0].shape),
                torch.equal(local, full[:, cols:cols + 24]))

    def dp_spec(tr):
        return tr.parallel.param_sharding("h.w", 2)

    for spec, shape, slot, same in run_ranks(8, fn, axes=DP_TP):
        assert spec == (None, "model") and shape == slot == (16, 24) and same


def test_legacy_sharding_shim_warns_exactly_once_per_process():
    was = trules._legacy_sharding_warned
    try:
        trules._legacy_sharding_warned = False

        def fn(r, mesh):
            dp = DataParallel(mesh, param_attrs={
                "a.w": TParamAttr(sharding=("model", None)),
                "b.w": TParamAttr(sharding=(None, "model")),
            })
            if r == 0:
                with warnings.catch_warnings(record=True) as got:
                    warnings.simplefilter("always")
                    dp.param_sharding("a.w", 2)
                    dp.param_sharding("b.w", 2)
                return [str(w.message) for w in got
                        if issubclass(w.category, DeprecationWarning)]
            return None

        dep = run_ranks(4, fn, axes={"data": 2, "model": 2})[0]
        assert len(dep) == 1 and "a.w" in dep[0] and "logical_axes" in dep[0]
        trules._legacy_sharding_warned = False
        dp2 = DataParallel(run_ranks(1, lambda r, m: m)[0], param_attrs={
            "c.w": TParamAttr(logical_axes=("embed", "mlp"))})
        with warnings.catch_warnings(record=True) as got2:
            warnings.simplefilter("always")
            dp2.param_sharding("c.w", 2)
        assert not [w for w in got2 if issubclass(w.category, DeprecationWarning)]
    finally:
        trules._legacy_sharding_warned = was


# -- the expert-sharded lookup (tests/test_distributed.py:24-60) --------------------


def _on_expert(fn, n=4):
    return run_ranks(n, fn, axes={"expert": n})


def test_sharded_lookup_matches_dense():
    rs = np.random.RandomState(0)
    table = torch.tensor(rs.randn(32, 8), dtype=torch.float32)  # 32 rows / 4 shards
    ids = torch.tensor(rs.randint(0, 32, (5, 7)))

    def fn(r, mesh):
        state = ShardedEmbeddingState(table, mesh)
        return tuple(state.table.shape), state(ids), mesh.counts("expert")["all_reduce"]

    for shape, got, n_reduce in _on_expert(fn):
        assert shape == (8, 8) and n_reduce == 1
        np.testing.assert_allclose(got.numpy(), table[ids].numpy(), atol=1e-6)


def test_sharded_lookup_grad_is_row_sparse_scatter():
    import jax
    import jax.numpy as jnp

    from paddle_tpu.parallel import make_mesh
    from paddle_tpu.parallel.embedding import shard_table as j_shard
    from paddle_tpu.parallel.embedding import sharded_lookup as j_lookup

    rs = np.random.RandomState(1)
    table = rs.randn(16, 4).astype(np.float32)
    ids = np.asarray([0, 3, 3, 15, 7], np.int32)
    cot = rs.randn(5, 4).astype(np.float32)

    def fn(r, mesh):
        local = shard_table(torch.tensor(table), mesh).requires_grad_(True)
        (sharded_lookup(local, torch.tensor(ids), mesh) * torch.tensor(cot)).sum().backward()
        return local.grad

    g_port = torch.cat(_on_expert(fn)).numpy()
    jm = make_mesh({"expert": 4})
    g_jax = jax.grad(lambda t: jnp.sum(j_lookup(j_shard(t, jm), jnp.asarray(ids), jm)
                                       * jnp.asarray(cot)))(jnp.asarray(table))
    dense = np.zeros_like(table)
    np.add.at(dense, ids, cot)
    np.testing.assert_allclose(g_port, dense, atol=1e-5)
    np.testing.assert_allclose(g_port, np.asarray(g_jax), atol=1e-5)
    np.testing.assert_allclose(g_port[3], cot[1] + cot[2], atol=1e-6)  # id 3 twice


def test_sharded_table_vocab_divisibility():
    with pytest.raises(AssertionError, match="divisible"):  # a rank's ValueError
        _on_expert(lambda r, mesh: shard_table(torch.zeros(30, 4), mesh))


# -- CTR's embedding_sharding and seq2seq's vocab axes ----------------------------


CTR = dict(wide_dim=32, slot_vocab_sizes=(16, 16), embed_dim=8, hidden_dims=(16,))


def test_ctr_embedding_sharding_matches_jax_and_unsharded():
    """("expert", None) tables on {"data": 1, "expert": 4}: the port's two
    SGD(0.5) steps against its unsharded run (rtol 1e-5) and the JAX
    package's sharded run on the same mesh (rtol 2e-4)."""
    from paddle_tpu import models as jmodels
    from paddle_tpu.nn.graph import reset_name_scope
    from paddle_tpu.optim import SGD
    from paddle_tpu.parallel import DataParallel as JDP, make_mesh
    from paddle_tpu.trainer import SGDTrainer as JTrainer
    from paddle_tpu_torch import models as tmodels
    from test_torch_ctr import make_batch

    batches = [make_batch(0), make_batch(1)]
    reset_name_scope()
    jcost = jmodels.ctr_wide_deep(embedding_sharding=("expert", None), **CTR)[3]
    jdp = JDP(make_mesh({"data": 1, "expert": 4}))
    jtr = JTrainer(jcost, SGD(learning_rate=0.5), parallel=jdp, seed=0)
    jtr.init_state(jdp.shard_batch(batches[0]))
    init = {k: np.asarray(v) for k, v in jtr.state["params"].items()}
    jtr._step_fn = jtr._make_step()
    jax_costs = []
    for b in batches:
        jtr.state, c, _ = jtr._step_fn(jtr.state, jdp.shard_batch(b))
        jax_costs.append(float(c))
    jax_final = {k: np.asarray(v) for k, v in jtr.state["params"].items()}

    def train(mesh, sharding):
        t_reset()
        cost = tmodels.ctr_wide_deep(embedding_sharding=sharding, **CTR)[3]
        tr = SGDTrainer(cost, topt.SGD(learning_rate=0.5), device="cpu",
                        parallel=DataParallel(mesh) if mesh is not None else None)
        tr.init_state(batches[0])
        tr.load_params(init)
        costs = [float(tr.step(b)) for b in batches]
        return costs, {k: v.numpy() for k, v in tr.canonical_params().items()}

    plain_costs, plain = train(None, None)
    got = run_ranks(4, lambda r, mesh: train(mesh, ("expert", None)),
                    axes={"data": 1, "expert": 4})
    for costs, params in got:
        np.testing.assert_allclose(costs, plain_costs, rtol=1e-5)
        np.testing.assert_allclose(costs, jax_costs, rtol=2e-4)
        for k in plain:
            np.testing.assert_allclose(params[k], plain[k], rtol=1e-5, atol=1e-6, err_msg=k)
            np.testing.assert_allclose(params[k], jax_final[k], rtol=2e-4, atol=2e-5,
                                       err_msg=k)


def test_seq2seq_on_a_model_mesh_matches_one_rank():
    """Seq2seq's vocab tables and projection declare ("vocab", "embed") /
    ("embed", "vocab"): on {"data": 1, "model": 2} each rank stores half
    of every vocab row set, and two Adam steps match one rank's."""
    from paddle_tpu_torch.models.seq2seq import Seq2SeqModel

    rs = np.random.RandomState(0)
    b, t = 4, 5
    batch = {"source_ids": rs.randint(2, 20, (b, t)), "source_ids.lengths": np.full(b, t),
             "target_ids": rs.randint(2, 20, (b, t)), "target_ids.lengths": np.full(b, t),
             "label_ids": rs.randint(2, 20, (b, t)), "label_ids.lengths": np.full(b, t)}

    def train(mesh):
        t_reset()
        model = Seq2SeqModel(20, 20, embed_dim=8, hidden_dim=12)
        tr = SGDTrainer(model.cost, topt.Adam(learning_rate=1e-2), seed=2, device="cpu",
                        parallel=DataParallel(mesh) if mesh is not None else None)
        tr.init_state(batch)
        costs = [float(tr.step(batch)) for _ in range(2)]
        shapes = {k: tuple(tr.state["params"][k].shape)
                  for k in ("src_emb.w", "trg_emb_table", "out_w", "out_b")}
        return costs, {k: v.numpy() for k, v in tr.canonical_params().items()}, shapes

    want_costs, want, _ = train(None)
    for costs, params, shapes in run_ranks(2, lambda r, m: train(m),
                                           axes={"data": 1, "model": 2}):
        assert shapes == {"src_emb.w": (10, 8), "trg_emb_table": (10, 8),
                          "out_w": (12, 10), "out_b": (10,)}
        np.testing.assert_allclose(costs, want_costs, rtol=1e-5)
        for k in want:
            np.testing.assert_allclose(params[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
