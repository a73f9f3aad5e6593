"""The structured costs of ROADMAP §1 item 6c in the port
(`paddle_tpu_torch/nn/struct_costs.py`: `NCECost`, `HierarchicalSigmoid`,
`LambdaCost`, `CrossEntropyOverBeam`) and the jax.random draws NCE needs
(`core/prng.split`, `randint`, `gumbel`, `categorical`), against the JAX
package on the CPU.

  * prng: `split`, `randint` (spans below 2^16, above it, one, empty, the
    whole int32 range) and `categorical` equal jax.random's bit for bit
    over 200 seeds; `gumbel` within 2 float32 ulps (torch's log and XLA's).
  * Each cost in a graph of both packages (a Fc in front, the JAX
    parameters moved by name, the same batch and, in training, the same
    key): the cost within 1e-5 relative and every gradient within 1e-4 x
    max(1, max|g|); NCE in train mode with uniform noise and with a
    `neg_distribution`, with a per-example weight input and over a
    sequence input, and in eval mode; hsigmoid with one and two feature
    inputs; LambdaCost with tied relevance labels and ragged lengths;
    CrossEntropyOverBeam on tests/test_layers3d_beam.py's case, against
    its per-sample oracle too.
  * The JAX tests' own checks: NCE and hsigmoid lower their cost in one
    step, hsigmoid's class probabilities sum to 1.
  * On a card (`cuda`, skipped here): every case card against CPU.
jax is imported inside the CPU tests only."""

import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import prng
from paddle_tpu_torch.nn import graph as tgraph
from paddle_tpu_torch.nn.convert import params_from_jax

RTOL = 1e-5
GRAD_TOL = 1e-4
SEEDS = range(200)


def test_split_randint_categorical_are_jax_bits():
    import jax
    import jax.numpy as jnp

    spans = [(0, 11), (0, 30000), (0, 2 ** 20 + 3), (5, 7), (3, 3), (-4, 9),
             (-2 ** 31, 2 ** 31 - 1)]
    seeds = np.asarray(list(SEEDS))
    logits = np.log(np.random.RandomState(0).rand(len(seeds), 11).astype(np.float32) + 0.05)

    @jax.jit
    def draws(seeds, logits):  # one compiled call for every draw of every seed
        keys = jax.vmap(jax.random.PRNGKey)(seeds)
        return (jax.vmap(jax.random.split)(keys),
                {(lo, hi): jax.vmap(lambda k: jax.random.randint(k, (16, 5), lo, hi))(keys)
                 for lo, hi in spans},
                jax.vmap(lambda k, lg: jax.random.categorical(k, lg, shape=(16, 5)))(
                    keys, logits),
                jax.vmap(lambda k: jax.random.gumbel(k, (64,)))(keys))

    splits, ints, cats, gumbels = jax.tree.map(np.asarray, draws(seeds, jnp.asarray(logits)))
    splits = splits.astype(np.int64)
    for i, seed in enumerate(seeds):
        tkey = prng.PRNGKey(int(seed))
        np.testing.assert_array_equal(prng.split(tkey).numpy(), splits[i])
        for lo, hi in spans:
            np.testing.assert_array_equal(prng.randint(tkey, (16, 5), lo, hi).numpy(),
                                          ints[lo, hi][i])
        np.testing.assert_array_equal(
            prng.categorical(tkey, torch.from_numpy(logits[i]), (16, 5)).numpy(), cats[i])
        np.testing.assert_allclose(prng.gumbel(tkey, (64,)).numpy(), gumbels[i],
                                   rtol=2.5e-7, atol=2.5e-7)


# -- the costs in a graph ------------------------------------------------------


def _nce(S, L, x, y, w=None, **kw):
    return S.NCECost(L.Fc(x, 16, act="relu", name="h"), y, num_classes=11,
                     num_neg_samples=5, weight=w, name="cost", **kw)


DIST = [0.3, 0.05, 0.1, 0.02, 0.08, 0.15, 0.05, 0.05, 0.1, 0.05, 0.05]
CASES = {
    "nce_uniform": lambda S, L, d: _nce(S, L, d["x"], d["y"]),
    "nce_distribution": lambda S, L, d: _nce(S, L, d["x"], d["y"], neg_distribution=DIST),
    "nce_weighted": lambda S, L, d: _nce(S, L, d["x"], d["y"], w=d["w"], bias=False),
    "nce_sequence": lambda S, L, d: _nce(S, L, d["xs"], d["ys"]),
    "hsigmoid": lambda S, L, d: S.HierarchicalSigmoid(
        L.Fc(d["x"], 16, act="relu", name="h"), d["y"], num_classes=11, name="cost"),
    "hsigmoid_two_inputs": lambda S, L, d: S.HierarchicalSigmoid(
        [L.Fc(d["x"], 6, act="tanh", name="h"), d["x"]], d["y"], num_classes=6, bias=False,
        name="cost"),
    "lambda_cost": lambda S, L, d: S.LambdaCost(
        L.Fc(d["docs"], 1, act=None, name="h"), d["rel"], ndcg_num=3, name="cost"),
}


def _data(L):
    return {"x": L.Data("x", shape=(8,)), "y": L.Data("y", shape=()),
            "w": L.Data("w", shape=()), "xs": L.Data("xs", shape=(None, 8), is_seq=True),
            "ys": L.Data("ys", shape=(None,), is_seq=True),
            "docs": L.Data("docs", shape=(None, 5), is_seq=True),
            "rel": L.Data("rel", shape=(None,), is_seq=True)}


def _batch(case, seed=0, b=16):
    rs = np.random.RandomState(seed)
    if case == "nce_sequence":
        return {"xs": rs.randn(4, 4, 8).astype(np.float32),
                "xs.lengths": np.full(4, 4, np.int32),
                "ys": rs.randint(0, 11, (4, 4)).astype(np.int32),
                "ys.lengths": np.full(4, 4, np.int32)}
    if case == "lambda_cost":
        lengths = np.array([6, 3, 5, 6], np.int32)
        return {"docs": rs.randn(4, 6, 5).astype(np.float32), "docs.lengths": lengths,
                "rel": rs.randint(0, 3, (4, 6)).astype(np.float32), "rel.lengths": lengths}
    n_cls = 6 if case == "hsigmoid_two_inputs" else 11
    return {"x": rs.randn(b, 8).astype(np.float32),
            "y": rs.randint(0, n_cls, b).astype(np.int32),
            "w": rs.rand(b).astype(np.float32)}


def _jax_cost_and_grads(case, batch, train, key_seed):
    import jax

    from paddle_tpu.nn import layers as JL
    from paddle_tpu.nn import struct_costs as JS
    from paddle_tpu.nn.graph import Network, reset_name_scope

    reset_name_scope()
    net = Network([CASES[case](JS, JL, _data(JL))])
    params, states = jax.jit(lambda key: net.init(key, batch))(jax.random.PRNGKey(0))

    def f(p):
        outs, _ = net.apply(p, states, batch, train=train, rng=jax.random.PRNGKey(key_seed))
        return outs["cost"].value

    with jax.default_matmul_precision("highest"):
        cost, grads = jax.jit(jax.value_and_grad(f))(params)
    return params, float(cost), {k: np.asarray(v) for k, v in grads.items()}


def _port_cost_and_grads(case, batch, params, train, key_seed, device="cpu"):
    from paddle_tpu_torch.nn import layers as TL
    from paddle_tpu_torch.nn import struct_costs as TS

    tgraph.reset_name_scope()
    net = tgraph.Network([CASES[case](TS, TL, _data(TL))])
    tp = {k: v.requires_grad_(True) for k, v in params_from_jax(params, device=device).items()}
    cost = net.apply(tp, batch, train=train, rng=prng.PRNGKey(key_seed, device))["cost"].value
    grads = torch.autograd.grad(cost, list(tp.values()))
    return float(cost), {k: g.cpu().numpy() for k, g in zip(tp, grads)}


def _check(got, want):
    cost, grads = got
    wcost, wgrads = want
    np.testing.assert_allclose(cost, wcost, rtol=RTOL)
    assert set(grads) == set(wgrads)
    for k, g in wgrads.items():
        scale = max(1.0, float(np.abs(g).max()))
        np.testing.assert_allclose(grads[k], g, rtol=GRAD_TOL, atol=GRAD_TOL * scale,
                                   err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("train", [True, False])
def test_cost_and_grads_match_jax(case, train):
    batch = _batch(case)
    params, cost, grads = _jax_cost_and_grads(case, batch, train, key_seed=3)
    _check(_port_cost_and_grads(case, batch, params, train, key_seed=3), (cost, grads))


def test_nce_draws_the_jax_samples():
    """The noise classes themselves, uniform and by distribution, for the
    key a graph's context hands the layer."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.nn.graph import _stable_hash

    for seed in range(20):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                    _stable_hash("cost")), 1)
        tkey = prng.fold_in(prng.fold_in(prng.PRNGKey(seed), _stable_hash("cost")), 1)
        np.testing.assert_array_equal(prng.randint(tkey, (16, 5), 0, 11).numpy(),
                                      np.asarray(jax.random.randint(key, (16, 5), 0, 11)))
        dist = jnp.asarray(DIST, jnp.float32)
        want = jax.random.categorical(key, jnp.log(dist / jnp.sum(dist)), shape=(16, 5))
        t = torch.tensor(DIST, dtype=torch.float32)
        got = prng.categorical(tkey, torch.log(t / t.sum()), (16, 5))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["nce_uniform", "hsigmoid"])
def test_one_step_lowers_the_cost(case):
    """tests/test_struct_costs.py's check, on the port alone."""
    from paddle_tpu_torch.nn import layers as TL
    from paddle_tpu_torch.nn import struct_costs as TS

    tgraph.reset_name_scope()
    net = tgraph.Network([CASES[case](TS, TL, _data(TL))])
    batch = _batch(case, seed=1)
    params = net.init(batch, device="cpu")
    tp = {k: v.requires_grad_(True) for k, v in params.items()}
    cost = net.apply(tp, batch, train=True, rng=prng.PRNGKey(1))["cost"].value
    grads = torch.autograd.grad(cost, list(tp.values()))
    key = prng.PRNGKey(2)
    l0 = float(net.apply(params, batch, train=True, rng=key)["cost"].value)
    stepped = {k: (v - 0.5 * g).detach() for (k, v), g in zip(tp.items(), grads)}
    l1 = float(net.apply(stepped, batch, train=True, rng=key)["cost"].value)
    assert math.isfinite(l0) and l1 < l0


def test_hsigmoid_is_a_distribution():
    from paddle_tpu_torch.nn import layers as TL
    from paddle_tpu_torch.nn import struct_costs as TS

    tgraph.reset_name_scope()
    x, y = TL.Data("x", shape=(4,)), TL.Data("y", shape=())
    net = tgraph.Network([TS.HierarchicalSigmoid(x, y, num_classes=8, name="hs")])
    xv = np.random.RandomState(2).randn(1, 4).astype(np.float32)
    params = net.init({"x": xv, "y": np.array([0])}, device="cpu")
    params = {k: torch.randn_like(v) for k, v in params.items()}
    total = sum(math.exp(-float(net.apply(params, {"x": xv, "y": np.array([c])})["hs"].value))
                for c in range(8))
    np.testing.assert_allclose(total, 1.0, rtol=1e-5)


# -- cross entropy over beams --------------------------------------------------


BEAM_SCORES = [(3, 4), (3, 6)]
BEAM_SELECTED = [np.array([[1, 3], [0, 2], [2, -1]], np.int32),
                 np.array([[0, 4], [1, 5], [3, 2]], np.int32)]
BEAM_GOLD = [np.array([3, 0, 1], np.int32), np.array([4, 2, 0], np.int32)]


def _beam_inputs(rs):
    return [rs.randn(*s).astype(np.float32) for s in BEAM_SCORES]


def test_cross_entropy_over_beam_matches_jax_and_oracle():
    import jax
    import jax.numpy as jnp

    from test_layers3d_beam import _beam_cost_oracle

    from paddle_tpu.nn import struct_costs as JS
    from paddle_tpu.nn.graph import Argument as JArgument
    from paddle_tpu_torch.nn import struct_costs as TS
    from paddle_tpu_torch.nn.graph import Argument

    scores = _beam_inputs(np.random.RandomState(7))

    def jcost(s0, s1):
        layer = JS.CrossEntropyOverBeam.__new__(JS.CrossEntropyOverBeam)
        layer.name, layer.beams = "beam_ce", [None, None]
        ins = []
        for s, sel, g in zip((s0, s1), BEAM_SELECTED, BEAM_GOLD):
            ins += [JArgument(s), JArgument(jnp.asarray(sel)), JArgument(jnp.asarray(g))]
        return layer.forward(None, ins).value

    want, wg = jax.value_and_grad(jcost, argnums=(0, 1))(*map(jnp.asarray, scores))
    layer = TS.CrossEntropyOverBeam.__new__(TS.CrossEntropyOverBeam)
    layer.name, layer.beams = "beam_ce", [None, None]
    ts = [torch.from_numpy(s).requires_grad_(True) for s in scores]
    ins = []
    for s, sel, g in zip(ts, BEAM_SELECTED, BEAM_GOLD):
        ins += [Argument(s), Argument(torch.from_numpy(sel)), Argument(torch.from_numpy(g))]
    got = layer.forward(None, ins).value
    grads = torch.autograd.grad(got, ts)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    np.testing.assert_allclose(float(got), np.mean(_beam_cost_oracle(
        scores, BEAM_SELECTED, BEAM_GOLD)), rtol=1e-5)
    for g, w in zip(grads, wg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_TOL, atol=GRAD_TOL)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_cost_and_grads_match_cpu(cuda, case):
    from paddle_tpu_torch.nn import layers as TL
    from paddle_tpu_torch.nn import struct_costs as TS

    batch = _batch(case)
    tgraph.reset_name_scope()
    net = tgraph.Network([CASES[case](TS, TL, _data(TL))])
    params = {k: v.numpy() for k, v in net.init(batch, device="cpu").items()}
    for train in (True, False):
        want = _port_cost_and_grads(case, batch, params, train, 3)
        _check(_port_cost_and_grads(case, batch, params, train, 3, device="cuda"), want)
