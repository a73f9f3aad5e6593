"""The port's cost layers (`paddle_tpu_torch/nn/costs.py`) against the JAX
package's, on the CPU.

Each case builds the same small graph in both packages from the same public
calls: data -> Fc (the only parameters) -> the cost, at B=5, with inputs and
labels drawn from a numpy seed. The JAX parameters move to the port by name
(`nn/convert.params_from_jax`); the cost must agree within 1e-5 relative and
every gradient within rtol 1e-5 / atol 1e-6 x max(1, max|g|) (f32 on both
sides; only the order of the sums differs).

The cases cover every cost class, the optional `weight` input and `coeff=`
of `CostLayer`, `ClassificationCost(from_logits=False)`, id labels against
the regression costs (one-hot), sequence predictions against sequence
labels, and against one label per sequence: the JAX package broadcasts that
label over the valid steps (`test_sequence_cost_broadcasts_one_label`, the
input ROADMAP.md's fault 1 names; the port raised before)."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.nn import costs as TC
from paddle_tpu_torch.nn import graph as tgraph
from paddle_tpu_torch.nn import layers as TL
from paddle_tpu_torch.nn.convert import params_from_jax

B, D = 5, 4


def _feats(rs, seq=False):
    if seq:
        return {"x": rs.randn(B, 6, D).astype(np.float32),
                "x.lengths": np.array([6, 1, 4, 3, 5], np.int32)}
    return {"x": rs.randn(B, D).astype(np.float32)}


def _x(L, seq=False):
    return L.Data("x", shape=(D,), is_seq=seq)


def _weighted(L, C):
    return C.ClassificationCost(L.Fc(_x(L), 6, act=None, name="fc"),
                                L.Data("y", shape=()), weight=L.Data("w", shape=(1,)),
                                coeff=0.5, name="cost")


def _rank(L, C, x):
    return C.RankCost(L.Fc(x, 1, act=None, name="left"), L.Fc(x, 1, act=None, name="right"),
                      L.Data("y", shape=()), weight=L.Data("w", shape=(1,)), coeff=1.5,
                      name="cost")


# name -> (build(L, C) -> cost layer, batch(rs) -> feed dict)
CASES = {
    "classification": (
        lambda L, C: C.ClassificationCost(L.Fc(_x(L), 6, act=None, name="fc"),
                                          L.Data("y", shape=()), name="cost"),
        lambda rs: dict(_feats(rs), y=rs.randint(0, 6, B))),
    "classification_weight_coeff": (
        _weighted,
        lambda rs: dict(_feats(rs), y=rs.randint(0, 6, B),
                        w=rs.rand(B, 1).astype(np.float32))),
    "classification_probabilities": (
        lambda L, C: C.ClassificationCost(L.Fc(_x(L), 6, act="softmax", name="fc"),
                                          L.Data("y", shape=()), from_logits=False,
                                          name="cost"),
        lambda rs: dict(_feats(rs), y=rs.randint(0, 6, B))),
    "classification_seq_labels": (
        lambda L, C: C.ClassificationCost(L.Fc(_x(L, True), 6, act=None, name="fc"),
                                          L.Data("y", shape=(), is_seq=True), name="cost"),
        lambda rs: dict(_feats(rs, True), y=rs.randint(0, 6, (B, 6)),
                        **{"y.lengths": np.array([6, 1, 4, 3, 5], np.int32)})),
    "soft_binary_cross_entropy": (
        lambda L, C: C.SoftBinaryCrossEntropy(L.Fc(_x(L), 3, act="sigmoid", name="fc"),
                                              L.Data("y", shape=(3,)), name="cost"),
        lambda rs: dict(_feats(rs), y=rs.rand(B, 3).astype(np.float32))),
    "square_error": (
        lambda L, C: C.SquareError(L.Fc(_x(L), 3, act=None, name="fc"),
                                   L.Data("y", shape=(3,)), coeff=2.0, name="cost"),
        lambda rs: dict(_feats(rs), y=rs.randn(B, 3).astype(np.float32))),
    "square_error_id_label": (
        lambda L, C: C.SquareError(L.Fc(_x(L), 3, act=None, name="fc"),
                                   L.Data("y", shape=()), name="cost"),
        lambda rs: dict(_feats(rs), y=rs.randint(0, 3, B))),
    "square_error_seq": (
        lambda L, C: C.SquareError(L.Fc(_x(L, True), 2, act=None, name="fc"),
                                   L.Data("y", shape=(2,), is_seq=True), name="cost"),
        lambda rs: dict(_feats(rs, True), y=rs.randn(B, 6, 2).astype(np.float32),
                        **{"y.lengths": np.array([6, 1, 4, 3, 5], np.int32)})),
    "cross_entropy_with_selfnorm": (
        lambda L, C: C.CrossEntropyWithSelfNorm(L.Fc(_x(L), 6, act=None, name="fc"),
                                                L.Data("y", shape=()),
                                                softmax_selfnorm_alpha=0.3, name="cost"),
        lambda rs: dict(_feats(rs), y=rs.randint(0, 6, B))),
    "huber_regression": (
        lambda L, C: C.HuberRegression(L.Fc(_x(L), 3, act=None, name="fc"),
                                       L.Data("y", shape=(3,)), delta=0.5, name="cost"),
        lambda rs: dict(_feats(rs), y=rs.randn(B, 3).astype(np.float32) * 2)),
    "huber_two_classification": (
        lambda L, C: C.HuberTwoClassification(L.Fc(_x(L), 1, act=None, name="fc"),
                                              L.Data("y", shape=()), name="cost"),
        lambda rs: dict({"x": rs.randn(B, D).astype(np.float32) * 3},
                        y=rs.randint(0, 2, B))),
    "rank_cost": (
        lambda L, C: _rank(L, C, _x(L)),
        lambda rs: dict(_feats(rs), y=rs.rand(B).astype(np.float32),
                        w=rs.rand(B, 1).astype(np.float32))),
    "multi_binary_label_cross_entropy": (
        lambda L, C: C.MultiBinaryLabelCrossEntropy(L.Fc(_x(L), 5, act=None, name="fc"),
                                                    L.Data("y", shape=(5,)), name="cost"),
        lambda rs: dict(_feats(rs), y=(rs.rand(B, 5) > 0.5).astype(np.float32))),
    "sum_cost": (
        lambda L, C: C.SumCost(L.Fc(_x(L), 3, act="tanh", name="fc"), coeff=2.0,
                               name="cost"),
        lambda rs: _feats(rs)),
    "smooth_l1": (
        lambda L, C: C.SmoothL1(L.Fc(_x(L), 3, act=None, name="fc"),
                                L.Data("y", shape=(3,)), name="cost"),
        lambda rs: dict(_feats(rs), y=rs.randn(B, 3).astype(np.float32) * 2)),
}


def jax_cost_and_grads(build, batch):
    """(cost, {name: grad}, {name: param}) of the JAX graph, numpy."""
    import jax

    from paddle_tpu.nn import costs as JC
    from paddle_tpu.nn import layers as JL
    from paddle_tpu.nn.graph import Network, reset_name_scope

    reset_name_scope()
    cost = build(JL, JC)
    net = Network([cost])
    params, states = net.init(jax.random.PRNGKey(0), batch)

    def loss(p):
        return net.apply(p, states, batch, train=True)[0][cost.name].value

    c, g = jax.value_and_grad(loss)(params)
    return (float(c), {k: np.asarray(v) for k, v in g.items()},
            {k: np.asarray(v) for k, v in params.items()})


def port_cost_and_grads(build, batch, jax_params):
    tgraph.reset_name_scope()
    cost = build(TL, TC)
    net = tgraph.Network([cost])
    own = net.init(batch, device="cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: v.shape for k, v in jax_params.items()}
    params = {k: v.requires_grad_(True)
              for k, v in params_from_jax(jax_params, device="cpu").items()}
    c = net.apply(params, batch)[cost.name].value
    names = sorted(params)
    grads = torch.autograd.grad(c, [params[k] for k in names])
    return float(c.detach()), {k: g.numpy() for k, g in zip(names, grads)}


def assert_match(cj, gj, ct, gt):
    assert np.isfinite(cj)
    assert abs(ct - cj) <= 1e-5 * abs(cj), (ct, cj)
    assert sorted(gt) == sorted(gj)
    for k, g in gj.items():
        np.testing.assert_allclose(gt[k], g, rtol=1e-5,
                                   atol=1e-6 * max(1.0, float(np.abs(g).max())), err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cost_matches_jax(case):
    build, make = CASES[case]
    batch = make(np.random.RandomState(sorted(CASES).index(case)))
    cj, gj, params = jax_cost_and_grads(build, batch)
    ct, gt = port_cost_and_grads(build, batch, params)
    assert_match(cj, gj, ct, gt)


def test_sequence_cost_broadcasts_one_label():
    """ROADMAP.md's fault 1: a sequence prediction against one label per
    sequence. x [3, 5, 4], lengths [5, 3, 2], y [3, 1] from RandomState(0)."""
    rs = np.random.RandomState(0)
    batch = {"x": rs.randn(3, 5, 4).astype(np.float32),
             "x.lengths": np.array([5, 3, 2], np.int32),
             "y": rs.randint(0, 6, (3, 1))}

    def build(L, C):
        return C.ClassificationCost(L.Fc(L.Data("x", shape=(4,), is_seq=True), 6,
                                         act=None, name="fc"),
                                    L.Data("y", shape=(6,)), name="cost")

    cj, gj, params = jax_cost_and_grads(build, batch)
    ct, gt = port_cost_and_grads(build, batch, params)
    assert_match(cj, gj, ct, gt)


def test_cost_arguments_of_the_reference_are_taken():
    """`weight=`, `coeff=` and `from_logits=` as keywords, with the JAX
    package's meaning: coeff scales the cost, a weight of 0 drops a row."""
    rs = np.random.RandomState(3)
    batch = dict(_feats(rs), y=rs.randint(0, 6, B), w=np.ones((B, 1), np.float32))
    tgraph.reset_name_scope()
    cost = _weighted(TL, TC)
    assert (cost.coeff, cost.has_weight, len(cost.inputs)) == (0.5, True, 3)
    net = tgraph.Network([cost])
    params = net.init(batch, device="cpu")
    full = float(net.apply(params, batch)["cost"].value)
    batch["w"][0] = 0.0
    dropped = float(net.apply(params, batch)["cost"].value)
    tgraph.reset_name_scope()
    plain = TC.ClassificationCost(TL.Fc(_x(TL), 6, act=None, name="fc"),
                                  TL.Data("y", shape=()), name="cost")
    unweighted = float(tgraph.Network([plain]).apply(params, batch)["cost"].value)
    assert abs(full - 0.5 * unweighted) <= 1e-6 * abs(full)
    assert dropped < full
    assert plain.from_logits
    assert not TC.ClassificationCost(TL.Fc(_x(TL), 6), TL.Data("y"),
                                     from_logits=False).from_logits
