"""The port's sequence layers (`paddle_tpu_torch/nn/seq_layers.py`) and
sequence ops (`ops/sequence.py`) against the JAX package's, on the CPU,
flat and nested.

Each case builds one layer over data layers in both packages and feeds the
same numpy batch: a flat sequence x [3, 5, 2] with lengths [5, 2, 0], or a
nested one [3, 3, 4, 2] with lengths [3, 1, 2] and sub_lengths
[[4, 2, 1], [3, 0, 0], [1, 4, 0]] (`x.sub_lengths` in the batch), plus the
integer companions some layers take. The output's value, lengths and
sub_lengths must equal the JAX package's (values within 1e-6; integer
outputs exactly), and the gradient with respect to x under a random
cotangent within 1e-6. The ops `context_projection` and `expand_to_seq`
likewise, and `Argument.sub_lengths` is fed, carried by `with_value` and
read by a training step."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.nn import graph as tgraph
from paddle_tpu_torch.nn import layers as TL
from paddle_tpu_torch.nn import seq_layers as TS
from paddle_tpu_torch.ops import sequence as tseq

FLAT = {"x": np.random.RandomState(0).randn(3, 5, 2).astype(np.float32),
        "x.lengths": np.array([5, 2, 0], np.int32)}
NESTED = {"x": np.random.RandomState(1).randn(3, 3, 4, 2).astype(np.float32),
          "x.lengths": np.array([3, 1, 2], np.int32),
          "x.sub_lengths": np.array([[4, 2, 1], [3, 0, 0], [1, 4, 0]], np.int32)}
VEC = {"v": np.random.RandomState(2).randn(3, 2).astype(np.float32)}


def _x(L):
    return L.Data("x", shape=(2,), is_seq=True)


def _ints(name, values):
    return {name: np.asarray(values, np.int32)}


POOLS = ["sum", "avg", "max", "sqrt"]

# name -> (build(L, S) -> layer, batch)
CASES = {}
for _p in POOLS:
    CASES[f"seq_pool_seq_nested_{_p}"] = (
        lambda L, S, p=_p: S.SeqPool(_x(L), p, agg_level="seq", name="out"), NESTED)
    CASES[f"seq_pool_seq_flat_{_p}"] = (
        lambda L, S, p=_p: S.SeqPool(_x(L), p, agg_level="seq", name="out"), FLAT)
    CASES[f"seq_pool_stride_{_p}"] = (
        lambda L, S, p=_p: S.SeqPool(_x(L), p, stride=2, name="out"), FLAT)
for _cls in ("LastSeq", "FirstSeq"):
    CASES[f"{_cls}_flat"] = (lambda L, S, c=_cls: getattr(S, c)(_x(L), name="out"), FLAT)
    CASES[f"{_cls}_nested"] = (lambda L, S, c=_cls: getattr(S, c)(_x(L), name="out"),
                               NESTED)
    CASES[f"{_cls}_nested_seq"] = (
        lambda L, S, c=_cls: getattr(S, c)(_x(L), agg_level="seq", name="out"), NESTED)
    CASES[f"{_cls}_flat_seq"] = (
        lambda L, S, c=_cls: getattr(S, c)(_x(L), agg_level="seq", name="out"), FLAT)
    CASES[f"{_cls}_stride"] = (
        lambda L, S, c=_cls: getattr(S, c)(_x(L), stride=2, name="out"), FLAT)
CASES.update({
    "expand_flat": (lambda L, S: S.Expand(L.Data("v", shape=(2,)), _x(L), name="out"),
                    {**FLAT, **VEC}),
    "expand_nested": (lambda L, S: S.Expand(L.Data("v", shape=(2,)), _x(L), name="out"),
                      {**NESTED, **VEC}),
    "expand_nested_seq_level": (
        lambda L, S: S.Expand(L.Data("v", shape=(2,), is_seq=True), _x(L),
                              expand_level="seq", name="out"),
        {**NESTED, "v": np.random.RandomState(3).randn(3, 3, 2).astype(np.float32),
         "v.lengths": np.array([3, 1, 2], np.int32)}),
    "seq_concat": (
        lambda L, S: S.SeqConcat(_x(L), L.Data("y", shape=(2,), is_seq=True), name="out"),
        {**FLAT, "y": np.random.RandomState(4).randn(3, 3, 2).astype(np.float32),
         "y.lengths": np.array([1, 3, 2], np.int32)}),
    "seq_reshape": (lambda L, S: S.SeqReshape(_x(L), 5, name="out"), FLAT),
    "seq_slice_k_first": (lambda L, S: S.SeqSlice(_x(L), k=3, name="out"), FLAT),
    "seq_slice_k_last": (lambda L, S: S.SeqSlice(_x(L), k=3, from_start=False, name="out"),
                         FLAT),
    "seq_slice_starts_ends": (
        lambda L, S: S.SeqSlice(_x(L), starts=L.Data("s", shape=(2,)),
                                ends=L.Data("e", shape=(2,)), name="out"),
        {**FLAT, **_ints("s", [[0, 2], [1, 0], [0, 0]]), **_ints("e", [[1, 4], [1, 0], [0, 0]])}),
    "seq_slice_starts_only": (
        lambda L, S: S.SeqSlice(_x(L), starts=L.Data("s", shape=(1,)), name="out"),
        {**FLAT, **_ints("s", [[2], [1], [0]])}),
    "seq_slice_nested": (
        lambda L, S: S.SeqSlice(_x(L), starts=L.Data("s", shape=(3,)), name="out"),
        {**NESTED, **_ints("s", [[1, 0, 0], [2, 0, 0], [0, 3, 0]])}),
    "kmax_seq_score_flat": (
        lambda L, S: S.KmaxSeqScore(L.Data("x", shape=(1,), is_seq=True), 3, name="out"),
        {"x": np.random.RandomState(5).randn(3, 5, 1).astype(np.float32),
         "x.lengths": np.array([5, 2, 4], np.int32)}),
    "kmax_seq_score_nested": (
        lambda L, S: S.KmaxSeqScore(L.Data("x", shape=(), is_seq=True), 4, name="out"),
        {"x": np.random.RandomState(6).randn(3, 3, 4).astype(np.float32),
         "x.lengths": NESTED["x.lengths"], "x.sub_lengths": NESTED["x.sub_lengths"]}),
    "sub_seq": (
        lambda L, S: S.SubSeq(_x(L), L.Data("o", shape=(1,)), L.Data("n", shape=(1,)),
                              name="out"),
        {**FLAT, **_ints("o", [[1], [0], [0]]), **_ints("n", [[3], [2], [0]])}),
    "sub_nested_seq": (
        lambda L, S: S.SubNestedSeq(_x(L), L.Data("sel", shape=(2,)), name="out"),
        {**NESTED, **_ints("sel", [[2, 0], [0, -1], [1, -1]])}),
})


def _jax_out(build, batch):
    """(value, lengths, sub_lengths, d value / d x under cot, cot)."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.nn import graph as jgraph
    from paddle_tpu.nn import layers as JL
    from paddle_tpu.nn import seq_layers as JS

    jgraph.reset_name_scope()
    net = jgraph.Network([build(JL, JS)])
    params, states = net.init(jax.random.PRNGKey(0), batch)
    assert not params

    def f(x):
        return net.apply(params, states, dict(batch, x=x))[0]["out"]

    out = f(jnp.asarray(batch["x"]))
    vals = [None if a is None else np.asarray(a)
            for a in (out.value, out.lengths, out.sub_lengths)]
    if not np.issubdtype(vals[0].dtype, np.floating):
        return vals + [None, None]
    cot = np.random.RandomState(9).randn(*vals[0].shape).astype(np.float32)
    _, vjp = jax.vjp(lambda x: f(x).value, jnp.asarray(batch["x"]))
    return vals + [np.asarray(vjp(jnp.asarray(cot))[0]), cot]


def _port_out(build, batch, cot):
    tgraph.reset_name_scope()
    net = tgraph.Network([build(TL, TS)])
    assert net.init(batch, device="cpu") == {}
    x = torch.tensor(batch["x"], requires_grad=cot is not None)
    # no parameters: apply takes its device from this entry
    out = net.apply({"device": x}, dict(batch, x=x))["out"]
    vals = [None if a is None else a.detach().numpy()
            for a in (out.value, out.lengths, out.sub_lengths)]
    if cot is None:
        return vals + [None]
    if not out.value.requires_grad:  # x only shapes the output (Expand's reference)
        return vals + [np.zeros_like(batch["x"])]
    (g,) = torch.autograd.grad(out.value, x, torch.from_numpy(cot))
    return vals + [g.numpy()]


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_jax(case):
    build, batch = CASES[case]
    value, lengths, sub, grad, cot = _jax_out(build, batch)
    got = _port_out(build, batch, cot)
    np.testing.assert_allclose(got[0], value, rtol=1e-6, atol=1e-6)
    assert got[0].dtype == value.dtype
    for g, w in ((got[1], lengths), (got[2], sub)):
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_array_equal(g, w)
    if grad is not None:
        np.testing.assert_allclose(got[3], grad, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("start,length", [(-1, 3), (0, 1), (-2, 2), (1, 2)])
def test_context_projection_matches_jax(start, length):
    import jax
    import jax.numpy as jnp

    from paddle_tpu.ops import sequence as jseq

    x, lens = FLAT["x"], FLAT["x.lengths"]
    want, vjp = jax.vjp(lambda v: jseq.context_projection(v, jnp.asarray(lens), start,
                                                          length), jnp.asarray(x))
    cot = np.random.RandomState(7).randn(*want.shape).astype(np.float32)
    xt = torch.tensor(x, requires_grad=True)
    got = tseq.context_projection(xt, torch.tensor(lens), start, length)
    (g,) = torch.autograd.grad(got, xt, torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]), rtol=1e-6,
                               atol=1e-6)


def test_expand_to_seq_matches_jax():
    import jax.numpy as jnp

    from paddle_tpu.ops import sequence as jseq

    v, lens = VEC["v"], FLAT["x.lengths"]
    want = jseq.expand_to_seq(jnp.asarray(v), jnp.asarray(lens), 5)
    np.testing.assert_array_equal(tseq.expand_to_seq(torch.tensor(v), torch.tensor(lens),
                                                     5).numpy(), np.asarray(want))


def test_sub_lengths_are_fed_carried_and_trained_on():
    """`<name>.sub_lengths` reaches the Argument, `with_value` keeps it, and
    a training step over a nested input runs with it in the batch (and in
    the step's batch signature)."""
    from paddle_tpu_torch.nn import costs as TC
    from paddle_tpu_torch.optim import SGD
    from paddle_tpu_torch.trainer import SGDTrainer
    from paddle_tpu_torch.trainer.trainer import _signature

    arg = tgraph._feed_to_argument(NESTED, TL.Data("x", shape=(2,), is_seq=True),
                                   torch.device("cpu"))
    np.testing.assert_array_equal(arg.sub_lengths.numpy(), NESTED["x.sub_lengths"])
    assert arg.with_value(arg.value * 2).sub_lengths is arg.sub_lengths
    tgraph.reset_name_scope()
    x = TL.Data("x", shape=(2,), is_seq=True)
    h = TL.Fc(x, 3, act="tanh", name="fc")  # per step of the nested batch
    pooled = TS.SeqPool(TS.SeqPool(h, "sum", agg_level="seq", name="sub"), "max",
                        name="pool")
    cost = TC.SquareError(pooled, TL.Data("y", shape=(3,)), name="cost")
    batch = dict(NESTED, y=np.ones((3, 3), np.float32))
    tr = SGDTrainer(cost, SGD(learning_rate=0.1), device="cpu")
    c0 = float(tr.step(batch))
    c1 = float(tr.step(batch))
    assert np.isfinite(c0) and c1 < c0
    assert any(k == "x.sub_lengths" for k, _, _ in _signature(batch))
