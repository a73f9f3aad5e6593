"""Every fluid op of the port against the JAX package's, one case each.

Both registries hold the same 102 names. Each case feeds the same seeded
numpy inputs and attrs to the JAX op function and to the port's (on the
CPU) and compares every output slot: floats within rtol 1e-5 / atol 1e-6
unless the case states otherwise, integers and booleans exactly (values,
not dtypes: 64-bit ids reach both packages as int32). Random ops draw
from the same key on both sides (`core/prng.py`: jax's threefry bits), so
dropout masks and uniform draws are equal bit for bit; normal draws agree
to float32 rounding of erfinv (atol 5e-5 at |x| up to ~4.5).

`linear_chain_crf`: the JAX package's op calls a function its `ops/crf.py`
does not have (ROADMAP.md §3 fault 17), so the port's op is held against
the JAX package's `crf_nll` on the same inputs, and the JAX op's failure
is pinned."""

from typing import Any, Dict, List, NamedTuple

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import prng
from paddle_tpu_torch.fluid import lod as tlod
from paddle_tpu_torch.fluid import ops as tops

F32 = np.float32


class Lod(NamedTuple):
    data: np.ndarray
    lengths: List[int]


class Sel(NamedTuple):
    rows: np.ndarray
    value: np.ndarray
    height: int


def f(rs, *shape, lo=None, scale=1.0):
    x = (rs.randn(*shape) * scale).astype(F32)
    return np.abs(x) + lo if lo is not None else x


def lod(rs, lengths, d):
    return Lod(f(rs, sum(lengths), d), list(lengths))


def _elementwise(rs):
    return {"X": [f(rs, 2, 3, 4)], "Y": [f(rs, 3)]}, {"axis": 1}


def _positive(rs):
    return {"X": [f(rs, 2, 3, 4, lo=0.5)], "Y": [f(rs, 3, lo=0.2)]}, {"axis": 1}


def _unary(rs):
    return {"X": [f(rs, 3, 5)]}, {}


def _unary_pos(rs):
    return {"X": [f(rs, 3, 5, lo=0.1)]}, {}


def _opt_common(rs, n=6):
    return {"Param": [f(rs, n)], "Grad": [f(rs, n)],
            "LearningRate": [np.asarray(0.1, F32)]}


CASES: Dict[str, Any] = {}
for _n in ("elementwise_add", "elementwise_sub", "elementwise_mul", "elementwise_max",
           "elementwise_min"):
    CASES[_n] = _elementwise
CASES["elementwise_div"] = _positive
CASES["elementwise_pow"] = _positive
for _n in ("relu", "sigmoid", "tanh", "abs", "exp", "square", "softsign", "soft_relu"):
    CASES[_n] = _unary
for _n in ("sqrt", "log", "reciprocal"):
    CASES[_n] = _unary_pos

CASES.update({
    "brelu": lambda rs: ({"X": [f(rs, 4, 5, scale=3)]}, {"t_min": -1.0, "t_max": 2.0}),
    "leaky_relu": lambda rs: ({"X": [f(rs, 4, 5)]}, {"alpha": 0.1}),
    "mul": lambda rs: ({"X": [f(rs, 2, 3, 4)], "Y": [f(rs, 4, 5)]},
                       {"x_num_col_dims": 2}),
    "matmul": lambda rs: ({"X": [f(rs, 2, 3, 4)], "Y": [f(rs, 2, 5, 4)]},
                          {"transpose_Y": True}),
    "reshape": lambda rs: ({"X": [f(rs, 2, 6)]}, {"shape": [3, -1]}),
    "transpose": lambda rs: ({"X": [f(rs, 2, 3, 4)]}, {"axis": [2, 0, 1]}),
    "concat": lambda rs: ({"X": [f(rs, 2, 3), f(rs, 4, 3)]}, {"axis": 0}),
    "split": lambda rs: ({"X": [f(rs, 4, 6)]}, {"axis": 1, "sections": [2, 4]}),
    "slice": lambda rs: ({"X": [f(rs, 4, 5)]},
                         {"axes": [0, 1], "starts": [1, 0], "ends": [3, 4]}),
    "cast": lambda rs: ({"X": [f(rs, 3, 4, scale=5)]}, {"dtype": np.int32}),
    "scale": lambda rs: ({"X": [f(rs, 3, 4)]}, {"scale": 2.5}),
    "mean": lambda rs: ({"X": [f(rs, 3, 4)]}, {}),
    "sum": lambda rs: ({"X": [f(rs, 3, 4), f(rs, 3, 4), f(rs, 3, 4)]}, {}),
    "reduce_sum": lambda rs: ({"X": [f(rs, 3, 4, 2)]}, {"dim": 1, "keep_dim": True}),
    "reduce_mean": lambda rs: ({"X": [f(rs, 3, 4)]}, {"dim": 0}),
    # ties: lax.top_k puts the lower index first
    "top_k": lambda rs: ({"X": [rs.randint(0, 3, (4, 7)).astype(F32)]}, {"k": 3}),
    "accuracy": lambda rs: ({"Indices": [rs.randint(0, 4, (6, 2)).astype(np.int32)],
                             "Label": [rs.randint(0, 4, (6, 1))]}, {}),
    "softmax": lambda rs: ({"X": [f(rs, 3, 5)]}, {}),
    "cross_entropy": lambda rs: ({"X": [_probs(rs, 4, 5)],
                                  "Label": [rs.randint(0, 5, (4, 1))]}, {}),
    "softmax_with_cross_entropy": lambda rs: ({"Logits": [f(rs, 4, 5)],
                                               "Label": [rs.randint(0, 5, (4, 1))]}, {}),
    "conv2d": lambda rs: ({"Input": [f(rs, 2, 3, 8, 8)], "Filter": [f(rs, 4, 3, 3, 3)]},
                          {"strides": [2, 1], "paddings": [1, 1]}),
    # the average divides by the full window, padding included
    "pool2d": lambda rs: ({"X": [f(rs, 2, 3, 7, 7)]},
                          {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1],
                           "pooling_type": "avg"}),
    "batch_norm": lambda rs: ({"X": [f(rs, 4, 3, 5, 5)], "Scale": [f(rs, 3)],
                               "Bias": [f(rs, 3)], "Mean": [f(rs, 3)],
                               "Variance": [f(rs, 3, lo=0.5)]}, {"momentum": 0.8}),
    "dropout": lambda rs: ({"X": [f(rs, 6, 16)]}, {"dropout_prob": 0.3}),
    # [N, 1] id column: only the trailing 1 is squeezed
    "lookup_table": lambda rs: ({"W": [f(rs, 10, 4)],
                                 "Ids": [rs.randint(0, 10, (6, 1)).astype(np.int64)]}, {}),
    "layer_norm": lambda rs: ({"X": [f(rs, 3, 6)], "Scale": [f(rs, 6)],
                               "Bias": [f(rs, 6)]}, {}),
    "fill_constant": lambda rs: ({}, {"shape": [2, 3], "value": 1.5, "dtype": np.float32}),
    "uniform_random": lambda rs: ({}, {"shape": [64], "min": -0.3, "max": 0.7}),
    "gaussian_random": lambda rs: ({}, {"shape": [128], "mean": 1.0, "std": 2.0}),
    "less_than": lambda rs: ({"X": [f(rs, 5)], "Y": [f(rs, 5)]}, {}),
    "increment": lambda rs: ({"X": [f(rs, 3)]}, {"step": 2.0}),
    "sgd": lambda rs: (_opt_common(rs), {}),
    "momentum": lambda rs: ({**_opt_common(rs), "Velocity": [f(rs, 6)]},
                            {"mu": 0.8, "use_nesterov": True}),
    "adam": lambda rs: ({**_opt_common(rs), "Moment1": [f(rs, 6)],
                         "Moment2": [f(rs, 6, lo=0.1)], "Beta1Pow": [np.asarray(0.81, F32)],
                         "Beta2Pow": [np.asarray(0.998, F32)]}, {"epsilon": 1e-6}),
    "adagrad": lambda rs: ({**_opt_common(rs), "Moment": [f(rs, 6, lo=0.1)]}, {}),
    "rmsprop": lambda rs: ({**_opt_common(rs), "MeanSquare": [f(rs, 6, lo=0.1)],
                            "Moment": [f(rs, 6)]}, {"momentum": 0.5}),
    "minus": lambda rs: ({"X": [f(rs, 3, 4)], "Y": [f(rs, 3, 4)]}, {}),
    "sign": lambda rs: ({"X": [f(rs, 3, 4)]}, {}),
    "clip": lambda rs: ({"X": [f(rs, 3, 4)]}, {"min": -0.5, "max": 0.5}),
    "fill_zeros_like": lambda rs: ({"X": [f(rs, 3, 4)]}, {}),
    "fill_constant_batch_size_like": lambda rs: ({"Input": [f(rs, 5, 3)]},
                                                 {"shape": [1, 7], "value": 2.0}),
    "gather": lambda rs: ({"X": [f(rs, 6, 3)], "Index": [np.asarray([4, 0, 4, 2])]}, {}),
    # duplicate rows add up
    "scatter": lambda rs: ({"Ref": [f(rs, 6, 3)], "Index": [np.asarray([1, 3, 1, 5])],
                            "Updates": [f(rs, 4, 3)]}, {}),
    "multiplex": lambda rs: ({"Ids": [rs.randint(0, 3, (4, 1))],
                              "X": [f(rs, 4, 5), f(rs, 4, 5), f(rs, 4, 5)]}, {}),
    "pad": lambda rs: ({"X": [f(rs, 2, 3)]}, {"paddings": [1, 0, 0, 2], "pad_value": 0.5}),
    "crop": lambda rs: ({"X": [f(rs, 4, 5)]}, {"offsets": [1, 1], "shape": [2, 3]}),
    "prelu": lambda rs: ({"X": [f(rs, 3, 4)], "Alpha": [np.asarray([0.2], F32)]}, {}),
    "conv_shift": lambda rs: ({"X": [f(rs, 2, 7)], "Y": [f(rs, 2, 3)]}, {}),
    "cos_sim": lambda rs: ({"X": [f(rs, 4, 5)], "Y": [f(rs, 4, 5)]}, {}),
    "lrn": lambda rs: ({"X": [f(rs, 2, 6, 3, 3)]}, {"n": 5}),
    "pool_with_index": lambda rs: ({"X": [f(rs, 2, 2, 6, 6)]},
                                   {"ksize": [2, 3], "strides": [2, 2]}),
    "huber_loss": lambda rs: ({"X": [f(rs, 6, 1)], "Y": [f(rs, 6, 1, scale=2)]},
                              {"delta": 0.7}),
    "modified_huber_loss": lambda rs: ({"X": [f(rs, 6, 1, scale=2)],
                                        "Y": [rs.randint(0, 2, (6, 1)).astype(F32)]}, {}),
    "rank_loss": lambda rs: ({"Label": [rs.randint(0, 2, (5, 1)).astype(F32)],
                              "Left": [f(rs, 5, 1)], "Right": [f(rs, 5, 1)]}, {}),
    "margin_rank_loss": lambda rs: ({"Label": [np.sign(f(rs, 5, 1))], "X1": [f(rs, 5, 1)],
                                     "X2": [f(rs, 5, 1)]}, {"margin": 0.1}),
    "smooth_l1_loss": lambda rs: ({"X": [f(rs, 4, 3)], "Y": [f(rs, 4, 3)],
                                   "InsideWeight": [f(rs, 4, 3, lo=0.5)],
                                   "OutsideWeight": [f(rs, 4, 3, lo=0.5)]}, {"sigma": 2.0}),
    "squared_l2_distance": lambda rs: ({"X": [f(rs, 4, 3)], "Y": [f(rs, 4, 3)]}, {}),
    "squared_l2_norm": lambda rs: ({"X": [f(rs, 4, 3)]}, {}),
    "l1_norm": lambda rs: ({"X": [f(rs, 4, 3)]}, {}),
    "sigmoid_cross_entropy_with_logits": lambda rs: ({"X": [f(rs, 4, 3, scale=3)],
                                                      "Label": [rs.rand(4, 3).astype(F32)]},
                                                     {}),
    "linear_chain_crf": lambda rs: ({"Emission": [f(rs, 2, 5, 4)],
                                     "Transition": [f(rs, 6, 4, scale=0.5)],
                                     "Label": [rs.randint(0, 4, (2, 5))]}, {}),
    "lstm_unit": lambda rs: ({"X": [f(rs, 3, 16)], "C_prev": [f(rs, 3, 4)]},
                             {"forget_bias": 1.0}),
    "gru_unit": lambda rs: ({"Input": [f(rs, 3, 12)], "HiddenPrev": [f(rs, 3, 4)],
                             "Weight": [f(rs, 4, 12, scale=0.3)], "Bias": [f(rs, 1, 12)]},
                            {}),
    "lstm": lambda rs: ({"Input": [f(rs, 3, 5, 16, scale=0.5)],
                         "Weight": [f(rs, 4, 16, scale=0.3)], "Bias": [f(rs, 16, scale=0.1)],
                         "SeqLengths": [np.asarray([5, 3, 4], np.int32)]},
                        {"is_reverse": True}),
    "conv2d_transpose": lambda rs: ({"Input": [f(rs, 2, 3, 4, 4)],
                                     "Filter": [f(rs, 3, 2, 3, 3)]},
                                    {"strides": [2, 2], "paddings": [1, 1]}),
    "sequence_pool": lambda rs: ({"X": [lod(rs, [3, 1, 4], 2)]}, {"pooltype": "MAX"}),
    "sequence_softmax": lambda rs: ({"X": [lod(rs, [3, 1, 4], 1)]}, {}),
    "sequence_concat": lambda rs: ({"X": [lod(rs, [2, 1, 3], 2), lod(rs, [1, 2, 2], 2)]},
                                   {}),
    "seq_expand": lambda rs: ({"X": [f(rs, 3, 2)], "Y": [lod(rs, [2, 3, 1], 1)]}, {}),
    "sequence_conv": lambda rs: ({"X": [lod(rs, [3, 1, 4], 3)], "Filter": [f(rs, 9, 4)]},
                                 {"contextLength": 3}),
    # duplicated rows add up
    "sgd_sparse": lambda rs: ({"Param": [f(rs, 6, 3)],
                               "Grad": [Sel(np.asarray([1, 3, 1], np.int32), f(rs, 3, 3), 6)],
                               "LearningRate": [np.asarray(0.5, F32)]}, {}),
    "adamax": lambda rs: ({**_opt_common(rs), "Moment": [f(rs, 6)],
                           "InfNorm": [f(rs, 6, lo=0.1)],
                           "Beta1Pow": [np.asarray(0.81, F32)]}, {}),
    "adadelta": lambda rs: ({"Param": [f(rs, 6)], "Grad": [f(rs, 6)],
                             "AvgSquaredGrad": [f(rs, 6, lo=0.1)],
                             "AvgSquaredUpdate": [f(rs, 6, lo=0.1)]}, {}),
    "decayed_adagrad": lambda rs: ({**_opt_common(rs), "Moment": [f(rs, 6, lo=0.1)]}, {}),
    "proximal_gd": lambda rs: (_opt_common(rs), {"l1": 0.1, "l2": 0.2}),
    "proximal_adagrad": lambda rs: ({**_opt_common(rs), "Moment": [f(rs, 6, lo=0.1)]},
                                    {"l1": 0.1, "l2": 0.2}),
    "auc": lambda rs: ({"Out": [_probs(rs, 20, 2)], "Label": [rs.randint(0, 2, (20, 1))]},
                       {}),
    "precision_recall": lambda rs: ({"MaxProbs": [rs.rand(10, 1).astype(F32)],
                                     "Indices": [rs.randint(0, 3, (10, 1))],
                                     "Labels": [rs.randint(0, 3, (10, 1))]},
                                    {"class_number": 3}),
    "feed": lambda rs: ({"X": [[f(rs, 2), f(rs, 3)]]}, {"col": 1}),
    "fetch": lambda rs: ({"X": [f(rs, 2, 2)], "Holder": [[]]}, {"col": 1}),
    "save": lambda rs: ({"X": [f(rs, 2, 3)]}, {"file_path": "saved"}),
    "load": lambda rs: ({}, {"file_path": "to_load"}),
    # beam 1 has finished (EOS 0); probabilities in, not accumulated
    "beam_search": lambda rs: ({"pre_ids": [np.asarray([[3], [0], [2], [4]])],
                                "pre_scores": [f(rs, 4, 1)],
                                "scores": [_probs(rs, 4, 5)]},
                               {"beam_size": 2, "end_id": 0, "is_accumulated": False}),
    "beam_search_decode": lambda rs: ({"Ids": [rs.randint(0, 9, (3, 4))],
                                       "ParentIdx": [np.asarray([[0, 0, 2, 3], [1, 0, 3, 3],
                                                                 [0, 1, 2, 2]])],
                                       "Scores": [f(rs, 4)]}, {"beam_size": 2}),
})

ATOL = {"gaussian_random": 5e-5}


def _probs(rs, n, c):
    e = np.exp(rs.randn(n, c))
    return (e / e.sum(-1, keepdims=True)).astype(F32)


def _jax_value(v):
    import jax.numpy as jnp
    from paddle_tpu.fluid import lod as jlod

    if isinstance(v, Lod):
        return jlod.LoDTensor(jnp.asarray(v.data), (jlod.lod_from_lengths(v.lengths),))
    if isinstance(v, Sel):
        return jlod.SelectedRows(jnp.asarray(v.rows), jnp.asarray(v.value), v.height)
    if isinstance(v, list):
        return list(v)  # a python holder (feed / fetch)
    return jnp.asarray(v)


def _port_value(v):
    cpu = torch.device("cpu")
    if isinstance(v, Lod):
        return tlod.LoDTensor(tops.as_tensor(v.data, cpu), (tlod.lod_from_lengths(v.lengths),))
    if isinstance(v, Sel):
        return tlod.SelectedRows(torch.as_tensor(v.rows), torch.as_tensor(v.value), v.height)
    if isinstance(v, list):
        return list(v)
    return tops.as_tensor(v, cpu)


def _leaves(v) -> List[np.ndarray]:
    """An op output as host arrays: a LoDTensor's data and offsets, each
    element of a list."""
    if hasattr(v, "lod") and hasattr(v, "data"):
        return _leaves(v.data) + [np.asarray(o) for o in v.lod]
    if isinstance(v, (list, tuple)):
        return [a for x in v for a in _leaves(x)]
    if isinstance(v, torch.Tensor):
        return [v.detach().numpy()]
    return [np.asarray(v)]


def _run_pair(name, tmp_path):
    import jax
    from paddle_tpu.fluid import ops as jops

    rs = np.random.RandomState(sum(map(ord, name)))
    ins, attrs = CASES[name](rs)
    attrs = dict(attrs)
    jattrs, tattrs = dict(attrs), dict(attrs)
    if name in ("save", "load"):
        if name == "load":
            np.save(tmp_path / "to_load.npy", f(rs, 3, 2))
            jattrs["file_path"] = tattrs["file_path"] = str(tmp_path / "to_load")
        else:
            jattrs["file_path"] = str(tmp_path / "jax_saved.npy")
            tattrs["file_path"] = str(tmp_path / "port_saved.npy")
    jins = {k: [_jax_value(v) for v in vs] for k, vs in ins.items()}
    tins = {k: [_port_value(v) for v in vs] for k, vs in ins.items()}
    jctx = jops.OpContext(rng=jax.random.PRNGKey(7))
    tctx = tops.OpContext(rng=prng.PRNGKey(7), device="cpu")
    if name == "linear_chain_crf":
        from paddle_tpu.ops import crf as jcrf

        with pytest.raises(AttributeError, match="crf_log_likelihood"):
            jops.OPS.get(name)(jctx, jins, jattrs)
        em, tr, lb = (ins[k][0] for k in ("Emission", "Transition", "Label"))
        want = {"LogLikelihood": jcrf.crf_nll(
            _jax_value(em), _jax_value(np.full(2, 5, np.int32)), _jax_value(lb),
            _jax_value(tr))}
    else:
        want = jops.OPS.get(name)(jctx, jins, jattrs)
    got = tops.OPS.get(name)(tctx, tins, tattrs)
    return want, got, jins, tins, jattrs, tattrs


def test_registries_hold_the_same_ops():
    from paddle_tpu.fluid.ops import OPS as JOPS

    assert len(tops.OPS.names()) == 102
    assert tops.OPS.names() == JOPS.names() == sorted(CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name, tmp_path):
    want, got, jins, tins, jattrs, tattrs = _run_pair(name, tmp_path)
    assert set(got) == set(want), (sorted(got), sorted(want))
    for slot in want:
        ws, gs = _leaves(want[slot]), _leaves(got[slot])
        assert len(ws) == len(gs), slot
        for w, g in zip(ws, gs):
            assert w.shape == g.shape, (slot, w.shape, g.shape)
            if w.dtype.kind in "fc":
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=ATOL.get(name, 1e-6),
                                           err_msg=f"{name}.{slot}")
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{name}.{slot}")
    if name == "save":
        np.testing.assert_array_equal(np.load(tattrs["file_path"]),
                                      np.load(jattrs["file_path"]))
    if name == "fetch":
        np.testing.assert_allclose(_leaves(tins["Holder"][0][1])[0],
                                   np.asarray(jins["Holder"][0][1]))


def test_dropout_mask_is_jax_bitwise():
    want, got, *_ = _run_pair("dropout", None)
    np.testing.assert_array_equal(got["Mask"].numpy(), np.asarray(want["Mask"]))
    assert 0 < (got["Mask"].numpy() == 0).mean() < 1


def test_uniform_random_is_jax_bitwise():
    want, got, *_ = _run_pair("uniform_random", None)
    np.testing.assert_array_equal(got["Out"].numpy(), np.asarray(want["Out"]))


def test_sgd_sparse_adds_duplicate_rows():
    p = torch.zeros(4, 1)
    g = tlod.SelectedRows(torch.tensor([1, 3, 1]), torch.tensor([[1.0], [2.0], [10.0]]), 4)
    out = tops.OPS.get("sgd_sparse")(tops.OpContext(device="cpu"),
                                     {"Param": [p], "Grad": [g],
                                      "LearningRate": [torch.tensor(1.0)]}, {})
    np.testing.assert_allclose(out["ParamOut"][:, 0].numpy(), [0.0, -11.0, 0.0, -2.0])


def test_op_context_needs_a_device_only_to_make_a_tensor():
    ctx = tops.OpContext()  # device None: CUDA, resolved at first use
    out = tops.OPS.get("relu")(ctx, {"X": [torch.tensor([-1.0, 2.0])]}, {})
    np.testing.assert_allclose(out["Y"].numpy(), [0.0, 2.0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tops.OPS.get("fill_constant")(ctx, {}, {"shape": [2]})


def test_lod_helpers_match_jax():
    """lod_from_lengths, seq_lengths, segment_ids, to_padded / from_padded
    and SelectedRows.to_dense (duplicates add up) equal the JAX package's."""
    from paddle_tpu.fluid import lod as jlod

    rs = np.random.RandomState(5)
    lengths = [3, 1, 4, 2]
    data = f(rs, sum(lengths), 2)
    jt = jlod.LoDTensor(_jax_value(data), (jlod.lod_from_lengths(lengths),))
    tt = _port_value(Lod(data, lengths))
    np.testing.assert_array_equal(tt.lod[0].numpy(), np.asarray(jt.lod[0]))
    np.testing.assert_array_equal(tt.seq_lengths().numpy(), np.asarray(jt.seq_lengths()))
    np.testing.assert_array_equal(tt.segment_ids().numpy(), np.asarray(jt.segment_ids()))
    assert tt.num_sequences == jt.num_sequences == 4
    for max_len in (4, 6):
        jp, jl = jlod.to_padded(jt, max_len)
        tp, tl = tlod.to_padded(tt, max_len)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    back = tlod.from_padded(tp.numpy(), tl.numpy())
    np.testing.assert_array_equal(back.data.numpy(), data)
    np.testing.assert_array_equal(back.lod[-1].numpy(), np.asarray(jt.lod[-1]))
    rows, value = np.asarray([1, 3, 1], np.int32), f(rs, 3, 2)
    np.testing.assert_array_equal(
        tlod.SelectedRows(torch.as_tensor(rows), torch.as_tensor(value), 5).to_dense().numpy(),
        np.asarray(jlod.SelectedRows(_jax_value(rows), _jax_value(value), 5).to_dense()))
