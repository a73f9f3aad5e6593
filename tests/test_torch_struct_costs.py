"""The port's CTC and CRF (`paddle_tpu_torch/ops/ctc.py`, `ops/crf.py`,
`nn/struct_costs.py`) against the JAX package's and against brute force,
on the CPU.

  * Twins of tests/test_struct_costs.py: `ctc_loss` and `crf_nll` against
    exhaustive path enumeration on tiny instances (1e-4, the JAX tests'
    tolerance), `crf_decode` against the best path by enumeration, padded
    rows against their standalone values, the greedy CTC decode.
  * Against the JAX package on the same numpy inputs: `ctc_loss` (both
    `norm_by_times`, label lengths 0 to L with repeated labels, a row with
    T = 2L + 1 frames, rows shorter than the padded T) and `crf_nll`:
    values within 1e-5 relative, gradients within 1e-5 x max(1, max|g|);
    `ctc_greedy_decode` and `crf_decode` equal.
  * Gradients stay finite where every alpha path dies (label length 0,
    repeated labels, T = 2L + 1): `_logadd`'s clamp.
  * The layers `CTCCost`, `CRFCost` and `CRFDecoding` (with and without a
    label) in a graph against the JAX package's, parameters copied by
    name: costs 1e-5 relative, gradients rtol 1e-5 / atol 1e-6 x max|g|.
  * On a card (marked `cuda`, skipped here): `ctc_loss`, `crf_nll` and
    their gradients against the CPU, `crf_decode` equal, and both losses
    with their backward captured in a CUDA graph whose replay equals the
    eager run within 1e-6 (no host read inside; the gathers' backward adds
    with atomics, so not bit for bit).
jax is imported inside the CPU tests only."""

import itertools
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core.stack_trace import LayerError
from paddle_tpu_torch.nn import graph as tgraph
from paddle_tpu_torch.nn import layers as TL
from paddle_tpu_torch.nn import struct_costs as TS
from paddle_tpu_torch.nn.convert import params_from_jax
from paddle_tpu_torch.ops import crf as tcrf
from paddle_tpu_torch.ops import ctc as tctc


def _log_softmax(x):
    m = x.max(-1, keepdims=True)
    return x - m - np.log(np.exp(x - m).sum(-1, keepdims=True))


def _brute_ctc_nll(logits, labels, blank=0):
    """-log p(labels) by enumerating all C^T alignments (float64)."""
    logp = _log_softmax(logits.astype(np.float64))
    t, c = logp.shape
    total = -np.inf
    for path in itertools.product(range(c), repeat=t):
        out, prev = [], None
        for p in path:
            if p != prev:
                prev = p
                if p != blank:
                    out.append(p)
        if tuple(out) == tuple(labels):
            total = np.logaddexp(total, sum(logp[i, p] for i, p in enumerate(path)))
    return -total


def _brute_crf(emissions, labels, w):
    """(nll of labels, best tags) by enumerating all C^T tag paths."""
    a, b, trans = w[0], w[1], w[2:]
    t, c = emissions.shape

    def score(tags):
        return (a[tags[0]] + b[tags[-1]] + sum(emissions[i, g] for i, g in enumerate(tags))
                + sum(trans[tags[i], tags[i + 1]] for i in range(t - 1)))

    paths = list(itertools.product(range(c), repeat=t))
    scores = [score(p) for p in paths]
    log_z = np.logaddexp.reduce(np.asarray(scores, np.float64))
    return log_z - score(labels), paths[int(np.argmax(scores))]


def _t(x):
    return torch.from_numpy(np.asarray(x))


# -- CTC -----------------------------------------------------------------------


@pytest.mark.parametrize("labels", [[1], [1, 2], [1, 1], [2, 1, 2]])
def test_ctc_matches_brute_force(labels):
    t, c = 4, 3
    logits = np.random.RandomState(0).randn(1, t, c).astype(np.float32)
    lab = np.zeros((1, 3), np.int32)
    lab[0, :len(labels)] = labels
    got = float(tctc.ctc_loss(_t(logits), _t([t]), _t(lab), _t([len(labels)]))[0])
    assert math.isfinite(got)
    np.testing.assert_allclose(got, _brute_ctc_nll(logits[0], labels), rtol=1e-4, atol=1e-4)


def test_ctc_batch_and_length_masking():
    logits = np.random.RandomState(0).randn(2, 6, 4).astype(np.float32)
    labels = np.array([[1, 2, 0], [3, 0, 0]], np.int32)
    got = tctc.ctc_loss(_t(logits), _t([6, 4]), _t(labels), _t([3, 1])).numpy()
    np.testing.assert_allclose(got[1], _brute_ctc_nll(logits[1, :4], [3]), rtol=1e-4,
                               atol=1e-4)


def ctc_inputs(seed=0, b=6, t=9, c=5, l=4):
    """Ragged CTC inputs: label lengths 0..L, a repeated pair, a row of
    T = 2L + 1 frames and rows shorter than the padded T."""
    rs = np.random.RandomState(seed)
    logits = rs.randn(b, t, c).astype(np.float32) * 2
    labels = rs.randint(1, c, (b, l)).astype(np.int32)
    labels[2, 1] = labels[2, 0]  # a repeated label needs a blank between
    label_lengths = np.array([l, 0, 3, 1, 2, l], np.int32)[:b]
    frame_lengths = np.array([t, 5, 7, 2, t, t], np.int32)[:b]
    return logits, frame_lengths, labels, label_lengths


@pytest.mark.parametrize("norm_by_times", [False, True])
def test_ctc_loss_matches_jax(norm_by_times):
    import jax
    import jax.numpy as jnp

    from paddle_tpu.ops import ctc as jctc

    logits, fl, labels, ll = ctc_inputs()
    args = (jnp.asarray(fl), jnp.asarray(labels), jnp.asarray(ll))
    want, vjp = jax.vjp(lambda x: jctc.ctc_loss(x, *args, norm_by_times=norm_by_times),
                        jnp.asarray(logits))
    cot = np.random.RandomState(1).rand(len(fl)).astype(np.float32)
    (want_g,) = vjp(jnp.asarray(cot))
    x = _t(logits).requires_grad_(True)
    got = tctc.ctc_loss(x, _t(fl), _t(labels), _t(ll), norm_by_times=norm_by_times)
    (got_g,) = torch.autograd.grad(got, x, _t(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    want_g = np.asarray(want_g)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(want_g).max())))


@pytest.mark.parametrize("case", ["empty_label", "repeats", "t_eq_2l_plus_1"])
def test_ctc_gradients_stay_finite(case):
    c = 4
    if case == "empty_label":
        labels, ll, t = np.zeros((2, 2), np.int32), np.array([0, 0], np.int32), 5
    elif case == "repeats":
        labels, ll, t = np.array([[2, 2, 2], [1, 1, 3]], np.int32), np.array([3, 3]), 5
    else:  # exactly the frames a blank-separated path needs: one path only
        labels, ll, t = np.array([[1, 2, 3], [3, 2, 1]], np.int32), np.array([3, 3]), 7
    logits = np.random.RandomState(2).randn(2, t, c).astype(np.float32)
    x = _t(logits).requires_grad_(True)
    nll = tctc.ctc_loss(x, _t([t, t]), _t(labels), _t(ll))
    (g,) = torch.autograd.grad(nll.sum(), x)
    assert torch.isfinite(nll).all() and torch.isfinite(g).all()
    if case == "repeats":  # [2, 2, 2] needs 5 frames: a blank between each pair
        want = _brute_ctc_nll(logits[0], [2, 2, 2])
        np.testing.assert_allclose(float(nll[0].detach()), want, rtol=1e-4)


def test_ctc_greedy_decode_matches_jax():
    import jax.numpy as jnp

    from paddle_tpu.ops import ctc as jctc

    logits, fl, _, _ = ctc_inputs(3, t=12)
    logits[0] = 0.0
    for i, sym in enumerate([1, 1, 0, 2, 2, 0, 0, 3, 1, 1, 0, 2]):
        logits[0, i, sym] = 5.0
    want = np.asarray(jctc.ctc_greedy_decode(jnp.asarray(logits), jnp.asarray(fl)))
    got = tctc.ctc_greedy_decode(_t(logits), _t(fl))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert list(want[0][want[0] >= 0]) == [1, 2, 3, 1, 2]


# -- CRF -----------------------------------------------------------------------


def test_crf_nll_and_decode_match_brute_force():
    t, c = 4, 3
    rs = np.random.RandomState(0)
    emissions = rs.randn(2, t, c).astype(np.float32)
    w = rs.randn(c + 2, c).astype(np.float32)
    labels = np.array([[0, 2, 1, 1], [1, 0, 2, 0]], np.int32)
    lengths = np.array([4, 3], np.int32)
    got = tcrf.crf_nll(_t(emissions), _t(lengths), _t(labels), _t(w)).numpy()
    tags = tcrf.crf_decode(_t(emissions), _t(lengths), _t(w)).numpy()
    for i, n in enumerate(lengths):
        want_nll, best = _brute_crf(emissions[i, :n], labels[i, :n], w)
        np.testing.assert_allclose(got[i], want_nll, rtol=1e-4, atol=1e-4)
        assert tuple(tags[i, :n]) == best
    assert tags[1, 3] == tags[1, 2]  # past the length: the last tag repeated


def crf_inputs(seed=0, b=5, t=7, c=4):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, t, c).astype(np.float32) * 2,
            np.array([7, 1, 4, 6, 3], np.int32)[:b],
            rs.randint(0, c, (b, t)).astype(np.int32),
            rs.randn(c + 2, c).astype(np.float32))


def test_crf_matches_jax():
    import jax
    import jax.numpy as jnp

    from paddle_tpu.ops import crf as jcrf

    emissions, lengths, labels, w = crf_inputs()
    want, vjp = jax.vjp(lambda e, ww: jcrf.crf_nll(e, jnp.asarray(lengths),
                                                   jnp.asarray(labels), ww),
                        jnp.asarray(emissions), jnp.asarray(w))
    cot = np.random.RandomState(1).rand(len(lengths)).astype(np.float32)
    want_ge, want_gw = vjp(jnp.asarray(cot))
    e, ww = _t(emissions).requires_grad_(True), _t(w).requires_grad_(True)
    got = tcrf.crf_nll(e, _t(lengths), _t(labels), ww)
    got_ge, got_gw = torch.autograd.grad(got, (e, ww), _t(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    for g, want_g in ((got_ge, want_ge), (got_gw, want_gw)):
        want_g = np.asarray(want_g)
        np.testing.assert_allclose(g.numpy(), want_g, rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(want_g).max())))
    want_tags = np.asarray(jcrf.crf_decode(jnp.asarray(emissions), jnp.asarray(lengths),
                                           jnp.asarray(w)))
    np.testing.assert_array_equal(
        tcrf.crf_decode(_t(emissions), _t(lengths), _t(w)).numpy(), want_tags)


# -- the layers in a graph -------------------------------------------------------


def _layer_graph(L, S, which):
    """which -> (cost or decoding output layer) over Fc emissions."""
    x = L.Data("x", shape=(6,), is_seq=True)
    if which == "ctc":
        logits = L.Fc(x, 5, act=None, name="emit")
        return S.CTCCost(logits, L.Data("y", shape=(), is_seq=True), norm_by_times=True,
                         coeff=2.0, name="cost")
    emit = L.Fc(x, 4, act=None, name="emit")
    y = L.Data("y", shape=(), is_seq=True)
    if which == "crf":
        return S.CRFCost(emit, y, size=4, name="cost")
    return S.CRFDecoding(emit, size=4, label=y if which == "crf_decoding_error" else None,
                         name="cost")


def _layer_batch(which):
    rs = np.random.RandomState(4)
    lens = np.array([5, 3, 4], np.int32)
    if which == "ctc":
        y = rs.randint(1, 5, (3, 2)).astype(np.int32)
        ylens = np.array([2, 1, 0], np.int32)
    else:
        y, ylens = rs.randint(0, 4, (3, 5)).astype(np.int32), lens
    return {"x": rs.randn(3, 5, 6).astype(np.float32), "x.lengths": lens,
            "y": y, "y.lengths": ylens}


@pytest.mark.parametrize("which", ["ctc", "crf", "crf_decoding", "crf_decoding_error"])
def test_layers_match_jax(which):
    import jax

    from paddle_tpu.nn import graph as jgraph
    from paddle_tpu.nn import layers as JL
    from paddle_tpu.nn import struct_costs as JS

    batch = _layer_batch(which)
    jgraph.reset_name_scope()
    jout = _layer_graph(JL, JS, which)
    jnet = jgraph.Network([jout])
    params, states = jnet.init(jax.random.PRNGKey(0), batch)
    tgraph.reset_name_scope()
    tout = _layer_graph(TL, TS, which)
    tnet = tgraph.Network([tout])
    assert sorted(tnet.init(batch, device="cpu")) == sorted(params)
    tp = {k: v.requires_grad_(True) for k, v in params_from_jax(params, "cpu").items()}
    got = tnet.apply(tp, batch)["cost"]
    if which.startswith("crf_decoding"):
        want = jnet.apply(params, states, batch)[0]["cost"]
        np.testing.assert_array_equal(got.value.numpy(), np.asarray(want.value))
        np.testing.assert_array_equal(got.lengths.numpy(), batch["x.lengths"])
        return
    cj, gj = jax.value_and_grad(
        lambda p: jnet.apply(p, states, batch, train=True)[0]["cost"].value)(params)
    names = sorted(tp)
    gt = torch.autograd.grad(got.value, [tp[k] for k in names])
    assert abs(float(got.value.detach()) - float(cj)) <= 1e-5 * abs(float(cj))
    for k, g in zip(names, gt):
        want_g = np.asarray(gj[k])
        np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-5,
                                   atol=1e-6 * max(1.0, float(np.abs(want_g).max())),
                                   err_msg=k)


def test_ctc_cost_needs_sequences():
    tgraph.reset_name_scope()
    cost = TS.CTCCost(TL.Data("x", shape=(3,)), TL.Data("y", shape=(), is_seq=True))
    batch = {"x": np.zeros((2, 3), np.float32), "y": np.zeros((2, 2), np.int32),
             "y.lengths": np.array([1, 1], np.int32)}
    with pytest.raises(LayerError, match=r"error in layer '__ctc_0__' .*sequence"):
        tgraph.Network([cost]).apply({"unused": torch.zeros(1)}, batch)


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _ctc_and_grad(logits, args):
    x = logits.detach().clone().requires_grad_(True)
    nll = tctc.ctc_loss(x, *args)
    (g,) = torch.autograd.grad(nll.sum(), x)
    return nll.detach(), g


def _crf_and_grads(emissions, w, lengths, labels):
    e, ww = emissions.detach().clone().requires_grad_(True), w.detach().clone().requires_grad_(True)
    nll = tcrf.crf_nll(e, lengths, labels, ww)
    ge, gw = torch.autograd.grad(nll.sum(), (e, ww))
    return nll.detach(), ge, gw


@pytest.mark.cuda
def test_cuda_ctc_and_crf_match_cpu(cuda):
    logits, fl, labels, ll = (_t(a) for a in ctc_inputs(5, b=6, t=40, c=20, l=4))
    want = _ctc_and_grad(logits, (fl, labels, ll))
    got = _ctc_and_grad(logits.to(cuda), (fl.to(cuda), labels.to(cuda), ll.to(cuda)))
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-5,
                                   atol=1e-5 * max(1.0, float(w.abs().max())))
    emissions, lengths, tags, w = (_t(a) for a in crf_inputs(6, t=7))
    want = _crf_and_grads(emissions, w, lengths, tags)
    got = _crf_and_grads(emissions.to(cuda), w.to(cuda), lengths.to(cuda), tags.to(cuda))
    for g, ref in zip(got, want):
        torch.testing.assert_close(g.cpu(), ref, rtol=1e-5,
                                   atol=1e-5 * max(1.0, float(ref.abs().max())))
    assert torch.equal(tcrf.crf_decode(emissions.to(cuda), lengths.to(cuda), w.to(cuda)).cpu(),
                       tcrf.crf_decode(emissions, lengths, w))


@pytest.mark.cuda
def test_cuda_ctc_and_crf_capture_in_a_graph(cuda):
    logits, fl, labels, ll = (_t(a).to(cuda) for a in ctc_inputs(7, t=30, c=12))
    emissions, lengths, tags, w = (_t(a).to(cuda) for a in crf_inputs(8))

    def body():
        return _ctc_and_grad(logits, (fl, labels, ll)) + _crf_and_grads(emissions, w,
                                                                       lengths, tags)

    eager = body()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()  # warm-up on a side stream, as torch.cuda.graphs asks
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = body()
    graph.replay()
    torch.cuda.synchronize()
    # the gathers' backward adds with atomics: equal up to the order of sums
    for a, b in zip(static, eager):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * max(1.0, float(b.abs().max())))
