"""Fluid programs through the port's Executor against the JAX package's.

Every program of tests/test_fluid.py and tests/test_fluid_control_flow.py
is built twice, once with each package's `fluid.layers` / `Block` API
(same names, same descs), and run through both executors from one scope:
the JAX executor initialises its scope, and the port's scope is made from
those values by name (`fluid.scope_from_arrays`). Then 3 runs each with
the same feeds: losses and fetches agree within rtol 1e-5 / atol 1e-6
(the conv program's within 1e-4: its batch-norm statistics and conv sums
round differently), and so do the scopes after the runs. The JAX side runs
jitted (one compile per program), the port's eagerly on the CPU.

Also on the CPU: `to_string` prints the JAX package's text, `prune` keeps
the same ops, `save` / `load` round trips, the `cond` KeyError, graph
eligibility, `use_jit=False` against `use_jit=True`, and the fresh
initial draws equal the JAX package's (uniform bitwise, constants exactly,
normal within 5e-5: erfinv rounds differently).

On the card (`cuda`, skipped elsewhere): a graphed run's signature is
captured at its second run and replayed after, matching the eager
interpreter on the card and the CPU; a `while` program runs eagerly; a
`save` inside a graphed run writes its file at every replay."""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import executor as texec

RUNS = 3


@pytest.fixture(autouse=True)
def _fresh_programs():
    tfluid.reset_default_program()
    yield


def _jfluid():
    from paddle_tpu import fluid

    fluid.reset_default_program()
    return fluid


# -- programs (each builder takes a package's fluid module) ----------------------


def toy_classification(n=32, d=16, c=4, seed=0):
    rs = np.random.RandomState(seed)
    lbl = rs.randint(0, c, (n, 1))
    feat = rs.randn(n, d).astype(np.float32) * 0.1
    for i, l in enumerate(lbl[:, 0]):
        feat[i, l] += 2.0
    return feat, lbl


def build_mlp(fl, c=4, names=(None, None)):
    L = fl.layers
    x = L.data("x", shape=[16])
    y = L.data("y", shape=[1], dtype=np.int32)
    h = L.fc(x, 32, act="tanh", name=names[0])
    out = L.fc(h, c, act="softmax", name=names[1])
    loss = L.mean(L.cross_entropy(out, y))
    acc = L.accuracy(out, y)
    return x, y, out, loss, acc


OPTIMIZERS = {
    "sgd": ("SGDOptimizer", {"learning_rate": 0.5}),
    "momentum": ("MomentumOptimizer", {"learning_rate": 0.2, "momentum": 0.9}),
    "adam": ("AdamOptimizer", {"learning_rate": 0.05}),
    "adagrad": ("AdagradOptimizer", {"learning_rate": 0.3}),
}


def mlp_program(fl, opt="sgd", names=(None, None)):
    _, _, out, loss, acc = build_mlp(fl, names=names)
    cls, kw = OPTIMIZERS[opt]
    getattr(fl.optimizer, cls)(**kw).minimize(loss)
    feat, lbl = toy_classification(seed=3)
    return fl.default_main_program(), [{"x": feat, "y": lbl}] * RUNS, [loss.name, acc.name]


def conv_bn_program(fl):
    L = fl.layers
    rs = np.random.RandomState(0)
    img = L.data("img", shape=[3, 8, 8])
    y = L.data("y", shape=[1], dtype=np.int32)
    c = L.conv2d(img, 8, 3, padding=1, act="relu")
    bn = L.batch_norm(c)
    p = L.pool2d(bn, 2)
    flat = L.reshape(p, [-1, 8 * 4 * 4])
    out = L.fc(flat, 2, act="softmax")
    loss = L.mean(L.cross_entropy(out, y))
    fl.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    feed = {"img": rs.randn(4, 3, 8, 8).astype(np.float32), "y": rs.randint(0, 2, (4, 1))}
    return fl.default_main_program(), [feed] * RUNS, [loss.name]


def manual_grad_program(fl):
    L = fl.layers
    rs = np.random.RandomState(1)
    xv = rs.randn(8, 4).astype(np.float32)
    wv = rs.randn(4, 1).astype(np.float32)
    x = L.data("x", shape=[4])
    block = fl.default_main_program().global_block()
    w = block.create_parameter("w", shape=[4, 1], initializer=wv)
    out = block.create_var("out")
    block.append_op("mul", {"X": x, "Y": w}, {"Out": out}, {})
    sq = block.create_var("sq")
    block.append_op("square", {"X": out}, {"Y": sq}, {})
    loss = L.mean(sq)
    fl.append_backward(loss, [w])
    return fl.default_main_program(), [{"x": xv}] * RUNS, [loss.name, "w@GRAD"]


def dropout_program(fl):
    L = fl.layers
    x = L.data("x", shape=[64])
    d = L.dropout(x, 0.5)
    xv = np.ones((4, 64), np.float32)
    return fl.default_main_program(), [{"x": xv}] * RUNS, [d.name]


def rnn_program(fl, reverse=False, b=4, t=6, d=5, h=3):
    rs = np.random.RandomState(0)
    wv = (rs.randn(d, h) * 0.3).astype(np.float32)
    uv = (rs.randn(h, h) * 0.3).astype(np.float32)
    prog = fl.default_main_program()
    block = prog.global_block()
    block.create_var("x_seq", shape=[t, d], is_data=True)
    block.create_var("h0", shape=[h], is_data=True)
    w = block.create_parameter("W", shape=[d, h], initializer=wv)
    u = block.create_parameter("U", shape=[h, h], initializer=uv)
    sub = prog.create_block()
    sub.append_op("mul", {"X": "x_t", "Y": w}, {"Out": "xw"}, {})
    sub.append_op("mul", {"X": "h_pre", "Y": u}, {"Out": "hu"}, {})
    sub.append_op("elementwise_add", {"X": "xw", "Y": "hu"}, {"Out": "s"}, {})
    sub.append_op("tanh", {"X": "s"}, {"Y": "h_new"}, {})
    prog.rollback()
    block.desc.ops.append(fl.framework.OpDesc(
        type="recurrent",
        attrs={"sub_block": sub.idx, "seq_ins": {"x_t": "x_seq"},
               "states": {"h_pre": ("h0", "h_new")}, "seq_outs": {"h_seq": "h_new"},
               "reverse": reverse}))
    rs = np.random.RandomState(1)
    feed = {"x_seq": rs.randn(b, t, d).astype(np.float32),
            "h0": rs.randn(b, h).astype(np.float32)}
    return prog, [feed] * RUNS, ["h_seq", "recurrent.h_new@LAST"]


def rnn_train_program(fl):
    """The recurrent op trained: mean of the last state, SGD."""
    prog, feeds, _ = rnn_program(fl)
    block = prog.global_block()
    loss = block.create_var("loss", shape=[])
    block.append_op("mean", {"X": "h_seq"}, {"Out": loss}, {})
    fl.optimizer.SGDOptimizer(learning_rate=0.5).minimize(loss)
    return prog, feeds, ["loss", "h_seq"]


def rnn_dropout_program(fl):
    """A dropout inside the recurrent body draws the same key at every step
    (lax.scan traces the body once), then one after it draws the next."""
    prog, feeds, _ = rnn_program(fl)
    sub = prog.blocks[1]
    sub.append_op("dropout", {"X": "h_new"}, {"Out": "h_drop"}, {"dropout_prob": 0.5})
    prog.global_block().desc.ops[-1].attrs["seq_outs"] = {"h_seq": "h_drop"}
    prog.global_block().append_op("dropout", {"X": "h_seq"}, {"Out": "h_out"},
                                  {"dropout_prob": 0.5})
    return prog, feeds, ["h_seq", "h_out"]


def while_program(fl, dropout=False):
    """v doubles until the counter reaches n."""
    prog = fl.default_main_program()
    block = prog.global_block()
    block.create_var("v", shape=[4], is_data=True)
    block.create_var("c", shape=[], is_data=True)
    block.create_var("n", shape=[], is_data=True)
    block.create_var("keep_going", shape=[])
    block.append_op("less_than", {"X": "c", "Y": "n"}, {"Out": "keep_going"}, {})
    sub = prog.create_block()
    sub.append_op("scale", {"X": "v"}, {"Out": "v"}, {"scale": 2.0})
    if dropout:  # the body is traced once: one key for every iteration
        sub.append_op("dropout", {"X": "v"}, {"Out": "v"}, {"dropout_prob": 0.5})
    sub.append_op("increment", {"X": "c"}, {"Out": "c"}, {"step": 1.0})
    sub.append_op("less_than", {"X": "c", "Y": "n"}, {"Out": "keep_going"}, {})
    prog.rollback()
    block.desc.ops.append(fl.framework.OpDesc(
        type="while", attrs={"sub_block": sub.idx, "cond": "keep_going",
                             "carry": ["v", "c"]}))
    return prog, while_feeds(), ["v", "c"]


def while_feeds():
    return [{"v": np.ones(4, np.float32) * (i + 1), "c": np.zeros((), np.float32),
             "n": np.full((), 7.0 - i, np.float32)} for i in range(RUNS)]


def cond_program(fl, with_false_block=True, flags=(1.0, 0.0, 1.0)):
    prog = fl.default_main_program()
    block = prog.global_block()
    block.create_var("flag", shape=[], is_data=True)
    block.create_var("x", shape=[3], is_data=True)
    block.create_var("out", shape=[3], is_data=True)  # passthrough default
    true_b = prog.create_block()
    true_b.append_op("scale", {"X": "x"}, {"Out": "out"}, {"scale": 10.0})
    prog.rollback()
    attrs = {"cond": "flag", "true_block": true_b.idx, "outs": ["out"]}
    if with_false_block:
        false_b = prog.create_block()
        false_b.append_op("scale", {"X": "x"}, {"Out": "out"}, {"scale": -1.0})
        prog.rollback()
        attrs["false_block"] = false_b.idx
    block.desc.ops.append(fl.framework.OpDesc(type="cond", attrs=attrs))
    xv = np.array([1.0, 2.0, 3.0], np.float32)
    prior = np.array([7.0, 8.0, 9.0], np.float32)
    feeds = [{"x": xv, "out": prior, "flag": np.asarray(v)} for v in flags]
    return prog, feeds, ["out"]


def cond_vector_program(fl):
    prog = fl.default_main_program()
    block = prog.global_block()
    block.create_var("flag", shape=[4], is_data=True)
    block.create_var("x", shape=[4, 2], is_data=True)
    true_b = prog.create_block()
    true_b.append_op("scale", {"X": "x"}, {"Out": "y"}, {"scale": 2.0})
    true_b.append_op("dropout", {"X": "y"}, {"Out": "y"}, {"dropout_prob": 0.5})
    prog.rollback()
    false_b = prog.create_block()
    false_b.append_op("scale", {"X": "x"}, {"Out": "y"}, {"scale": 0.0})
    prog.rollback()
    block.desc.ops.append(fl.framework.OpDesc(
        type="cond", attrs={"cond": "flag", "true_block": true_b.idx,
                            "false_block": false_b.idx, "outs": ["y"]}))
    block.append_op("dropout", {"X": "y"}, {"Out": "z"}, {"dropout_prob": 0.5})
    feeds = [{"x": np.ones((4, 2), np.float32) * (i + 1),
              "flag": np.array([1, 0, 1, 0], np.float32)} for i in range(RUNS)]
    return prog, feeds, ["y", "z"]


def lstm_text_program(fl, b=16, t=6, vocab=30, emb_d=8, hid=16, ncls=2):
    rs = np.random.RandomState(0)
    lbl = rs.randint(0, ncls, (b, 1))
    ids = np.where(lbl == 0, rs.randint(2, vocab // 2, (b, t)),
                   rs.randint(vocab // 2, vocab, (b, t))).astype(np.int64)
    lengths = rs.randint(t // 2, t + 1, (b,)).astype(np.int32)
    prog = fl.default_main_program()
    block = prog.global_block()
    block.create_var("ids", shape=[t], dtype=np.int64, is_data=True)
    block.create_var("lengths", shape=[], dtype=np.int32, is_data=True)
    block.create_var("label", shape=[1], dtype=np.int64, is_data=True)
    emb_w = block.create_parameter("emb.w", shape=[vocab, emb_d],
                                   initializer=("uniform", -0.1, 0.1))
    block.append_op("lookup_table", {"W": emb_w, "Ids": "ids"}, {"Out": "emb"}, {})
    proj_w = block.create_parameter("proj.w", shape=[emb_d, 4 * hid],
                                    initializer=("uniform", -0.3, 0.3))
    block.append_op("mul", {"X": "emb", "Y": proj_w}, {"Out": "proj"}, {"x_num_col_dims": 2})
    lstm_w = block.create_parameter("lstm.w", shape=[hid, 4 * hid],
                                    initializer=("uniform", -0.3, 0.3))
    lstm_b = block.create_parameter("lstm.b", shape=[4 * hid], initializer=("constant", 0.0))
    block.append_op("lstm", {"Input": "proj", "Weight": lstm_w, "Bias": lstm_b,
                             "SeqLengths": "lengths"},
                    {"Hidden": "hidden", "Cell": "cell", "LastH": "last_h"}, {})
    fc_w = block.create_parameter("fc.w", shape=[hid, ncls], initializer=("uniform", -0.3, 0.3))
    block.append_op("mul", {"X": "last_h", "Y": fc_w}, {"Out": "logits"}, {})
    block.append_op("softmax", {"X": "logits"}, {"Y": "probs"}, {})
    block.append_op("cross_entropy", {"X": "probs", "Label": "label"}, {"Y": "xent"}, {})
    loss = block.create_var("loss", shape=[])
    block.append_op("mean", {"X": "xent"}, {"Out": loss}, {})
    fl.optimizer.AdamOptimizer(learning_rate=0.05).minimize(loss)
    return prog, [{"ids": ids, "lengths": lengths, "label": lbl}] * RUNS, ["loss"]


def view_of_updated_param_program(fl):
    """SGD on w while a reshape of w (a view of its storage) is fetched."""
    L = fl.layers
    x = L.data("x", shape=[2])
    block = fl.default_main_program().global_block()
    w = block.create_parameter("w", shape=[2, 3],
                               initializer=np.arange(6, dtype=np.float32).reshape(2, 3))
    block.append_op("reshape", {"X": w}, {"Out": "w_view"}, {"shape": [3, 2]})
    block.append_op("mul", {"X": x, "Y": w}, {"Out": "out"}, {})
    loss = L.mean(block.create_var("out"))
    fl.optimizer.SGDOptimizer(learning_rate=0.5).minimize(loss)
    feed = {"x": np.ones((4, 2), np.float32)}
    return fl.default_main_program(), [feed] * RUNS, [loss.name, "w_view"]

# chip_smoke.py's programs (phases 36-38) at small widths
SMALL = dict(
    lstm=dict(cs.FLUID_LSTM, vocab=50, embed=8, hidden=16, seq_len=12, min_len=6),
    gru=dict(cs.FLUID_GRU, t=6, b=8, d=8, h=8),
    beam=dict(cs.FLUID_BEAM, b=4, v=50, steps=3, emb=8),
)


def chip_digits(fl):
    prog, fetch = cs.fluid_digits_program(fl)
    rs = np.random.RandomState(0)
    feeds = [{"img": rs.randn(4, 1, 28, 28).astype(np.float32),
              "label": rs.randint(0, 10, (4, 1))} for _ in range(RUNS)]
    return prog, feeds, fetch


def chip_cond(fl, per_sample):
    prog, fetch = cs.fluid_cond_program(fl, per_sample)
    rs = np.random.RandomState(1)
    flags = ([rs.randint(0, 2, 8).astype(np.float32) for _ in range(RUNS)] if per_sample
             else [np.asarray(float(i % 2)) for i in range(RUNS)])
    return prog, [{"flag": f, "x": rs.randn(8, 16).astype(np.float32)} for f in flags], fetch


def chip_program(build, feeds):
    """A chip_smoke.py builder as a PROGRAMS entry: fl -> (prog, feeds, fetch)."""
    def make(fl):
        prog, fetch = build(fl)
        return prog, feeds(), fetch
    return make


CHIP_PROGRAMS = {
    "chip_digits": chip_digits,
    "chip_lstm": chip_program(lambda fl: cs.fluid_lstm_program(fl, SMALL["lstm"]),
                              lambda: [cs.fluid_lstm_feed(np, SMALL["lstm"], 8)] * RUNS),
    "chip_gru": chip_program(lambda fl: cs.fluid_gru_program(fl, SMALL["gru"]),
                             lambda: [cs.fluid_gru_feed(np, SMALL["gru"])] * RUNS),
    "chip_while": chip_program(cs.fluid_while_program, while_feeds),
    "chip_cond_scalar": lambda fl: chip_cond(fl, False),
    "chip_cond_per_sample": lambda fl: chip_cond(fl, True),
    "chip_beam": chip_program(lambda fl: cs.fluid_beam_program(fl, SMALL["beam"]),
                              lambda: [cs.fluid_beam_feed(np, SMALL["beam"], seed=i)
                                       for i in range(RUNS)]),
}

PROGRAMS = {
    **{f"mlp_{k}": (lambda fl, k=k: mlp_program(fl, k)) for k in OPTIMIZERS},
    "mlp_slot_like_names": lambda fl: mlp_program(fl, "momentum",
                                                  names=("word_lr_emb", "x_beta")),
    "conv_pool_batchnorm": conv_bn_program,
    "backward_grads": manual_grad_program,
    "dropout": dropout_program,
    "recurrent": rnn_program,
    "recurrent_reverse": lambda fl: rnn_program(fl, reverse=True),
    "recurrent_trained": rnn_train_program,
    "recurrent_dropout": rnn_dropout_program,
    "while": while_program,
    "while_dropout": lambda fl: while_program(fl, dropout=True),
    "cond_scalar": cond_program,
    "cond_passthrough": lambda fl: cond_program(fl, with_false_block=False),
    "cond_vector": cond_vector_program,
    "lstm_text_classifier": lstm_text_program,
    "view_of_updated_param": view_of_updated_param_program,
    **CHIP_PROGRAMS,
}
TOL = {"conv_pool_batchnorm": dict(rtol=1e-4, atol=1e-5),
       "chip_digits": dict(rtol=1e-4, atol=1e-5),
       "lstm_text_classifier": dict(rtol=1e-5, atol=2e-6)}


def run_both(name, use_jit=True, train=True):
    """Build PROGRAMS[name] in both packages, run both executors RUNS times
    from the JAX executor's initial scope -> (JAX fetches, port fetches,
    JAX scope values, port scope)."""
    jf = _jfluid()
    jprog, feeds, fetch = PROGRAMS[name](jf)
    tfluid.reset_default_program()
    tprog, _, tfetch = PROGRAMS[name](tfluid)
    assert tprog.to_string() == jprog.to_string()
    assert fetch == tfetch
    jexe = jf.Executor(seed=5)
    jscope = jf.Scope()
    jexe.initialize(jprog, jscope)
    tscope = tfluid.scope_from_arrays({k: np.asarray(v) for k, v in jscope.values.items()},
                                      "cpu")
    texe = tfluid.Executor(seed=5, device="cpu")
    want, got = [], []
    for feed in feeds:
        want.append(jexe.run(jprog, feed=dict(feed), fetch_list=fetch, scope=jscope,
                             use_jit=use_jit, train=train))
        got.append(texe.run(tprog, feed=dict(feed), fetch_list=fetch, scope=tscope,
                            use_jit=use_jit, train=train))
    return want, got, {k: np.asarray(v) for k, v in jscope.values.items()}, tscope


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "fc":
        np.testing.assert_allclose(got, want, err_msg=what, **tol)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_matches_jax(name):
    tol = TOL.get(name, dict(rtol=1e-5, atol=1e-6))
    want, got, jvals, tscope = run_both(name)
    for i, (w_run, g_run) in enumerate(zip(want, got)):
        for j, (w, g) in enumerate(zip(w_run, g_run)):
            _close(g, w, tol, f"{name} run {i} fetch {j}")
    tvals = tscope.numpy()
    assert set(tvals) == set(jvals)
    for k in jvals:
        _close(tvals[k], jvals[k], tol, f"{name} scope {k}")


def test_programs_train_as_in_jax():
    """Losses fall over the runs for the trained programs (both sides)."""
    for name in ("mlp_sgd", "mlp_adam", "lstm_text_classifier", "recurrent_trained"):
        want, got, _, _ = run_both(name)
        assert float(got[-1][0]) < float(got[0][0]), name
        np.testing.assert_allclose([float(g[0]) for g in got], [float(w[0]) for w in want],
                                   rtol=1e-5)


def test_eager_interpreter_matches_jax_eager():
    want, got, _, _ = run_both("mlp_sgd", use_jit=False)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g[0], w[0], rtol=1e-5)


def test_dropout_train_vs_test():
    x = tfluid.layers.data("x", shape=[64])
    d = tfluid.layers.dropout(x, 0.5)
    prog = tfluid.default_main_program()
    exe = tfluid.Executor(device="cpu")
    xv = np.ones((4, 64), np.float32)
    (train_out,) = exe.run(prog, feed={"x": xv}, fetch_list=[d], train=True)
    (test_out,) = exe.run(prog, feed={"x": xv}, fetch_list=[d], train=False)
    assert (train_out == 0).any()
    np.testing.assert_allclose(test_out, xv)


def test_given_rng_matches_jax():
    import jax

    jf = _jfluid()
    jprog, _, fetch = dropout_program(jf)
    tprog, _, _ = dropout_program(tfluid)
    xv = np.ones((4, 64), np.float32)
    key = jax.random.PRNGKey(11)
    (want,) = jf.Executor().run(jprog, feed={"x": xv}, fetch_list=fetch, rng=key)
    (got,) = tfluid.Executor(device="cpu").run(tprog, feed={"x": xv}, fetch_list=fetch,
                                               rng=np.asarray(key))
    np.testing.assert_array_equal(got, want)


def test_to_string_and_prune_match_jax():
    jf = _jfluid()
    _, _, jout, _, _ = build_mlp(jf)
    _, _, tout, _, _ = build_mlp(tfluid)
    jprog, tprog = jf.default_main_program(), tfluid.default_main_program()
    assert tprog.to_string() == jprog.to_string()
    jp, tp = jprog.prune([jout]), tprog.prune([tout])
    assert tp.to_string() == jp.to_string()
    types = [op.type for op in tp.global_block().desc.ops]
    assert "cross_entropy" not in types and types.count("mul") == 2
    assert "cross_entropy" in [op.type for op in tprog.global_block().desc.ops]
    feat, lbl = toy_classification(n=8)
    exe = tfluid.Executor(device="cpu")
    scope = tfluid.Scope()
    want = exe.run(tprog, feed={"x": feat, "y": lbl}, fetch_list=[tout], scope=scope)[0]
    got = exe.run(tp, feed={"x": feat}, fetch_list=[tout], scope=scope)[0]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_fresh_initial_draws_equal_jax():
    """The persistables' initializer keys (`_stable_key`) and draws:
    uniform bitwise, constants exactly, normal (the conv filter's) within
    float32 rounding of erfinv."""
    jf = _jfluid()
    jprog, _, _ = conv_bn_program(jf)
    tprog, _, _ = conv_bn_program(tfluid)
    jscope, tscope = jf.Scope(), tfluid.Scope()
    jf.Executor(seed=3).initialize(jprog, jscope)
    tfluid.Executor(seed=3, device="cpu").initialize(tprog, tscope)
    tvals = tscope.numpy()
    assert set(tvals) == set(jscope.values)
    for name, vd in tprog.global_block().desc.vars.items():
        if not vd.persistable:
            continue
        want = np.asarray(jscope.values[name])
        kind = vd.initializer[0]
        if kind == "normal":
            np.testing.assert_allclose(tvals[name], want, rtol=1e-5, atol=5e-5)
        else:
            np.testing.assert_array_equal(tvals[name], want, err_msg=f"{name} ({kind})")


def test_save_load_round_trip(tmp_path):
    block = tfluid.default_main_program().global_block()
    block.create_var("x", shape=[2, 3], is_data=True)
    path = str(tmp_path / "var")
    block.append_op("save", {"X": "x"}, {"Out": "done"}, {"file_path": path})
    block.append_op("load", {}, {"Out": "back"}, {"file_path": path})
    xv = np.arange(6, dtype=np.float32).reshape(2, 3)
    exe = tfluid.Executor(device="cpu")
    (back,) = exe.run(tfluid.default_main_program(), feed={"x": xv}, fetch_list=["back"],
                      use_jit=False)
    np.testing.assert_allclose(back, xv)
    np.testing.assert_allclose(np.load(path + ".npy"), xv)
    block.desc.ops[0].attrs["overwrite"] = False
    with pytest.raises(RuntimeError, match="overwrite=False"):
        exe.run(tfluid.default_main_program(), feed={"x": xv}, fetch_list=["back"])


def test_load_is_read_once_a_signature(tmp_path):
    """use_jit=True reads a `load` file once per signature (the JAX
    package's trace-time constant); use_jit=False reads it every run."""
    path = str(tmp_path / "w.npy")
    np.save(path, np.ones(3, np.float32))
    block = tfluid.default_main_program().global_block()
    block.append_op("load", {}, {"Out": "w"}, {"file_path": path})
    exe = tfluid.Executor(device="cpu")
    prog = tfluid.default_main_program()
    (a,) = exe.run(prog, fetch_list=["w"])
    np.save(path, np.full(3, 2.0, np.float32))
    (b,) = exe.run(prog, fetch_list=["w"])
    (c,) = exe.run(prog, fetch_list=["w"], use_jit=False)
    np.testing.assert_allclose(a, 1.0)
    np.testing.assert_allclose(b, 1.0)
    np.testing.assert_allclose(c, 2.0)


def test_cond_missing_passthrough_raises():
    prog = tfluid.default_main_program()
    block = prog.global_block()
    block.create_var("flag", shape=[], is_data=True)
    block.create_var("x", shape=[3], is_data=True)
    true_b = prog.create_block()
    true_b.append_op("scale", {"X": "x"}, {"Out": "only_inside"}, {"scale": 2.0})
    prog.rollback()
    block.desc.ops.append(tfluid.framework.OpDesc(
        type="cond", attrs={"cond": "flag", "true_block": true_b.idx,
                            "outs": ["only_inside"]}))
    with pytest.raises(KeyError, match="false_block"):
        tfluid.Executor(device="cpu").run(
            prog, feed={"x": np.ones(3, np.float32), "flag": np.asarray(1.0)},
            fetch_list=["only_inside"], use_jit=False)


def test_graph_eligibility_is_read_from_the_ops():
    prog, _, _ = while_program(tfluid)
    assert not texec.graphable(prog)
    tfluid.reset_default_program()
    prog, _, _ = mlp_program(tfluid)
    assert texec.graphable(prog)
    prog.global_block().append_op("precision_recall", {}, {}, {})
    assert not texec.graphable(prog)


def test_executor_device_defaults_to_cuda():
    if torch.cuda.is_available():
        assert tfluid.Executor().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tfluid.Executor()


def test_fluid_exports_the_jax_names():
    jf = _jfluid()
    assert set(jf.__all__) <= set(tfluid.__all__)
    assert set(tfluid.__all__) - set(jf.__all__) == {"scope_from_arrays"}
    for name in tfluid.__all__:
        assert hasattr(tfluid, name), name



def test_in_place_writes_keep_each_value_of_the_run():
    """A graphed run writes the persistables into their own tensors: a new
    value that views another persistable's old storage is copied out
    before any write (the JAX package's arrays are immutable)."""
    a, b = torch.zeros(2, 3), torch.arange(6.0).reshape(3, 2)
    texec._write_in_place({"b": b, "a": a}, {"b": b + 10, "a": b.reshape(2, 3)})
    np.testing.assert_array_equal(a.numpy(), np.arange(6.0).reshape(2, 3))
    np.testing.assert_array_equal(b.numpy(), np.arange(6.0).reshape(3, 2) + 10)


# -- on the card -------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs have no CPU mode")


def _dropout_mlp(fl):
    L = fl.layers
    x = L.data("x", shape=[16])
    y = L.data("y", shape=[1], dtype=np.int32)
    h = L.dropout(L.fc(x, 32, act="relu"), 0.3)
    out = L.fc(h, 4, act="softmax")
    loss = L.mean(L.cross_entropy(out, y))
    acc = L.accuracy(out, y)
    fl.optimizer.AdamOptimizer(learning_rate=0.05).minimize(loss)
    return fl.default_main_program(), [loss.name, acc.name]


@pytest.mark.cuda
def test_cuda_graphed_runs_match_eager_and_cpu(cuda):
    """An MLP with dropout and Adam: runs 1-2 eager, the second captured,
    runs 3-6 replays; the losses equal the eager interpreter's on the card
    (dropout's keys come from the device counter) and the CPU's."""
    prog, fetch = _dropout_mlp(tfluid)
    feat, lbl = toy_classification(seed=3)
    init = tfluid.Scope()
    tfluid.Executor(seed=2, device="cpu").initialize(prog, init)
    arrays = init.numpy()
    runs = {}
    for dev, jit in (("cuda", True), ("cuda", False), ("cpu", True)):
        exe = tfluid.Executor(seed=2, device=dev)
        scope = tfluid.scope_from_arrays(arrays, dev)
        runs[(dev, jit)] = [exe.run(prog, feed={"x": feat, "y": lbl}, fetch_list=fetch,
                                    scope=scope, use_jit=jit) for _ in range(6)]
        if jit and dev == "cuda":
            assert len(exe.graphs) == 1 and exe.eager_runs == 2
            assert next(iter(exe.graphs.values())).replays == 4
            w = scope.find("fc_1.w")
            assert w.is_cuda and w is scope.values["fc_1.w"]
    for i in range(6):
        for other in (("cuda", False), ("cpu", True)):
            np.testing.assert_allclose(runs[("cuda", True)][i][0], runs[other][i][0],
                                       rtol=1e-5, atol=1e-6)
    assert runs[("cuda", True)][-1][0] < runs[("cuda", True)][0][0]


@pytest.mark.cuda
def test_cuda_while_program_runs_eagerly(cuda):
    prog, feeds, fetch = while_program(tfluid)
    exe = tfluid.Executor(device="cuda")
    outs = [exe.run(prog, feed=f, fetch_list=fetch) for f in feeds]
    assert not exe.graphs and exe.eager_runs == RUNS
    np.testing.assert_allclose(outs[0][0], np.full(4, 128.0))


@pytest.mark.cuda
def test_cuda_save_in_a_graph_writes_after_each_replay(cuda, tmp_path):
    block = tfluid.default_main_program().global_block()
    block.create_var("x", shape=[3], is_data=True)
    block.append_op("scale", {"X": "x"}, {"Out": "y"}, {"scale": 2.0})
    path = str(tmp_path / "y")
    block.append_op("save", {"X": "y"}, {"Out": "done"}, {"file_path": path})
    exe = tfluid.Executor(device="cuda")
    prog = tfluid.default_main_program()
    for i in range(4):
        exe.run(prog, feed={"x": np.full(3, float(i), np.float32)}, fetch_list=["y"])
        np.testing.assert_allclose(np.load(path + ".npy"), np.full(3, 2.0 * i))
    assert len(exe.graphs) == 1 and next(iter(exe.graphs.values())).replays == 2


@pytest.mark.cuda
def test_cuda_fetched_view_of_an_updated_parameter_keeps_its_run_value(cuda):
    """Eager and replayed runs on the card fetch the reshape of w as it was
    in that run, before SGD's in-place write: the CPU's values."""
    prog, feeds, fetch = view_of_updated_param_program(tfluid)
    runs, exes = {}, {}
    for dev in ("cuda", "cpu"):
        exe = exes[dev] = tfluid.Executor(device=dev)
        runs[dev] = [exe.run(prog, feed=feeds[0], fetch_list=fetch) for _ in range(5)]
    (graph,) = exes["cuda"].graphs.values()
    assert graph.replays == 3 and not exes["cpu"].graphs
    for card, cpu in zip(runs["cuda"], runs["cpu"]):
        for c, p in zip(card, cpu):
            np.testing.assert_allclose(c, p, rtol=1e-6)
    np.testing.assert_array_equal(runs["cuda"][0][1], np.arange(6.0).reshape(3, 2))
