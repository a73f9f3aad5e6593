"""The port's recurrent groups (`paddle_tpu_torch/nn/recurrent_group.py`), its
step layers (`nn/recurrent.py` `GruStep`, `LstmStep`, `StepArgOutput`),
`SimpleAttention`, the v1 group helpers and the raw config API, against
the JAX package's, on the CPU.

  * Each group is built in both packages from one function over the v2
    layer module (`vl`), fed the same numpy batch (T <= 6, width <= 16,
    batch <= 4) and given the JAX parameters moved by name: every output's
    value and lengths, and the gradient of every parameter under a fixed
    random cotangent, within 1e-5 relative (atol 1e-6). Cases: a flat RNN,
    reversed, two outputs with `get_output_layer`, a booted `memory` with a
    sequence and a non-sequence `StaticInput`, iterated inputs of unequal
    lengths, an in-step `get_output_layer` of an LSTM step's state, and the
    twins of tests/test_recurrent_group.py's nested cases (:212, :274).
  * `gru_group` and `lstmemory_group` against the JAX package, and against
    the fused `simple_gru2` / `lstmemory` on the same parameter values.
  * The seqToseq demo's training network (demo/seqToseq/seqToseq_net.py,
    is_generating=False) and a raw-API (`RecurrentLayerGroupBegin`) config
    parse to the JAX package's `dump_config` text (the demo's but for the
    repaired cost's `from_logits`); the decoder group's and the raw
    network's outputs and gradients agree.
  * Generation's helpers (`beam_search`, `GeneratedInput`) build under
    the v2 names (their numbers: tests/test_torch_generation.py), and
    `memory` outside a group raises.
  * On a card (marked `cuda`, skipped here): the seqToseq network trains as
    one step graph (the group loops captured, no recurrent kernel) and its
    costs agree with the CPU's.
jax is imported inside the tests only."""

import textwrap

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core.stack_trace import LayerError
from paddle_tpu_torch.nn import graph as tgraph
from paddle_tpu_torch.nn.convert import params_from_jax

RTOL, ATOL = 1e-5, 1e-6


def _modules(pkg: str):
    """(v2 layer module, data_type module, graph module) of one package."""
    if pkg == "jax":
        from paddle_tpu.nn import graph
        from paddle_tpu.v2 import data_type, layer
    else:
        from paddle_tpu_torch.nn import graph
        from paddle_tpu_torch.v2 import data_type, layer
    return layer, data_type, graph


def _cotangents(values, seed=5):
    rs = np.random.RandomState(seed)
    return [np.asarray(rs.randn(*np.shape(v)), np.float32) for v in values]


def _jax_run(build, batch, seed=0):
    """-> (outputs [(value, lengths)], params, grads) of the JAX package."""
    import jax
    import jax.numpy as jnp

    vl, dt, graph = _modules("jax")
    graph.reset_name_scope()
    outs = build(vl, dt)
    net = graph.Network(outs)
    params, states = net.init(jax.random.PRNGKey(seed), batch)

    def run(p):
        got, _ = net.apply(p, states, batch)
        return [got[o.name].value for o in outs], [got[o.name].lengths for o in outs]

    values, vjp, lengths = jax.vjp(run, params, has_aux=True)
    values = [np.asarray(v) for v in values]
    (grads,) = vjp([jnp.asarray(c) for c in _cotangents(values)])
    res = [(v, None if l is None else np.asarray(l)) for v, l in zip(values, lengths)]
    return res, {k: np.asarray(v) for k, v in params.items()}, \
        {k: np.asarray(v) for k, v in grads.items()}


def _port_run(build, batch, params):
    vl, dt, graph = _modules("torch")
    graph.reset_name_scope()
    outs = build(vl, dt)
    net = graph.Network(outs)
    tp = {k: v.requires_grad_(True) for k, v in params_from_jax(params, "cpu").items()}
    got = net.apply(tp, batch)
    values = [got[o.name].value for o in outs]
    cots = _cotangents([v.detach().numpy() for v in values])
    loss = sum((v * torch.from_numpy(c)).sum() for v, c in zip(values, cots))
    names = list(tp)
    grads = torch.autograd.grad(loss, [tp[k] for k in names], allow_unused=True,
                                materialize_grads=True)
    res = [(got[o.name].value.detach().numpy(), None if got[o.name].lengths is None
            else got[o.name].lengths.numpy()) for o in outs]
    return res, {k: g.numpy() for k, g in zip(names, grads)}


def _close(got, want, what):
    scale = max(1.0, float(np.abs(want).max()) if np.size(want) else 1.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale, err_msg=what)


def _hold(build, batch):
    """Port against JAX: outputs, lengths and every parameter's gradient."""
    want, params, jgrads = _jax_run(build, batch)
    got, tgrads = _port_run(build, batch, params)
    for i, ((gv, gl), (wv, wl)) in enumerate(zip(got, want)):
        _close(gv, wv, f"output {i}")
        if wl is None:
            assert gl is None
        else:
            np.testing.assert_array_equal(gl, wl)
    assert set(tgrads) == set(jgrads)
    for k in jgrads:
        _close(tgrads[k], jgrads[k], f"grad {k}")
    return got, params


def _seq(b=4, t=6, d=8, seed=0, lengths=(6, 3, 6, 2), name="x"):
    rs = np.random.RandomState(seed)
    return {name: rs.randn(b, t, d).astype(np.float32),
            f"{name}.lengths": np.asarray(lengths[:b], np.int32)}


def _rnn(reverse=False):
    def build(vl, dt):
        seq = vl.data(name="x", type=dt.dense_vector_sequence(8))

        def step(x_t):
            mem = vl.memory(name="rnn_out", size=16)
            return vl.fc(input=[x_t, mem], size=16, act="tanh", name="rnn_out")

        return [vl.recurrent_group(step, seq, reverse=reverse)]
    return build


@pytest.mark.parametrize("reverse", [False, True], ids=["flat", "reverse"])
def test_flat_group_matches_jax(reverse):
    got, params = _hold(_rnn(reverse), _seq())
    # and a hand unroll of h_t = tanh(x_t W0 + h_{t-1} W1 + b), padded steps
    # carrying h
    batch = _seq()
    x, lens = batch["x"], batch["x.lengths"]
    w0, w1, b = (params[k] for k in ("rnn_out.w.0", "rnn_out.w.1", "rnn_out.b"))
    h = np.zeros((4, 16), np.float32)
    want = np.zeros((4, 6, 16), np.float32)
    for t in (range(5, -1, -1) if reverse else range(6)):
        new = np.tanh(x[:, t] @ w0 + h @ w1 + b)
        valid = (t < lens)[:, None]
        h = np.where(valid, new, h)
        want[:, t] = new
    np.testing.assert_allclose(got[0][0], want, rtol=1e-5, atol=1e-5)


def test_get_output_layer_and_multi_outputs():
    def build(vl, dt):
        seq = vl.data(name="x", type=dt.dense_vector_sequence(8))

        def step(x_t):
            mem = vl.memory(name="h", size=12)
            h = vl.fc(input=[x_t, mem], size=12, act="tanh", name="h")
            o = vl.fc(input=h, size=5, act="softmax", name="o")
            return h, o

        h, o = vl.recurrent_group(step, seq, name="grp")
        again = vl.get_output_layer(h, "o", name="o_again")
        return [h, o, again, vl.last_seq(input=again)]

    got, _ = _hold(build, _seq(seed=1))
    np.testing.assert_array_equal(got[1][0], got[2][0])


def test_booted_memory_and_static_inputs():
    def build(vl, dt):
        seq = vl.data(name="x", type=dt.dense_vector_sequence(8))
        enc = vl.data(name="enc", type=dt.dense_vector_sequence(6))
        ctx = vl.data(name="ctx", type=dt.dense_vector(4))
        boot = vl.fc(input=vl.last_seq(input=enc), size=10, act="tanh", name="boot")

        def step(x_t, enc_s, ctx_v):
            mem = vl.memory(name="dec", size=10, boot_layer=boot)
            pooled = vl.pool(input=enc_s)
            return vl.fc(input=[x_t, mem, pooled, ctx_v], size=10, act="tanh",
                         name="dec")

        return [vl.recurrent_group(step, [seq, vl.StaticInput(enc, is_seq=True),
                                          vl.StaticInput(ctx)])]

    rs = np.random.RandomState(2)
    batch = {**_seq(seed=2), **_seq(t=5, d=6, seed=3, lengths=(5, 4, 1, 3), name="enc"),
             "ctx": rs.randn(4, 4).astype(np.float32)}
    _hold(build, batch)


def test_unequal_iterated_lengths():
    """Two iterated inputs of different lengths: each memory and output is
    masked by its own inputs' lengths (the maximum over several)."""
    def build(vl, dt):
        a = vl.data(name="a", type=dt.dense_vector_sequence(4))
        b = vl.data(name="b", type=dt.dense_vector_sequence(4))

        def step(a_t, b_t):
            ma = vl.memory(name="ha", size=6)
            mb = vl.memory(name="hb", size=6)
            ha = vl.fc(input=[a_t, ma], size=6, act="tanh", name="ha")
            hb = vl.fc(input=[b_t, mb, ha], size=6, act="tanh", name="hb")
            return ha, hb

        return list(vl.recurrent_group(step, [a, b]))

    batch = {**_seq(t=5, d=4, seed=4, lengths=(5, 2, 3, 1), name="a"),
             **_seq(t=3, d=4, seed=6, lengths=(3, 3, 1, 2), name="b")}
    _hold(build, batch)


def test_lstm_step_state_through_get_output_layer():
    """lstmemory_unit's idiom with the v2 names: lstm_step's cell state read
    back by an in-step get_output_layer (StepArgOutput) into its memory."""
    def build(vl, dt):
        from importlib import import_module

        pkg = vl.__name__.split(".")[0]
        v1 = import_module(f"{pkg}.config.v1_layers")
        seq = vl.data(name="x", type=dt.dense_vector_sequence(8))
        proj = vl.fc(input=seq, size=16, act=None, name="proj")

        def step(x_t):
            out_mem = vl.memory(name="lstm", size=4)
            state_mem = vl.memory(name="lstm_state", size=4)
            m = vl.mixed(size=16, input=[vl.identity_projection(x_t),
                                         vl.full_matrix_projection(out_mem)],
                         name="lstm_input_recurrent")
            h = v1.lstm_step_layer(input=m, state=state_mem, size=4, name="lstm")
            v1.get_output_layer(input=h, arg_name="state", name="lstm_state")
            return h

        return [vl.recurrent_group(step, proj)]

    _hold(build, _seq(seed=7))


def _nested_batch(b, s_max, t_sub, d, outer, sub, seed):
    rs = np.random.RandomState(seed)
    return {"x": rs.randn(b, s_max, t_sub, d).astype(np.float32),
            "x.lengths": np.asarray(outer, np.int32),
            "x.sub_lengths": np.asarray(sub, np.int32)}


def test_nested_group_matches_jax_and_flat_chain():
    """Twin of tests/test_recurrent_group.py:212: an outer group over
    SubsequenceInput whose inner RNN is booted from an outer memory (the
    last inner state) equals one flat RNN over the concatenated tokens."""
    h = 16

    def build(vl, dt):
        seq = vl.data(name="x", type=dt.dense_vector_sequence(8))

        def outer_step(xs):
            outer_mem = vl.memory(name="outer_state", size=h)

            def inner_step(y):
                inner_mem = vl.memory(name="inner_state", size=h, boot_layer=outer_mem)
                return vl.fc(input=[y, inner_mem], size=h, act="tanh", name="inner_state")

            inner_out = vl.recurrent_group(inner_step, xs, name="inner_rnn")
            vl.last_seq(input=inner_out, name="outer_state")
            return inner_out

        out = vl.recurrent_group(outer_step, vl.SubsequenceInput(seq), name="outer_rnn")
        return [vl.last_seq(input=out), out]

    outer, sub = [3, 2, 1], [[4, 2, 3], [3, 4, 1], [2, 1, 1]]
    batch = _nested_batch(3, 3, 4, 8, outer, sub, 0)
    got, params = _hold(build, batch)
    w0, w1, bb = (params[k] for k in ("inner_state.w.0", "inner_state.w.1",
                                      "inner_state.b"))
    want = np.zeros((3, h), np.float32)
    for i in range(3):
        hh = np.zeros(h, np.float32)
        for s in range(outer[i]):
            for t in range(sub[i][s]):
                hh = np.tanh(batch["x"][i, s, t] @ w0 + hh @ w1 + bb)
        want[i] = hh
    np.testing.assert_allclose(got[0][0], want, rtol=2e-5, atol=2e-5)
    assert got[1][0].shape == (3, 3, 4, h)


def test_nested_group_flat_step_output_is_level1_seq():
    """Twin of tests/test_recurrent_group.py:274: a non-sequence step output
    of a nested group is a level-1 sequence over the subsequence index."""
    def build(vl, dt):
        seq = vl.data(name="x", type=dt.dense_vector_sequence(4))

        def outer_step(xs):
            def inner_step(y):
                mem = vl.memory(name="m", size=8)
                return vl.fc(input=[y, mem], size=8, act="tanh", name="m")

            return vl.last_seq(input=vl.recurrent_group(inner_step, xs, name="in2"))

        return [vl.recurrent_group(outer_step, vl.SubsequenceInput(seq), name="outer2")]

    batch = _nested_batch(2, 2, 3, 4, [2, 1], [[3, 2], [1, 1]], 1)
    got, _ = _hold(build, batch)
    assert got[0][0].shape == (2, 2, 8)
    np.testing.assert_array_equal(got[0][1], [2, 1])


def _v1(pkg):
    from importlib import import_module

    return import_module(f"{pkg}.config.v1_layers")


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_gru_group_matches_jax_and_fused_gru(reverse):
    def build(vl, dt):
        v1 = _v1(vl.__name__.split(".")[0])
        x = vl.data(name="x", type=dt.dense_vector_sequence(8))
        return [v1.simple_gru(input=x, size=6, name="g", reverse=reverse)]

    got, params = _hold(build, _seq(seed=8))
    # simple_gru2 (the fused grumemory) on the same values: its transform
    # and GRU parameters carry the same names
    vl, dt, graph = _modules("torch")
    graph.reset_name_scope()
    x = vl.data(name="x", type=dt.dense_vector_sequence(8))
    fused = _v1("paddle_tpu_torch").simple_gru2(input=x, size=6, name="g", reverse=reverse)
    net = graph.Network([fused])
    tp = params_from_jax(params, "cpu")
    assert set(tp) == {n for n in net.init(_seq(seed=8), device="cpu")}
    out = net.apply(tp, _seq(seed=8))[fused.name].value.numpy()
    mask = (np.arange(6)[None, :] < _seq()["x.lengths"][:, None])[..., None]
    np.testing.assert_allclose(got[0][0] * mask, out * mask, rtol=1e-5, atol=1e-6)


def test_lstmemory_group_matches_jax_and_lstmemory():
    def build(vl, dt):
        v1 = _v1(vl.__name__.split(".")[0])
        x = vl.data(name="x", type=dt.dense_vector_sequence(8))
        proj = vl.fc(input=x, size=16, act=None, name="proj")
        return [v1.lstmemory_group(input=proj, size=4, name="lg")]

    got, params = _hold(build, _seq(seed=9))
    # lstmemory on the same values: w_hh is the group's recurrent
    # projection, the peepholes the step's; the mixed layer has no bias
    from paddle_tpu_torch.nn import recurrent as TR

    vl, dt, graph = _modules("torch")
    graph.reset_name_scope()
    x = vl.data(name="x", type=dt.dense_vector_sequence(8))
    proj = vl.fc(input=x, size=16, act=None, name="proj")
    lstm = TR.Lstm(proj, size=4, name="ref")
    net = graph.Network([lstm])
    peep = params["lg.b"]
    tp = params_from_jax({
        "proj.w": params["proj.w"], "proj.b": params["proj.b"],
        "ref.w_hh": params["lg_input_recurrent.proj1.w"],
        "ref.b": np.zeros(16, np.float32),
        "ref.check_i": peep[:4], "ref.check_f": peep[4:8], "ref.check_o": peep[8:],
    }, "cpu")
    out = net.apply(tp, _seq(seed=9))[lstm.name].value.numpy()
    mask = (np.arange(6)[None, :] < _seq()["x.lengths"][:, None])[..., None]
    np.testing.assert_allclose(got[0][0] * mask, out * mask, rtol=1e-5, atol=1e-6)


# the seqToseq demo's training network (demo/seqToseq/seqToseq_net.py of
# PaddlePaddle v0.11, is_generating=False) at a small width
SEQ2SEQ = """
from paddle.trainer_config_helpers import *

src_dict_dim = get_config_arg('src_dict', int, 20)
trg_dict_dim = get_config_arg('trg_dict', int, 24)
word_vector_dim = get_config_arg('word_dim', int, 8)
encoder_size = get_config_arg('enc', int, 8)
decoder_size = get_config_arg('dec', int, 8)
settings(batch_size=4, learning_rate=5e-4, learning_method=AdamOptimizer())

src_word_id = data_layer(name='source_language_word', size=src_dict_dim)
src_embedding = embedding_layer(
    input=src_word_id, size=word_vector_dim,
    param_attr=ParamAttr(name='_source_language_embedding'))
src_forward = simple_gru(input=src_embedding, size=encoder_size, naive=True,
                         gru_layer_attr=ExtraLayerAttribute(error_clipping_threshold=50))
src_backward = simple_gru(input=src_embedding, size=encoder_size, reverse=True,
                          naive=True,
                          gru_layer_attr=ExtraLayerAttribute(error_clipping_threshold=50))
encoded_vector = concat_layer(input=[src_forward, src_backward])

with mixed_layer(size=decoder_size) as encoded_proj:
    encoded_proj += full_matrix_projection(input=encoded_vector)

backward_first = first_seq(input=src_backward)
with mixed_layer(size=decoder_size, act=TanhActivation()) as decoder_boot:
    decoder_boot += full_matrix_projection(input=backward_first)


def gru_decoder_with_attention(enc_vec, enc_proj, current_word):
    decoder_mem = memory(name='gru_decoder', size=decoder_size, boot_layer=decoder_boot)
    context = simple_attention(encoded_sequence=enc_vec, encoded_proj=enc_proj,
                               decoder_state=decoder_mem)
    with mixed_layer(size=decoder_size * 3) as decoder_inputs:
        decoder_inputs += full_matrix_projection(input=context)
        decoder_inputs += full_matrix_projection(input=current_word)
    gru_step = gru_step_layer(name='gru_decoder', input=decoder_inputs,
                              output_mem=decoder_mem, size=decoder_size)
    with mixed_layer(size=trg_dict_dim, bias_attr=True, act=SoftmaxActivation()) as out:
        out += full_matrix_projection(input=gru_step)
    return out


group_inputs = [StaticInput(input=encoded_vector, is_seq=True),
                StaticInput(input=encoded_proj, is_seq=True)]
trg_embedding = embedding_layer(
    input=data_layer(name='target_language_word', size=trg_dict_dim),
    size=word_vector_dim, param_attr=ParamAttr(name='_target_language_embedding'))
group_inputs.append(trg_embedding)
decoder = recurrent_group(name='decoder_group', step=gru_decoder_with_attention,
                          input=group_inputs)
lbl = data_layer(name='target_language_next_word', size=trg_dict_dim)
outputs(classification_cost(input=decoder, label=lbl))
"""

RAW = """
model_type('recurrent_nn')
Settings(batch_size=4, learning_rate=1e-3)
Inputs('word')
Layer(name='word', type='data', size=12)
Layer(name='emb', type='mixed', size=6, bias=False,
      inputs=TableProjection('word', parameter_name='emb_table'))
RecurrentLayerGroupBegin('rnn_group', in_links=['emb'], out_links=['rnn_state'])
Memory(name='rnn_state', size=6)
Layer(name='rnn_state', type='mixed', size=6, active_type='tanh', bias=Bias(),
      inputs=[IdentityProjection('emb'),
              FullMatrixProjection('rnn_state+delay1', parameter_name='rnn_w')])
RecurrentLayerGroupEnd('rnn_group')
Layer(name='last', type='seqlastins', inputs=['rnn_state'])
Layer(name='out', type='fc', size=3, active_type='softmax', inputs=['last'])
Outputs('out')
"""


def _write(tmp_path, text, name="conf.py"):
    p = tmp_path / name
    p.write_text(textwrap.dedent(text))
    return str(p)


def _seq2seq_batch(b=4, src=20, trg=24, seed=0):
    rs = np.random.RandomState(seed)
    sl = np.asarray([5, 3, 6, 2][:b], np.int32)
    tl = np.asarray([4, 6, 2, 5][:b], np.int32)
    return {"source_language_word": rs.randint(0, src, (b, 6)).astype(np.int32),
            "source_language_word.lengths": sl,
            "target_language_word": rs.randint(0, trg, (b, 6)).astype(np.int32),
            "target_language_word.lengths": tl,
            "target_language_next_word": rs.randint(0, trg, (b, 6)).astype(np.int32),
            "target_language_next_word.lengths": tl}


def _config_parity(path, batch, out=None, repaired=False):
    """dump_config text equal (with `repaired`, but for the cost's
    from_logits, ROADMAP.md §3 fault 10); the layer `out` (default the
    first output) and the gradients of its sum under a fixed cotangent
    within 1e-5 relative on the JAX parameters."""
    import jax
    from paddle_tpu import proto as jproto
    from paddle_tpu.config import parse_config as jparse
    from paddle_tpu.nn.graph import Network as JNetwork
    from paddle_tpu_torch import proto as tproto
    from paddle_tpu_torch.config import parse_config as tparse

    jpc, tpc = jparse(path), tparse(path)
    jtext = jproto.to_text(jpc.trainer_config)
    want = jtext.replace("from_logits: true", "from_logits: false") if repaired else jtext
    assert tproto.to_text(tpc.trainer_config) == want
    out = out or jpc.outputs[0].name
    jnet = JNetwork([jpc.topology.network.layers_by_name[out]])
    tnet = tgraph.Network([tpc.topology.network.layers_by_name[out]])
    params, states = jnet.init(jax.random.PRNGKey(0), batch)
    jout, vjp = jax.vjp(lambda p: jnet.apply(p, states, batch)[0][out].value, params)
    jout = np.asarray(jout)
    (cot,) = _cotangents([jout])
    (jgrads,) = vjp(jax.numpy.asarray(cot))
    tp = {k: v.requires_grad_(True) for k, v in params_from_jax(params, "cpu").items()}
    tout = tnet.apply(tp, batch)[out].value
    names = list(tp)
    tgrads = torch.autograd.grad((tout * torch.from_numpy(cot)).sum(),
                                 [tp[k] for k in names], allow_unused=True,
                                 materialize_grads=True)
    _close(tout.detach().numpy(), jout, "output")
    for k, g in zip(names, tgrads):
        _close(g.numpy(), np.asarray(jgrads[k]), f"grad {k}")
    return jtext, names


def test_seq2seq_demo_config_dump_outputs_and_grads(tmp_path):
    """The decoder group's softmax outputs and every gradient through the
    three groups; the cost itself is repaired (tests/test_torch_repairs.py)."""
    text, names = _config_parity(_write(tmp_path, SEQ2SEQ), _seq2seq_batch(),
                                 out="decoder_group", repaired=True)
    for want in ('type: "recurrent_layer_group"', 'type: "scatter_agent"',
                 'type: "gather_agent"', 'gru_decoder+delay1@decoder_group',
                 'type: "gru_step"', 'type: "error_clip"'):
        assert want in text, want
    assert {"_source_language_embedding", "_target_language_embedding"} <= set(names)


def test_raw_api_recurrent_layer_group_config(tmp_path):
    rs = np.random.RandomState(3)
    batch = {"word": rs.randint(0, 12, (3, 5)).astype(np.int32),
             "word.lengths": np.asarray([5, 2, 4], np.int32)}
    text, names = _config_parity(_write(tmp_path, RAW), batch)
    assert 'name: "rnn_group"' in text and "rnn_w" in names


def test_generation_raises_the_next_slices_error():
    """Generation was the next slice and is ported: GeneratedInput and
    beam_search build a generating node; a beam_search without a
    GeneratedInput fails when it runs, and memory outside a group raises."""
    vl, dt, graph = _modules("torch")
    graph.reset_name_scope()
    gen_in = vl.GeneratedInput(size=6, embedding_name="emb", embedding_size=4)
    enc = vl.data(name="enc", type=dt.dense_vector_sequence(4))
    node = vl.beam_search(lambda e, w: vl.fc(input=[vl.pool(input=e), w], size=6,
                                             act="softmax"),
                          input=[vl.StaticInput(enc, is_seq=True), gen_in],
                          bos_id=0, eos_id=1, beam_size=2, max_length=3)
    assert node.type_name == "beam_search" and node.core.generated is gen_in
    batch = _seq(b=2, t=3, d=4, lengths=(3, 2), name="enc")
    out = graph.Network([node]).init(batch, device="cpu")
    assert "emb" in out
    bad = vl.beam_search(lambda e: vl.fc(input=vl.pool(input=e), size=6, act="softmax"),
                         input=[vl.StaticInput(enc, is_seq=True)], bos_id=0, eos_id=1)
    with pytest.raises(LayerError, match="needs a GeneratedInput"):
        graph.Network([bad]).init(batch, device="cpu")
    with pytest.raises(RuntimeError, match="inside a recurrent_group"):
        vl.memory(name="m", size=3)


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_seq2seq_config_trains_as_one_graph_and_matches_cpu(cuda, tmp_path):
    """The seqToseq demo's network at a small width on the card: the
    groups' step loops are captured in the training step's graph (later
    steps replay it, no recurrent kernel launches) and the costs of 4 steps
    agree with the CPU's from the same parameters (1e-5 relative)."""
    from paddle_tpu_torch.config import parse_config
    from paddle_tpu_torch.ops import rnn_kernels
    from paddle_tpu_torch.optim import optimizers
    from paddle_tpu_torch.trainer.trainer import SGDTrainer

    path = _write(tmp_path, SEQ2SEQ)
    batch = _seq2seq_batch()
    trainers = {}
    for dev in ("cpu", "cuda"):
        tr = SGDTrainer(parse_config(path).outputs, optimizers.Adam(5e-4), device=dev)
        tr.init_state(batch)
        trainers[dev] = tr
    trainers["cuda"].load_params(trainers["cpu"].state["params"])
    before = (rnn_kernels.FWD_LAUNCHES, rnn_kernels.BWD_LAUNCHES)
    costs = {dev: [float(tr.step(batch)) for _ in range(4)] for dev, tr in trainers.items()}
    assert (rnn_kernels.FWD_LAUNCHES, rnn_kernels.BWD_LAUNCHES) == before
    (graph,) = trainers["cuda"].graphs.values()
    assert graph.replays == 3
    np.testing.assert_allclose(costs["cuda"], costs["cpu"], rtol=1e-5)
