"""Arguments and behaviours of the JAX package's layers that the port
rejected or differed on, each against the JAX package on the CPU.

  * `Embedding` without `vocab_size` takes the vocabulary from the input
    Data's `shape[0]` (and raises ValueError without one); ids read as
    `jnp.take` reads them: [-V, 0) from the end, everything else outside
    [0, V) a NaN row with no gradient. Values bitwise (NaN where NaN), the
    table's gradient under a random cotangent within 1e-6.
  * `AttentionDecoder(attention_size=A)`: the attention projections are A
    wide; the decoder's sum-cost and every gradient within 1e-5 relative /
    rtol 1e-4 / atol 1e-5 (the JAX scan's tolerance in
    tests/test_torch_gru.py).
  * `Gru(act=, gate_act=, param_attr=, bias_attr=)` and `simple_gru` /
    `bidirectional_gru(**kw)`: a named `param_attr` shares `w_hzr` under
    the name and `w_hc` under the name + ".c"; activations other than
    the defaults take the step loop (the kernels compute sigmoid and tanh
    only). Same tolerances.
  * The "not ported" messages name ROADMAP.md's items by their numbers
    there (§1 item 5, the v1 config pipeline; item 8, TP serving); none
    says "the next slice" since generation was ported, and every entry
    point that said so runs: `GeneratedInput`, `beam_search`,
    `api.SequenceGenerator`, `serve --config`, `generate_config`,
    `trainer/generation.py` and the ProtoData providers.
  * `outputs('__beam_search_predict__')` (the reference's default name of
    the beam_search output) resolves to the config's beam_search node, or
    to an outer group whose step generates, as in the JAX package; with no
    such node, and no other output, both parses fail with ValueError.
  * `SGDTrainer.train(log_period=N)` (the JAX trainer's argument, which
    the port rejected): the same "pass P batch B cost=" marks as the JAX
    trainer, per step and per K-step dispatch, each read from a copy
    started one dispatch earlier; with log_period=0 a pass reads one
    device value on the host (its average cost), whatever its length.
  * `classification_cost` sees the softmax of its input through a
    recurrent group (to the step's output layer) and through an error
    clip, and consumes the probabilities: the seqToseq demo's cost is the
    cross-entropy of the decoder's softmax (within 1e-5 of numpy's on the
    JAX package's probabilities); the JAX package's is that of a second
    softmax over them.
  * `v2.networks.simple_gru(name=)` names the GRU (the JAX package drops
    the name, so two directions in one v2 network collide there); without
    a name both packages build the same "gru" layers and parameters.
  * On a card (marked `cuda`, skipped here): a `Gru(act="relu")` graph on
    the card takes the step loop (no GRU kernel launch) and matches the
    CPU; out-of-range ids read NaN rows on the card with no device assert.
jax is imported inside the CPU tests only."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core.stack_trace import LayerError
from paddle_tpu_torch.nn import costs as TC
from paddle_tpu_torch.nn import graph as tgraph
from paddle_tpu_torch.nn import layers as TL
from paddle_tpu_torch.nn import recurrent as TR
from paddle_tpu_torch.nn.attention_layers import AttentionDecoder as TAttentionDecoder
from paddle_tpu_torch.nn.convert import params_from_jax
from paddle_tpu_torch.ops import rnn_kernels as K

REPO = Path(__file__).resolve().parents[1]


def _jax_params(cost, batch):
    import jax

    from paddle_tpu.nn.graph import Network

    net = Network([cost])
    params, states = net.init(jax.random.PRNGKey(0), batch)
    return net, params, states


def _compare_sum_cost(build, batch, monkeypatch):
    """build(pkg) -> cost layer, pkg a dict of either package's modules:
    the JAX package's cost and gradients against the port's at the JAX
    parameters."""
    import jax

    from paddle_tpu.nn import costs as JC
    from paddle_tpu.nn import graph as jgraph
    from paddle_tpu.nn import layers as JL
    from paddle_tpu.nn import recurrent as JR
    from paddle_tpu.nn.attention_layers import AttentionDecoder as JAttentionDecoder

    monkeypatch.setenv("PADDLE_TPU_PALLAS", "0")
    jgraph.reset_name_scope()
    jcost = build(dict(L=JL, C=JC, R=JR, A=JAttentionDecoder, P=jgraph.ParamAttr))
    net, params, states = _jax_params(jcost, batch)
    cj, gj = jax.value_and_grad(
        lambda p: net.apply(p, states, batch, train=True)[0][jcost.name].value)(params)
    tgraph.reset_name_scope()
    tcost = build(dict(L=TL, C=TC, R=TR, A=TAttentionDecoder, P=tgraph.ParamAttr))
    tnet = tgraph.Network([tcost])
    own = tnet.init(batch, device="cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: tuple(v.shape) for k, v in params.items()}
    tp = {k: v.requires_grad_(True) for k, v in params_from_jax(params, "cpu").items()}
    ct = tnet.apply(tp, batch)[tcost.name].value
    names = sorted(tp)
    gt = dict(zip(names, torch.autograd.grad(ct, [tp[k] for k in names])))
    assert abs(float(ct.detach()) - float(cj)) <= 1e-5 * abs(float(cj))
    for k in names:
        np.testing.assert_allclose(gt[k].numpy(), np.asarray(gj[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    return sorted(params)


# -- Embedding ---------------------------------------------------------------


def test_embedding_takes_vocab_from_the_input_shape():
    tgraph.reset_name_scope()
    emb = TL.Embedding(TL.Data("ids", shape=(10,), is_seq=True), 4, name="emb")
    batch = {"ids": np.array([[1, 2, 9]]), "ids.lengths": np.array([3])}
    params = tgraph.Network([emb]).init(batch, device="cpu")
    assert tuple(params["emb.w"].shape) == (10, 4)
    bare = TL.Embedding(TL.Data("ids2", shape=()), 4, name="emb2")
    # a forward's error names its layer, as the JAX package's LayerError does
    with pytest.raises(LayerError, match=r"error in layer 'emb2' .*vocab_size"):
        tgraph.Network([bare]).init({"ids2": np.array([1])}, device="cpu")


def test_embedding_out_of_range_ids_match_jnp_take():
    import jax
    import jax.numpy as jnp

    from paddle_tpu.nn import graph as jgraph
    from paddle_tpu.nn import layers as JL

    ids = np.array([[1, -1, 4, -4, -5], [3, 7, 0, -2, 2]], np.int32)
    batch = {"ids": ids, "ids.lengths": np.array([5, 4], np.int32)}
    jgraph.reset_name_scope()
    jemb = JL.Embedding(JL.Data("ids", shape=(4,), is_seq=True), 3, name="emb")
    net, params, states = _jax_params(jemb, batch)
    want, vjp = jax.vjp(lambda p: net.apply(p, states, batch)[0]["emb"].value, params)
    cot = np.random.RandomState(0).randn(*want.shape).astype(np.float32)
    (want_g,) = vjp(jnp.asarray(cot))

    tgraph.reset_name_scope()
    temb = TL.Embedding(TL.Data("ids", shape=(4,), is_seq=True), 3, name="emb")
    table = params_from_jax(params, "cpu")["emb.w"].requires_grad_(True)
    got = tgraph.Network([temb]).apply({"emb.w": table}, batch)["emb"].value
    (got_g,) = torch.autograd.grad(got, table, torch.from_numpy(cot))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    assert np.isnan(got.detach().numpy()[[0, 1], [4, 1]]).all()
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g["emb.w"]), atol=1e-6)


# -- AttentionDecoder(attention_size=) -----------------------------------------


def test_attention_decoder_takes_attention_size(monkeypatch):
    rs = np.random.RandomState(1)
    batch = {"enc": rs.randn(3, 4, 5).astype(np.float32),
             "enc.lengths": np.array([4, 2, 3], np.int32),
             "emb": rs.randn(3, 3, 6).astype(np.float32),
             "emb.lengths": np.array([3, 3, 1], np.int32)}

    def build(m):
        enc = m["L"].Data("enc", shape=(5,), is_seq=True)
        emb = m["L"].Data("emb", shape=(6,), is_seq=True)
        dec = m["A"](enc, emb, 8, attention_size=4, name="dec")
        return m["C"].SumCost(dec, name="cost")

    names = _compare_sum_cost(build, batch, monkeypatch)
    assert "dec.att.v" in names
    tgraph.reset_name_scope()
    dec = TAttentionDecoder(TL.Data("enc", shape=(5,), is_seq=True),
                            TL.Data("emb", shape=(6,), is_seq=True), 8, attention_size=4,
                            name="dec")
    params = tgraph.Network([dec]).init(batch, device="cpu")
    assert tuple(params["dec.att.w_enc"].shape) == (5, 4)
    assert tuple(params["dec.att.w_dec"].shape) == (8, 4)
    assert tuple(params["dec.att.v"].shape) == (4,)
    assert tuple(params["dec.gru.w_hc"].shape) == (8, 8)


# -- Gru's arguments -----------------------------------------------------------


def gru_batch(seed=2):
    rs = np.random.RandomState(seed)
    return {"x": rs.randn(3, 5, 4).astype(np.float32) * 0.5,
            "x.lengths": np.array([5, 1, 3], np.int32)}


def gru_cost(m, act="relu", gate_act="sigmoid", shared=True):
    x = m["L"].Data("x", shape=(4,), is_seq=True)
    kw = dict(act=act, gate_act=gate_act)
    if shared:
        kw.update(param_attr=m["P"](name="gru_w"), bias_attr=m["P"](name="gru_b"))
    h = m["R"].bidirectional_gru(x, 6, name="bigru", **kw)
    return m["C"].SumCost(h, name="cost")


@pytest.mark.parametrize("act,gate_act,shared", [
    ("relu", "sigmoid", True),
    ("tanh", "sigmoid", True),
    ("tanh", "relu", False),
])
def test_gru_takes_the_reference_arguments(monkeypatch, act, gate_act, shared):
    names = _compare_sum_cost(lambda m: gru_cost(m, act, gate_act, shared), gru_batch(),
                              monkeypatch)
    if shared:
        assert {"gru_w", "gru_w.c", "gru_b"} <= set(names)
        assert not any(n.startswith("bigru.fw.w_") for n in names)


def test_non_default_gru_takes_the_step_loop(monkeypatch):
    from paddle_tpu_torch.ops import rnn as trnn

    calls = []
    real = trnn.gru_seq_fused
    monkeypatch.setattr(trnn, "gru_seq_fused", lambda *a: calls.append(1) or real(*a))
    batch = gru_batch()
    for act, want in (("relu", 0), ("tanh", 2)):
        tgraph.reset_name_scope()
        net = tgraph.Network([gru_cost(dict(L=TL, C=TC, R=TR, P=tgraph.ParamAttr), act)])
        params = net.init(batch, device="cpu")
        calls.clear()
        net.apply(params, batch)
        assert len(calls) == want, act


# -- the "not ported" messages -------------------------------------------------


def _roadmap_item(n: int) -> str:
    text = (REPO / "ROADMAP.md").read_text()
    section = text[text.index("### 1. Modules to port"):text.index("### 2.")]
    return re.search(rf"^{n}\. \*\*(.+?)\*\*", section, re.M | re.S).group(1)


def test_not_ported_messages_name_the_roadmap_items():
    from paddle_tpu_torch import cli

    assert "v1 config pipeline" in _roadmap_item(5)
    assert "TP serving" in _roadmap_item(8)
    serve = ["serve", "--device", "cpu", "--demo"]
    # item 8b is ported: `serve --tp 2` launches its ranks
    # (tests/test_torch_cli_serve.py), with or without --config
    for argv in (["--tp", "2"], ["--tp", "2", "--config", "c.py"]):
        args = cli.parse_args(serve + argv)
        assert args.tp == 2 and args.fn is cli.cmd_serve
    # items 7b and 8a are ported: neither --master_endpoints nor
    # --trainer_count > 1 is a named error; what stays of item 8 (a mesh
    # trainer's resize, item 8c) names it
    args = cli.parse_args(["train", "--device", "cpu", "--config", "c.py",
                           "--master_endpoints", "127.0.0.1:1", "--trainer_count", "2"])
    assert cli._refuse_unported(args) is None
    from paddle_tpu_torch.models.ctr import ctr_wide_deep
    from paddle_tpu_torch.nn import costs as C
    from paddle_tpu_torch.nn import layers as L
    from paddle_tpu_torch.optim.optimizers import SGD
    from paddle_tpu_torch.parallel import DataParallel, make_mesh
    from paddle_tpu_torch.trainer.trainer import SGDTrainer

    for axes in ({"data": 1, "model": 2}, {"seq": 2}):
        # the model and seq axes are ported: two ranks need a group
        with pytest.raises(RuntimeError, match=r"parallel\.distributed\.initialize"):
            make_mesh(axes, device="cpu")
    *_, ctr_cost = ctr_wide_deep(embedding_sharding=("expert", None))
    assert ctr_cost.name == "cost"
    x = L.Data("x", shape=(4,))
    cost = C.SquareError(L.Fc(x, 1, act=None, name="o"), L.Data("y", shape=(1,)))
    tr = SGDTrainer(cost, SGD(), device="cpu",
                    parallel=DataParallel(make_mesh({"data": 1}, device="cpu")))
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md §1 item 8"):
        tr.resize_to(2)
    stale = re.compile(r"queue 1|item 3\.3|item 6, TP|pipeline of item 7")
    for path in sorted((REPO / "paddle_tpu_torch").rglob("*.py")):
        assert not stale.search(path.read_text()), path


def test_named_errors_left_name_their_item_not_the_next_slice():
    """The datasets and image helpers, item 5's last named error, are the
    port's own modules now; what is still to port names ROADMAP.md §1 item
    5 / 6 / 7 / 8; no file of the port says "the next slice"."""
    import paddle_tpu_torch.v2 as tpaddle
    from paddle_tpu_torch.data import datasets, image

    assert tpaddle.dataset is datasets and tpaddle.image is image
    assert tpaddle.dataset.wmt14.__name__ == "paddle_tpu_torch.data.datasets.wmt14"
    for path in sorted((REPO / "paddle_tpu_torch").rglob("*.py")):
        assert "next slice" not in path.read_text(), path
    roadmap = (REPO / "ROADMAP.md").read_text()
    section = roadmap[roadmap.index("5. **The v1 config pipeline"):roadmap.index("6. **")]
    for left in ("fluid/*", "trainer/multi_network.py", "utils/*", "ctypes"):
        assert left in section, left


def test_entry_points_that_were_the_next_slice_run(tmp_path):
    """Each entry point that raised "the next slice" before generation was
    ported now builds and runs on the CPU (their numbers against the JAX
    package: tests/test_torch_generation*.py, test_torch_proto_data.py)."""
    from paddle_tpu_torch import api
    from paddle_tpu_torch.data import proto_data
    from paddle_tpu_torch.data.provider import load_provider
    from paddle_tpu_torch.proto import DataConfig
    from paddle_tpu_torch.serving import ServingClient, ServingServer
    from paddle_tpu_torch.trainer.generation import GenerationSession
    from paddle_tpu_torch.v2 import data_type as tdt
    from paddle_tpu_torch.v2 import layer as tvl

    tgraph.reset_name_scope()
    enc = tvl.data(name="enc", type=tdt.dense_vector_sequence(4))
    gen = tvl.beam_search(
        lambda e, w: tvl.fc(input=[tvl.pool(input=e), w], size=5, act="softmax"),
        input=[tvl.StaticInput(enc, is_seq=True),
               tvl.GeneratedInput(size=5, embedding_name="emb", embedding_size=3)],
        bos_id=0, eos_id=1, beam_size=2, max_length=4, name="gen")
    batch = {"enc": np.ones((2, 3, 4), np.float32), "enc.lengths": np.asarray([3, 1], np.int32)}
    gm = api.GradientMachine([gen], device="cpu")
    seqs = api.SequenceGenerator(gm, gen).generate(batch)
    assert len(seqs) == 2 and all(1 <= len(s) <= 4 for s in seqs)

    class Parsed:  # what GenerationSession reads of a parsed config
        outputs = [gen]

        class context:
            evaluators = []

    sess = GenerationSession(Parsed, device="cpu")
    assert sess.generate(batch) == {} and sess.built
    srv = ServingServer(gen_session=sess, port=0).start()
    try:
        c = ServingClient(srv.address)
        assert c.generate_config(batch) == {}
        c.close()
    finally:
        srv.stop()

    shard = str(tmp_path / "s.bin")
    proto_data.write_shard(shard, [proto_data.SlotDef(proto_data.INDEX, 3)],
                           [proto_data.DataSample(id_slots=[i % 3]) for i in range(5)])
    (tmp_path / "s.list").write_text(shard + "\n")
    dc = DataConfig(type="proto", files="s.list", config_dir=str(tmp_path))
    prov, files, _ = load_provider(dc)
    assert files == [shard] and load_provider(dc)[0] is prov
    assert [s for s in prov(file_list=files, is_train=False)] == [(i % 3,) for i in range(5)]


def test_beam_search_predict_resolves_as_in_jax(tmp_path):
    """`Outputs('__beam_search_predict__')`: the beam_search node, or the
    outer group of a nested generation; without one, and no other output,
    both packages' parses raise ValueError."""
    import textwrap

    from paddle_tpu.config import parse_config as jparse

    from paddle_tpu_torch.config import parse_config as tparse

    head = """
        from paddle.trainer_config_helpers import *
        enc = data_layer(name="enc", size=4)
        """
    gen = """
        def step(e, w):
            return fc_layer(input=[pooling_layer(input=e), w], size=5,
                            act=SoftmaxActivation())
        beam_search(step=step, input=[StaticInput(enc, is_seq=True),
                    GeneratedInput(size=5, embedding_name="emb", embedding_size=3)],
                    bos_id=0, eos_id=1, beam_size=2, max_length=4, name="gen")
        """
    nested = """
        def outer(xs):
            def step(e, w):
                return fc_layer(input=[pooling_layer(input=e), w], size=5,
                                act=SoftmaxActivation())
            return beam_search(step=step, input=[StaticInput(xs, is_seq=True),
                               GeneratedInput(size=5, embedding_name="emb",
                                              embedding_size=3)],
                               bos_id=0, eos_id=1, beam_size=2, max_length=4, name="gen")
        recurrent_group(step=outer, input=SubsequenceInput(enc), name="outer_gen")
        """
    plain = """
        fc_layer(input=enc, size=3, name="other")
        """
    tail = """
        Outputs("__beam_search_predict__")
        """
    for body, want in ((gen, "gen"), (nested, "outer_gen"), (plain, None)):
        path = tmp_path / "conf.py"
        path.write_text(textwrap.dedent(head) + textwrap.dedent(body) + textwrap.dedent(tail))
        if want is None:
            for parse in (jparse, tparse):
                with pytest.raises(ValueError, match="declared no outputs"):
                    parse(str(path), emit_proto=False)
            continue
        names = [[l.name for l in parse(str(path), emit_proto=False).outputs]
                 for parse in (jparse, tparse)]
        assert names == [[want], [want]]


def test_cost_sees_the_softmax_through_a_group_and_an_error_clip(tmp_path):
    import jax
    from paddle_tpu.config import parse_config as jparse
    from paddle_tpu.nn.graph import Network as JNetwork

    from paddle_tpu_torch.config import parse_config as tparse
    from paddle_tpu_torch.nn.convert import params_from_jax
    from test_torch_recurrent_group import SEQ2SEQ, _seq2seq_batch

    path = tmp_path / "s2s.py"
    path.write_text(SEQ2SEQ)
    batch = _seq2seq_batch()
    jpc, tpc = jparse(str(path)), tparse(str(path))
    cost = jpc.outputs[0].name
    jnet = JNetwork([jpc.outputs[0], jpc.topology.network.layers_by_name["decoder_group"]])
    params, states = jnet.init(jax.random.PRNGKey(0), batch)
    outs = jnet.apply(params, states, batch)[0]
    probs, jcost = np.asarray(outs["decoder_group"].value), float(outs[cost].value)
    tcost = float(tpc.topology.network.apply(params_from_jax(params, "cpu"), batch)[cost].value)
    labels, lens = batch["target_language_next_word"], batch["target_language_next_word.lengths"]
    valid = np.arange(labels.shape[1])[None, :] < lens[:, None]

    def ce(p):
        picked = np.take_along_axis(p, labels[..., None], -1)[..., 0]
        return float((-np.log(picked) * valid).sum(-1).mean())

    resoftmax = np.exp(probs) / np.exp(probs).sum(-1, keepdims=True)
    assert tcost == pytest.approx(ce(probs), rel=1e-5)
    assert jcost == pytest.approx(ce(resoftmax), rel=1e-5)  # the JAX package's fault
    assert tpc.outputs[0].from_logits is False and jpc.outputs[0].from_logits is True

    tgraph.reset_name_scope()
    from paddle_tpu_torch.config import v1_layers as v1
    from paddle_tpu_torch.v2.attr import ExtraAttr

    x = v1.data_layer("x", 4)
    out = v1.fc_layer(x, 3, act="softmax",
                      layer_attr=ExtraAttr(error_clipping_threshold=5.0))
    assert out.type_name == "error_clip"
    assert v1.classification_cost(out, v1.data_layer("y", 3)).from_logits is False


def test_v2_simple_gru_takes_a_name():
    from paddle_tpu.nn import graph as jgraph
    from paddle_tpu.v2 import data_type as jdt
    from paddle_tpu.v2 import networks as jnets

    from paddle_tpu_torch.v2 import data_type as tdt
    from paddle_tpu_torch.v2 import networks as tnets

    jgraph.reset_name_scope()
    tgraph.reset_name_scope()
    from paddle_tpu.v2 import layer as jvl
    from paddle_tpu_torch.v2 import layer as tvl

    jx = jvl.data(name="x", type=jdt.dense_vector_sequence(3))
    tx = tvl.data(name="x", type=tdt.dense_vector_sequence(3))
    assert jnets.simple_gru(jx, 4, name="mine").name == "gru"  # dropped there
    assert tnets.simple_gru(tx, 4).name == "gru"
    fw = tnets.simple_gru(tx, 4, name="g_fw")
    bw = tnets.simple_gru(tx, 4, reverse=True, name="g_bw")
    net = tgraph.Network([fw, bw])
    batch = {"x": np.zeros((2, 5, 3), np.float32), "x.lengths": np.array([5, 2], np.int32)}
    assert {k for k in net.init(batch, device="cpu")} == {
        f"{n}.{p}" for n in ("g_fw", "g_bw") for p in ("w_hzr", "w_hc", "b")} | {
        f"{n}.input_proj.{p}" for n in ("g_fw", "g_bw") for p in ("w", "b")}


def _log_marks(records, logger):
    return [tuple(int(v) for v in re.match(r"pass (\d+) batch (\d+) cost=", r.getMessage()).groups())
            for r in records if r.name == logger and " cost=" in r.getMessage()]


def _fc_batches(n=7, b=4):
    rs = np.random.RandomState(5)
    return [{"x": rs.randn(b, 6).astype(np.float32), "label": rs.randint(0, 3, b)}
            for _ in range(n)]


def _fc_cost(L, C):
    x = L.Data("x", shape=(6,))
    lbl = L.Data("label", shape=())
    return C.ClassificationCost(L.Fc(x, 3, act=None, name="out"), lbl)


@pytest.mark.parametrize("log_period,k", [(2, 1), (3, 1), (2, 3), (1, 2)])
def test_log_period_marks_match_the_jax_trainer(log_period, k, caplog):
    import logging

    from paddle_tpu.nn import costs as JC
    from paddle_tpu.nn import graph as jgraph
    from paddle_tpu.nn import layers as JL
    from paddle_tpu.optim import SGD as JSGD
    from paddle_tpu.trainer.trainer import SGDTrainer as JaxTrainer
    from paddle_tpu_torch.optim import SGD as TSGD
    from paddle_tpu_torch.trainer import SGDTrainer as TorchTrainer

    batches = _fc_batches()
    jgraph.reset_name_scope()
    jt = JaxTrainer(_fc_cost(JL, JC), JSGD(learning_rate=0.1))
    tgraph.reset_name_scope()
    tt = TorchTrainer(_fc_cost(TL, TC), TSGD(learning_rate=0.1), device="cpu")
    with caplog.at_level(logging.INFO):
        jt.train(lambda: iter(batches), num_passes=2, log_period=log_period,
                 steps_per_dispatch=k)
        tt.train(lambda: iter(batches), num_passes=2, log_period=log_period,
                 steps_per_dispatch=k)
    want = _log_marks(caplog.records, "paddle_tpu.trainer")
    got = _log_marks(caplog.records, "paddle_tpu_torch.trainer")
    assert want and got == want


@pytest.mark.parametrize("log_period,reads", [(0, 1), (2, 1 + 3)])
def test_log_period_adds_no_host_read_per_batch(log_period, reads, monkeypatch):
    from paddle_tpu_torch.optim import SGD as TSGD
    from paddle_tpu_torch.trainer import SGDTrainer as TorchTrainer

    tgraph.reset_name_scope()
    tt = TorchTrainer(_fc_cost(TL, TC), TSGD(learning_rate=0.1), device="cpu")
    batches = _fc_batches(n=6)
    tt.init_state(batches[0])
    calls = []
    for name in ("__float__", "item", "tolist"):
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda self, *a, _real=real, **kw: calls.append(1) or _real(self, *a, **kw))
    tt.train(lambda: iter(batches), num_passes=1, log_period=log_period)
    assert len(calls) == reads


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_relu_gru_takes_the_step_loop_and_matches_cpu(cuda):
    batch = gru_batch()
    mods = dict(L=TL, C=TC, R=TR, P=tgraph.ParamAttr)
    tgraph.reset_name_scope()
    net = tgraph.Network([gru_cost(mods)])
    params = net.init(batch, device="cpu")
    before = (K.FWD_LAUNCHES, K.BWD_LAUNCHES)
    results = {}
    for dev in ("cpu", cuda):
        p = {k: v.to(dev).requires_grad_(True) for k, v in params.items()}
        c = net.apply(p, batch)["cost"].value
        names = sorted(p)
        grads = torch.autograd.grad(c, [p[k] for k in names])
        results[str(dev)] = (float(c.detach()), {k: g.cpu() for k, g in zip(names, grads)})
    torch.cuda.synchronize()
    assert (K.FWD_LAUNCHES, K.BWD_LAUNCHES) == before
    (c_cpu, g_cpu), (c_card, g_card) = results["cpu"], results[str(cuda)]
    assert abs(c_card - c_cpu) <= 1e-5 * abs(c_cpu)
    for k in g_cpu:
        torch.testing.assert_close(g_card[k], g_cpu[k], rtol=1e-4, atol=1e-5, msg=k)


@pytest.mark.cuda
def test_cuda_embedding_out_of_range_ids_read_nan(cuda):
    table = torch.arange(12, dtype=torch.float32, device=cuda).reshape(4, 3)
    got = TL.take_rows(table, torch.tensor([[-1, -5, 4, 2]], device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(got[0, 0], table[3]) and torch.equal(got[0, 3], table[2])
    assert torch.isnan(got[0, 1:3]).all()
