"""The port's generation over a recurrent group (`nn/beam_core.py`,
`nn/recurrent_group.py` `GeneratedInput` / `BeamSearchLayer` /
`beam_search`, `trainer/generation.py`) against the JAX package's, on the
CPU.

  * `beam_search_scan` with a carry of two tensors (a dict) on fixed toy
    log-probs with ties, EOS and a carry that changes the scores: history,
    scores and lengths equal the JAX engine's.
  * The seqToseq demo's generating config (`tests/test_torch_generation_configs.py`:
    demo/seqToseq/seqToseq_net.py with is_generating=1) at vocab 64, width
    16, batch 4, beam 3, max_length 8, `num_results_per_sample=3`, on the
    parameters of the TRAINING config (is_generating=0) initialised and
    saved by the JAX package: the generating network loads that dict by
    name in both packages; every beam's ids and lengths are identical,
    the scores within 1e-5 relative; the `dump_config` text is equal; the
    port's `GenerationSession` on the JAX pass directory writes the JAX
    session's result file byte for byte.
  * Nested generation (an outer group over a SubsequenceInput whose step
    beam-searches): ids, lengths and `sub_lengths` equal the JAX package's.
  * `GenerationSession` builds and loads once over two calls, fans out one
    file a printer when a config has two, and with `device=None` raises
    without a card.
  * On a card (marked `cuda`, skipped here): the demo's generating config
    at vocab 64, width 16, batch 8, beam 3, max_length 12 on one parameter
    dict, card against CPU: ids identical, scores within 1e-5 relative.
jax is imported inside the tests only."""

import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch.nn import graph as tgraph
from paddle_tpu_torch.nn.convert import params_from_jax
from test_torch_generation_configs import demo_args, source_batch, write_demo

SCORE_RTOL = 1e-5
CPU = torch.device("cpu")


def _train_batch(b=4, vocab=64, seed=1):
    rs = np.random.RandomState(seed)
    tl = np.asarray([4, 6, 2, 5][:b], np.int32)
    src = source_batch(b, vocab, seed)
    del src["sent_id"]
    return {**src,
            "target_language_word": rs.randint(2, vocab, (b, 6)).astype(np.int32),
            "target_language_word.lengths": tl,
            "target_language_next_word": rs.randint(2, vocab, (b, 6)).astype(np.int32),
            "target_language_next_word.lengths": tl}


def _port_generate(pc, params, batch):
    """The port's forward of a parsed generating config on the CPU ->
    (values, the run's cache)."""
    net = tgraph.Network(pc.outputs)
    ctx = tgraph.Context("apply", params, device=CPU, states={}, train=False)
    with torch.no_grad():
        values = net._run(ctx, batch, CPU)
    return values, ctx.cache


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    """The JAX side, once: the training config's parameters saved by the
    JAX package's save_pass, the generating config (num_results 3) parsed,
    its session's result file on that pass and its beams."""
    import jax
    from paddle_tpu.config import parse_config as jparse
    from paddle_tpu.nn.graph import Context as JContext
    from paddle_tpu.nn.graph import Network as JNetwork
    from paddle_tpu.trainer.checkpoint import save_pass as jsave
    from paddle_tpu.trainer.generation import GenerationSession as JSession

    d = str(tmp_path_factory.mktemp("demo"))
    path = write_demo(d, 64)
    train_pc = jparse(path, demo_args(is_generating=False), emit_proto=False)
    train_params = JNetwork(train_pc.outputs).init(jax.random.PRNGKey(0), _train_batch())[0]
    # sharper distributions than the init's and EOS likelier, so that some
    # beams end early and others run to max_length
    train_params = {k: 4 * np.asarray(v) for k, v in train_params.items()}
    (out_bias,) = [k for k, v in train_params.items() if v.shape == (64,)]
    train_params[out_bias] = train_params[out_bias] + np.eye(64, dtype=np.float32)[1] * 2.5
    jsave(os.path.join(d, "model"), 0, train_params)
    pass_dir = os.path.join(d, "model", "pass-00000")
    batch = source_batch()
    texts = {}
    for n in (1, 3):
        pc = jparse(path, demo_args(num_results=n), emit_proto=n == 3)
        sess = JSession(pc, model_dir=pass_dir, base_dir=d)
        result = os.path.join(d, f"jax_result_{n}.txt")
        sess.generate(batch, result_file=result)
        with open(result) as f:
            texts[n] = f.read()
    ctx = JContext("apply", sess._params, sess._states, None, False)
    values = sess.net._run(ctx, batch)
    name = pc.outputs[0].name
    beam = {k: np.asarray(v) if hasattr(v, "shape") else v
            for k, v in ctx.cache[("beam", name)].items()}
    return dict(dir=d, path=path, pass_dir=pass_dir, pc=pc, batch=batch, name=name,
                train_params=train_params, ids=np.asarray(values[name].value),
                lengths=np.asarray(values[name].lengths), beam=beam, texts=texts)


# -- the engine ----------------------------------------------------------------


def test_beam_search_scan_two_tensor_carry_matches_jax():
    """Twin of tests/test_recurrent_group.py:177 with a dict carry of two
    tensors: `h` (float, [B*K, 2]) and `n` (int, [B*K]); the step's scores
    read `n`, so a carry gathered from the wrong beam changes the ids.
    Integer-valued log-probs make ties, and EOS (3) ties the best token."""
    import jax.numpy as jnp

    from paddle_tpu.nn import beam_core as jbc
    from paddle_tpu_torch.nn import beam_core as tbc

    b, k, v, steps = 2, 3, 5, 6
    rs = np.random.RandomState(0)
    table = -rs.randint(0, 3, (steps, v, v)).astype(np.float32)
    table[:, :, 3] = table.max(-1)  # EOS as good as the best candidate
    h0 = np.arange(b * k * 2, dtype=np.float32).reshape(b * k, 2)
    n0 = np.arange(b * k, dtype=np.int32)

    def jstep(tok, c, t):
        logp = jnp.asarray(table)[t][tok] - (c["n"] % 2)[:, None].astype(jnp.float32)
        return logp, {"h": c["h"] * 2 + tok[:, None], "n": c["n"] + tok * (t + 1)}

    want = jbc.beam_search_scan(jstep, {"h": jnp.asarray(h0), "n": jnp.asarray(n0)},
                                b, v, 0, 3, k, steps)

    def tstep(tok, c, t):
        logp = torch.from_numpy(table)[t][tok.long()] - (c["n"] % 2)[:, None].float()
        return logp, {"h": c["h"] * 2 + tok[:, None], "n": c["n"] + tok * (t + 1)}

    got = tbc.beam_search_scan(tstep, {"h": torch.from_numpy(h0), "n": torch.from_numpy(n0)},
                               b, v, 0, 3, k, steps)
    np.testing.assert_array_equal(got.history.numpy(), np.asarray(want.history))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=SCORE_RTOL)
    assert (got.lengths.numpy() < steps).any()  # some beam ended on EOS


# -- the seqToseq demo's generating config -------------------------------------------


def test_demo_generation_matches_jax(demo):
    """Every beam's ids and lengths identical, scores within 1e-5 relative,
    on the training config's JAX parameters loaded by name; the best beam
    is the layer's output."""
    from paddle_tpu_torch.config import parse_config as tparse

    tgraph.reset_name_scope()
    pc = tparse(demo["path"], demo_args(num_results=3), emit_proto=False)
    assert [l.name for l in pc.outputs] == [demo["name"]] == ["decoder_group"]
    values, cache = _port_generate(pc, params_from_jax(demo["train_params"], "cpu"),
                                   demo["batch"])
    out = values[demo["name"]]
    beam = cache[("beam", demo["name"])]
    np.testing.assert_array_equal(out.value.numpy(), demo["ids"])
    np.testing.assert_array_equal(out.lengths.numpy(), demo["lengths"])
    np.testing.assert_array_equal(beam["history"].numpy(), demo["beam"]["history"])
    np.testing.assert_array_equal(beam["lengths"].numpy(), demo["beam"]["lengths"])
    np.testing.assert_allclose(beam["scores"].numpy(), demo["beam"]["scores"],
                               rtol=SCORE_RTOL)
    assert beam["num_results"] == demo["beam"]["num_results"] == 3
    scores = beam["scores"].numpy()
    assert (np.diff(scores, axis=1) <= 0).all()  # best first
    lens = beam["lengths"].numpy()
    assert ((lens >= 1) & (lens <= 8)).all() and (lens < 8).any() and (lens == 8).any()


def test_demo_generating_config_loads_the_training_dict_by_name(demo):
    """Every parameter the generating network creates is one of the
    training network's, of the same shape, in both packages (the target
    table through `GeneratedInput(embedding_name=...)`)."""
    import jax
    from paddle_tpu.config import parse_config as jparse
    from paddle_tpu.nn.graph import Network as JNetwork

    from paddle_tpu_torch.config import parse_config as tparse

    tgraph.reset_name_scope()
    tpc = tparse(demo["path"], demo_args(), emit_proto=False)
    tparams = tgraph.Network(tpc.outputs).init(demo["batch"], device="cpu")
    jpc = jparse(demo["path"], demo_args(), emit_proto=False)
    jparams = JNetwork(jpc.outputs).init(jax.random.PRNGKey(0), demo["batch"])[0]
    train = demo["train_params"]
    assert set(tparams) == set(jparams) and set(tparams) <= set(train)
    assert "_target_language_embedding" in tparams
    for k, v in tparams.items():
        assert tuple(v.shape) == tuple(np.shape(jparams[k])) == train[k].shape, k


def test_demo_generating_config_dump_matches_jax(demo):
    from paddle_tpu import proto as jproto

    from paddle_tpu_torch import proto as tproto
    from paddle_tpu_torch.config import parse_config as tparse

    tgraph.reset_name_scope()
    pc = tparse(demo["path"], demo_args(num_results=3))
    text = tproto.to_text(pc.trainer_config)
    assert text == jproto.to_text(demo["pc"].trainer_config)
    for want in ('type: "beam_search"', 'name: "decoder_group"',
                 '"_target_language_embedding"', 'type: "seq_text_printer"'):
        assert want in text, want


def _beam_blocks(text):
    """A beam-mode result file -> (its lines with the score column cut,
    the scores)."""
    lines, scores = [], []
    for line in text.split("\n"):
        parts = line.split("\t")
        if len(parts) == 3:
            scores.append(float(parts[1]))
            parts[1] = "<score>"
        lines.append("\t".join(parts))
    return lines, np.asarray(scores)


@pytest.mark.parametrize("num_results", [1, 3])
def test_generation_session_on_a_jax_pass_writes_the_jax_result_file(demo, tmp_path,
                                                                      num_results):
    """The JAX package's session and the port's on the JAX pass directory
    write the same file: one line a sample (its sent_id and the best beam's
    words) byte for byte; with num_results_per_sample=3, each sample's
    block of rank, score and words, the scores (printed to 6 significant
    digits, as the reference's ostream does) within 2e-5 relative and
    everything else byte for byte."""
    from paddle_tpu_torch.config import parse_config as tparse
    from paddle_tpu_torch.trainer.generation import GenerationSession

    tgraph.reset_name_scope()
    pc = tparse(demo["path"], demo_args(num_results=num_results), emit_proto=False)
    sess = GenerationSession(pc, model_dir=demo["pass_dir"], base_dir=demo["dir"],
                             device="cpu")
    dest = str(tmp_path / "port_result.txt")
    assert sess.generate(demo["batch"], result_file=dest) == {
        "seq_text_printer_evaluator": dest}
    with open(dest) as f:
        text = f.read()
    want = demo["texts"][num_results]
    if num_results == 1:
        assert text == want
        assert text.startswith("0\t ") and len(text.splitlines()) == 4
        return
    got_lines, got_scores = _beam_blocks(text)
    want_lines, want_scores = _beam_blocks(want)
    assert got_lines == want_lines and len(got_scores) == 12
    np.testing.assert_allclose(got_scores, want_scores, rtol=2e-5)
    assert text.startswith("0\n0\t-") and "\t w" in text


def test_generation_session_builds_and_loads_once(demo, tmp_path, monkeypatch):
    """Mirrors tests/test_serving.py:340: the second generate neither
    re-initialises nor reloads, and writes the same text."""
    from paddle_tpu_torch.config import parse_config as tparse
    from paddle_tpu_torch.trainer import checkpoint
    from paddle_tpu_torch.trainer.generation import GenerationSession

    calls = {"init": 0, "load": 0}
    real_init, real_load = tgraph.Network.init, checkpoint.load_pass

    def init(self, *a, **kw):
        calls["init"] += 1
        return real_init(self, *a, **kw)

    def load(*a, **kw):
        calls["load"] += 1
        return real_load(*a, **kw)

    monkeypatch.setattr(tgraph.Network, "init", init)
    monkeypatch.setattr(checkpoint, "load_pass", load)
    tgraph.reset_name_scope()
    pc = tparse(demo["path"], demo_args(), emit_proto=False)
    sess = GenerationSession(pc, model_dir=demo["pass_dir"], base_dir=demo["dir"],
                             device="cpu")
    assert not sess.built
    texts = []
    for i in range(2):
        dest = str(tmp_path / f"r{i}.txt")
        sess.generate(demo["batch"], result_file=dest)
        with open(dest) as f:
            texts.append(f.read())
        assert sess.built and calls == {"init": 1, "load": 1}
    # one line a sample: "<sent_id>\t <words>", the best beam's words
    words = ["<s>", "<e>", "<unk>"] + [f"w{i}" for i in range(3, 64)]
    want = "".join(f"{i}\t " + " ".join(words[t] for t in demo["beam"]["history"][i, 0, :n])
                   + "\n" for i, n in enumerate(demo["beam"]["lengths"][:, 0]))
    assert texts[0] == texts[1] == want


def test_generation_session_fans_out_per_printer(demo, tmp_path):
    from paddle_tpu_torch.config import parse_config as tparse
    from paddle_tpu_torch.trainer.generation import GenerationSession

    with open(demo["path"]) as f:
        text = f.read()
    two = text.replace('    Outputs("__beam_search_predict__")',
                       '    seqtext_printer_evaluator(input=beam_gen, result_file="b.txt", '
                       'dict_file="trg.dict", name="second")\n'
                       '    Outputs("__beam_search_predict__")')
    path = tmp_path / "two.py"
    path.write_text(two)
    (tmp_path / "trg.dict").write_text(open(os.path.join(demo["dir"], "trg.dict")).read())
    tgraph.reset_name_scope()
    pc = tparse(str(path), demo_args(), emit_proto=False)
    sess = GenerationSession(pc, model_dir=demo["pass_dir"], base_dir=str(tmp_path),
                             device="cpu")
    dest = str(tmp_path / "out.txt")
    written = sess.generate(demo["batch"], result_file=dest)
    assert written == {"seq_text_printer_evaluator": str(tmp_path / "out.seq_text_printer_evaluator.txt"),
                       "second": str(tmp_path / "out.second.txt")}
    one, other = (open(p).read() for p in written.values())
    # the first printer numbers samples by sent_id, the second by position:
    # the same here
    assert one == other and len(one.splitlines()) == 4


def test_generation_session_without_a_card_raises(demo):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None is the card")
    from paddle_tpu_torch.config import parse_config as tparse
    from paddle_tpu_torch.trainer.generation import GenerationSession, run_generation

    tgraph.reset_name_scope()
    pc = tparse(demo["path"], demo_args(), emit_proto=False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        GenerationSession(pc, model_dir=demo["pass_dir"])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        run_generation(pc, demo["batch"], model_dir=demo["pass_dir"])


# -- nested generation ------------------------------------------------------------


def _nested(vl, dt):
    """An outer group over subsequences whose step beam-searches a sequence
    from each (the sample_trainer_nest_rnn_gen idiom)."""
    x = vl.data(name="x", type=dt.dense_vector_sequence(4))

    def outer_step(xs):
        def gen_step(enc, word):
            mem = vl.memory(name="gen_h", size=8)
            h = vl.fc(input=[vl.pool(input=enc), word, mem], size=8, act="tanh",
                      name="gen_h")
            return vl.fc(input=h, size=12, act="softmax", name="gen_prob")

        return vl.beam_search(gen_step, input=[
            vl.StaticInput(xs, is_seq=True),
            vl.GeneratedInput(size=12, embedding_name="gen_emb", embedding_size=6)],
            bos_id=0, eos_id=1, beam_size=3, max_length=5, name="gen")

    return vl.recurrent_group(outer_step, vl.SubsequenceInput(x), name="outer_gen")


def test_nested_generation_matches_jax():
    import jax
    from paddle_tpu.nn import graph as jgraph
    from paddle_tpu.v2 import data_type as jdt
    from paddle_tpu.v2 import layer as jvl

    from paddle_tpu_torch.v2 import data_type as tdt
    from paddle_tpu_torch.v2 import layer as tvl

    rs = np.random.RandomState(3)
    batch = {"x": rs.randn(3, 3, 4, 4).astype(np.float32),
             "x.lengths": np.asarray([3, 2, 1], np.int32),
             "x.sub_lengths": np.asarray([[4, 2, 3], [3, 4, 1], [2, 1, 1]], np.int32)}
    jgraph.reset_name_scope()
    jout = _nested(jvl, jdt)
    jnet = jgraph.Network([jout])
    params, states = jnet.init(jax.random.PRNGKey(0), batch)
    params = {k: v * 4 for k, v in params.items()}  # sharper distributions: EOS shows
    want = jnet.apply(params, states, batch)[0][jout.name]

    tgraph.reset_name_scope()
    tout = _nested(tvl, tdt)
    got = tgraph.Network([tout]).apply(params_from_jax(params, "cpu"), batch)[tout.name]
    assert got.value.shape == (3, 3, 5)
    np.testing.assert_array_equal(got.value.numpy(), np.asarray(want.value))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_array_equal(got.sub_lengths.numpy(), np.asarray(want.sub_lengths))
    assert got.sub_lengths.numpy().min() >= 1 and got.sub_lengths.numpy().max() <= 5


def test_recurrent_group_rejects_a_generated_input():
    from paddle_tpu_torch.v2 import data_type as tdt
    from paddle_tpu_torch.v2 import layer as tvl

    tgraph.reset_name_scope()
    x = tvl.data(name="x", type=tdt.dense_vector_sequence(4))
    with pytest.raises(ValueError, match="only valid under beam_search"):
        tvl.recurrent_group(lambda a, w: tvl.fc(input=[a, w], size=4), [
            x, tvl.GeneratedInput(size=5, embedding_name="e", embedding_size=3)])


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_demo_generation_matches_cpu(cuda, tmp_path):
    """The demo's generating config at vocab 64, width 16, batch 8, beam 3,
    max_length 12 on one parameter dict, card against CPU: every beam's
    ids and lengths identical, scores within 1e-5 relative; no recurrent
    kernel launches (the groups run none)."""
    from paddle_tpu_torch.config import parse_config as tparse
    from paddle_tpu_torch.ops import rnn_kernels

    path = write_demo(str(tmp_path), 64)
    args = demo_args(max_length=12)
    batch = source_batch(8, 64, 4, lengths=(5, 3, 6, 2, 7, 1, 4, 6))
    out = {}
    params = None
    for dev in ("cpu", "cuda"):
        tgraph.reset_name_scope()
        pc = tparse(path, args, emit_proto=False)
        net = tgraph.Network(pc.outputs)
        if params is None:
            params = {k: v * 3 for k, v in net.init(batch, device="cpu").items()}
        ctx = tgraph.Context("apply", {k: v.to(dev) for k, v in params.items()},
                             device=torch.device(dev), states={}, train=False)
        before = (rnn_kernels.FWD_LAUNCHES, rnn_kernels.BWD_LAUNCHES)
        with torch.no_grad():
            net._run(ctx, batch, torch.device(dev))
        assert (rnn_kernels.FWD_LAUNCHES, rnn_kernels.BWD_LAUNCHES) == before
        out[dev] = {k: v.cpu().numpy() for k, v in ctx.cache[("beam", "decoder_group")].items()
                    if isinstance(v, torch.Tensor)}
    np.testing.assert_array_equal(out["cuda"]["history"], out["cpu"]["history"])
    np.testing.assert_array_equal(out["cuda"]["lengths"], out["cpu"]["lengths"])
    np.testing.assert_allclose(out["cuda"]["scores"], out["cpu"]["scores"], rtol=SCORE_RTOL)
