"""The port's generation entry points beside `GenerationSession`
(`serving/server.py` `generate_config`, `cli.py` `serve --config`,
`api.SequenceGenerator`, `v2` `layer.beam_search` + `infer`), on the CPU.

  * `generate_config` over the wire on 127.0.0.1 returns the text the
    session writes for the same batch, twice; the JAX package's client
    gets the same from the port's server; a server with only a generation
    session refuses `submit` by name and still answers `stats`.
  * `python -m paddle_tpu_torch serve --config=... --model_dir=...` with
    neither `--demo` nor `--load` starts a generation-only server that
    answers `generate_config` with that text and exits 0 on SIGTERM.
  * `api.SequenceGenerator` `generate` / `generateText` equal the JAX
    package's on the JAX parameters (the twin of tests/test_v2_api.py:152).
  * The paddle.v2 book's machine translation network
    (`tests/test_torch_generation_configs.py` `v2_nmt`) generating through
    `layer.beam_search` + `GeneratedInput`: `infer(field="value")` gives
    the JAX package's ids from the JAX `Parameters` tar; `field="prob"` is
    refused by both.
  * On a card (marked `cuda`, skipped here): the v2 network trains 2 steps
    and generates with `infer` on the card and on the CPU from one
    parameter tar: costs within 1e-5 relative, ids identical, 2 GRU
    forward launches a chunk.
jax is imported inside the tests only."""

import io
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch.v2 as tpaddle
from paddle_tpu_torch.core import init_ctx
from paddle_tpu_torch.nn import graph as tgraph
from test_torch_generation_configs import (
    demo_args,
    nmt_samples,
    source_batch,
    v2_nmt,
    write_demo,
)

pytestmark = pytest.mark.timeout(120)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, WIDTH = 40, 16


@pytest.fixture(autouse=True)
def _fresh():
    saved = init_ctx.flags().__dict__.copy()
    tgraph.reset_name_scope()
    yield
    init_ctx.flags().__dict__.update(saved)


@pytest.fixture(scope="module")
def gen_model(tmp_path_factory):
    """The demo's generating config at vocab 64, width 16 with parameters
    the port drew and saved as a pass (sharpened, EOS likelier, so that
    lengths vary), and the text its session writes for a batch of 4."""
    from paddle_tpu_torch.config import parse_config
    from paddle_tpu_torch.trainer.checkpoint import save_pass
    from paddle_tpu_torch.trainer.generation import GenerationSession

    d = str(tmp_path_factory.mktemp("gen"))
    path = write_demo(d, 64)
    args = demo_args()
    batch = source_batch()
    tgraph.reset_name_scope()
    pc = parse_config(path, args, emit_proto=False)
    params = {k: 4 * v.numpy() for k, v in
              tgraph.Network(pc.outputs).init(batch, device="cpu").items()}
    (out_bias,) = [k for k, v in params.items() if v.shape == (64,)]
    params[out_bias][1] += 2.5
    save_pass(os.path.join(d, "model"), 1, params)
    model_dir = os.path.join(d, "model", "pass-00001")
    sess = GenerationSession(pc, model_dir=model_dir, base_dir=d, device="cpu")
    dest = os.path.join(d, "want.txt")
    sess.generate(batch, result_file=dest)
    with open(dest) as f:
        text = f.read()
    return dict(dir=d, path=path, args=args, batch=batch, model_dir=model_dir, pc=pc,
                text=text)


def _session(gen_model):
    from paddle_tpu_torch.config import parse_config
    from paddle_tpu_torch.trainer.generation import GenerationSession

    tgraph.reset_name_scope()
    pc = parse_config(gen_model["path"], gen_model["args"], emit_proto=False)
    return GenerationSession(pc, model_dir=gen_model["model_dir"], base_dir=gen_model["dir"],
                             device="cpu")


# -- generate_config and serve --config ------------------------------------------------


def test_generate_config_over_the_wire_returns_the_session_text(gen_model):
    from paddle_tpu.runtime.master import MasterClient as JaxClient

    from paddle_tpu_torch.serving import Rejected, ServingClient, ServingServer

    want = gen_model["text"]
    assert len(want.splitlines()) == 4
    srv = ServingServer(gen_session=_session(gen_model), port=0).start()
    try:
        c = ServingClient(srv.address)
        for _ in range(2):
            assert c.generate_config(gen_model["batch"]) == {
                "seq_text_printer_evaluator": want}
        # the JAX package's transport, the same request and reply
        jc = JaxClient(srv.address)
        resp = jc.call("generate_config", batch={
            k: v.tolist() for k, v in gen_model["batch"].items()})
        assert resp == {"files": {"seq_text_printer_evaluator": want}}
        jc.close()
        assert "live_tenants" in c.stats()
        with pytest.raises(Rejected, match="no token engine"):
            c.generate([1, 2, 3], max_new_tokens=2)
        c.close()
    finally:
        srv.stop()


def test_serve_config_starts_a_generation_only_server(gen_model):
    from paddle_tpu_torch.serving import ServingClient

    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "serve", f"--config={gen_model['path']}",
         f"--model_dir={gen_model['model_dir']}", f"--config_args={gen_model['args']}",
         "--device", "cpu", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
    try:
        line = json.loads(proc.stdout.readline())
        assert line["role"] == "serve"
        c = ServingClient(tuple(line["address"]), timeout=60.0)
        got = c.generate_config(gen_model["batch"])
        c.close()
        assert got == {"seq_text_printer_evaluator": gen_model["text"]}
    finally:
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=30)
    assert proc.returncode == 0, err
    assert "final_stats" not in out  # no token engine to report on


def test_serve_without_any_model_exits_2():
    from paddle_tpu_torch import cli

    assert cli.main(["serve", "--device", "cpu"]) == 2


# -- api.SequenceGenerator --------------------------------------------------------------


def _gen_graph(vl, dt):
    """tests/test_v2_api.py:186-199's generation graph."""
    enc = vl.data(name="enc", type=dt.dense_vector_sequence(4))
    boot = vl.last_seq(input=enc)

    def step(enc_s, cur):
        mem = vl.memory(name="m", size=4, boot_layer=boot)
        h = vl.fc(input=[cur, mem], size=4, act="tanh", name="m")
        return vl.fc(input=h, size=6, act="softmax", name="probs")

    return vl.beam_search(step, input=[
        vl.StaticInput(enc, is_seq=True),
        vl.GeneratedInput(size=6, embedding_name="emb", embedding_size=4)],
        bos_id=0, eos_id=1, beam_size=2, max_length=5)


def test_sequence_generator_matches_jax():
    from paddle_tpu.api import GradientMachine as JGradientMachine
    from paddle_tpu.api import SequenceGenerator as JSequenceGenerator
    from paddle_tpu.nn.graph import reset_name_scope
    from paddle_tpu.v2 import data_type as jdt
    from paddle_tpu.v2 import layer as jvl

    from paddle_tpu_torch import api
    from paddle_tpu_torch.v2 import data_type as tdt
    from paddle_tpu_torch.v2 import layer as tvl

    rs = np.random.RandomState(0)
    batch = {"enc": rs.randn(5, 3, 4).astype(np.float32),
             "enc.lengths": np.asarray([3, 2, 1, 3, 2], np.int32)}
    words = [f"w{i}" for i in range(6)]
    reset_name_scope()
    jgen = _gen_graph(jvl, jdt)
    jgm = JGradientMachine([jgen])
    jsg = JSequenceGenerator(jgm, jgen, dict_file=words)
    jgm.initParams(batch)
    jgm.setParameters({k: 3 * np.asarray(v) for k, v in jgm.getParameters().items()})
    want, want_text = jsg.generate(batch), jsg.generateText(batch)

    tgen = _gen_graph(tvl, tdt)
    gm = api.GradientMachine([tgen], device="cpu")
    gm.setParameters(jgm.getParameters())
    sg = api.SequenceGenerator(gm, tgen, dict_file=words)
    assert sg.generate(batch) == want
    assert sg.generateText(batch) == want_text
    assert len(want) == 5 and all(1 <= len(s) <= 5 for s in want)
    assert len({len(s) for s in want}) > 1  # some end on EOS, some run to 5


# -- paddle.v2: layer.beam_search and infer ----------------------------------------------


def _jax_nmt(is_generating, **kw):
    import paddle_tpu.v2 as jpaddle
    from paddle_tpu.config.v1_layers import gru_step_layer
    from paddle_tpu.nn.graph import reset_name_scope
    from paddle_tpu.nn.recurrent import simple_gru

    reset_name_scope()
    jpaddle.init(use_gpu=False, trainer_count=1)
    return jpaddle, v2_nmt(jpaddle, VOCAB, WIDTH, is_generating, simple_gru=simple_gru,
                           gru_step=gru_step_layer, **kw)


def test_v2_beam_search_infer_matches_jax():
    """The generating topology's parameters are the training one's (the
    target table by name); infer(field="value") -> the best beam's ids
    [N, max_length] of the JAX package, chunk by chunk."""
    jpaddle, jcost = _jax_nmt(False)
    jparams = jpaddle.parameters.create(jcost)
    for k in jparams.names():
        jparams.set(k, 3 * jparams.get(k))
    tar = io.BytesIO()
    jparams.to_tar(tar)
    jpaddle, jgen = _jax_nmt(True, max_length=6)
    samples = [(src,) for src, _, _ in nmt_samples(11, VOCAB, 2)]
    want = np.asarray(jpaddle.infer(output_layer=jgen, parameters=jparams, input=samples,
                                    feeding={"source_language_word": 0}, field="value",
                                    batch_size=4))
    with pytest.raises(ValueError, match="unsupported infer field"):
        jpaddle.infer(output_layer=jgen, parameters=jparams, input=samples[:2],
                      feeding={"source_language_word": 0}, field="prob")

    tgraph.reset_name_scope()
    tpaddle.init(use_gpu=False)
    tgen = v2_nmt(tpaddle, VOCAB, WIDTH, True, max_length=6)
    params = tpaddle.parameters.Parameters.from_tar(io.BytesIO(tar.getvalue()))
    got = tpaddle.infer(output_layer=tgen, parameters=params, input=samples,
                        feeding={"source_language_word": 0}, field="value", batch_size=4)
    assert got.shape == (11, 6) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unsupported infer field"):
        tpaddle.infer(output_layer=tgen, parameters=params, input=samples[:2],
                      feeding={"source_language_word": 0}, field="prob")


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_v2_nmt_trains_and_generates_like_the_cpu(cuda):
    from paddle_tpu_torch.ops import rnn_kernels

    samples = nmt_samples(16, VOCAB, 0)
    feeding = {"source_language_word": 0, "target_language_word": 1,
               "target_language_next_word": 2}
    tar, out = None, {}
    for dev in ("cpu", "cuda"):
        tgraph.reset_name_scope()
        tpaddle.init(use_gpu=dev == "cuda", seed=0)
        cost = v2_nmt(tpaddle, VOCAB, WIDTH, False)
        params = (tpaddle.parameters.create(cost) if tar is None else
                  tpaddle.parameters.Parameters.from_tar(io.BytesIO(tar)))
        if tar is None:
            buf = io.BytesIO()
            params.to_tar(buf)
            tar = buf.getvalue()
        tr = tpaddle.trainer.SGD(cost=cost, parameters=params,
                                 update_equation=tpaddle.optimizer.Adam(learning_rate=1e-3))
        costs = []
        tr.train(reader=tpaddle.batch(lambda: iter(samples), 8), num_passes=1,
                 event_handler=lambda e: costs.append(e.cost)
                 if isinstance(e, tpaddle.event.EndIteration) else None, feeding=feeding)
        tgraph.reset_name_scope()
        gen = v2_nmt(tpaddle, VOCAB, WIDTH, True, max_length=10)
        before = rnn_kernels.FWD_LAUNCHES
        ids = tpaddle.infer(output_layer=gen, parameters=tr.parameters,
                            input=[(s,) for s, _, _ in samples],
                            feeding={"source_language_word": 0}, field="value", batch_size=8)
        out[dev] = (costs, ids, rnn_kernels.FWD_LAUNCHES - before)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
    # the Inference's init forward, then one forward a chunk of 8: both
    # encoders each time
    assert out["cuda"][2] == 2 * 3
