"""The port's deployment path — `capi/merge_model.py` (`merge_model`,
`merge_model_v1`), `capi/inference.py` (`create_for_inference`,
`InferenceMachine`), `trainer/v1_format.write_merged` / `read_merged` and
`python -m paddle_tpu_torch merge_model` — against the JAX package's, on
the CPU.

  * One pass directory of a v1 bi-GRU config (the JAX package's
    parameters, written by the port's `checkpoint.save_pass`) is merged by
    both packages: each merged .npz loads in the other package's
    `create_for_inference`, and every forward and `get_layer_output`
    agrees within 1e-5 relative; the two files hold the same arrays.
  * The port's `forward` equals its trainer's test forward on the same
    parameters within 1e-6 relative, from threads too.
  * `merge_model_v1` writes the JAX package's bytes, and `read_merged`
    gives the parameters back.
  * Twin of tests/test_config.py:124: `train` then `merge_model` through
    the port's CLI (in process, --device=cpu), then `create_for_inference`
    -> `get_layer_output("output")` beats chance.
  * On a card (marked `cuda`, skipped here): a merged bi-GRU model's
    forward and get_layer_output launch both GRU forwards and agree with
    the CPU.
jax is imported inside the tests only."""

import io
import os
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

from paddle_tpu_torch import capi, cli
from paddle_tpu_torch.trainer import checkpoint as tckpt
from paddle_tpu_torch.trainer import v1_format

BIGRU = """
from paddle.trainer_config_helpers import *
vocab = get_config_arg('vocab', int, 40)
size = get_config_arg('size', int, 8)
settings(batch_size=8, learning_rate=1e-3, learning_method=AdamOptimizer())
word = data_layer(name='word', size=vocab)
label = data_layer(name='label', size=2)
emb = embedding_layer(input=word, size=size)
bi = bidirectional_gru(input=emb, size=size)
out = fc_layer(input=bi, size=2, act=SoftmaxActivation(), name='output')
outputs(classification_cost(input=out, label=label))
"""


def _batch(b=8, t=6, seed=0):
    rs = np.random.RandomState(seed)
    return {"word": rs.randint(0, 40, (b, t)).astype(np.int32),
            "word.lengths": rs.randint(2, t + 1, b).astype(np.int32),
            "label": rs.randint(0, 2, b).astype(np.int32)}


@pytest.fixture(scope="module")
def merged(tmp_path_factory):
    """(config path, save_dir, JAX params, port .npz, JAX .npz)."""
    import jax

    from paddle_tpu.capi import merge_model as jmerge
    from paddle_tpu.config import parse_config as jparse

    d = tmp_path_factory.mktemp("merge")
    conf = d / "conf.py"
    conf.write_text(textwrap.dedent(BIGRU))
    jpc = jparse(str(conf), emit_proto=False)
    params, _ = jpc.topology.network.init(jax.random.PRNGKey(3), _batch())
    params = {k: np.asarray(v) for k, v in params.items()}
    save = d / "out"
    tckpt.save_pass(str(save), 0, {k: v * 0 for k, v in params.items()})
    tckpt.save_pass(str(save), 1, params)
    ours = capi.merge_model(str(conf), str(save), str(d / "port.npz"))
    theirs = jmerge(str(conf), str(save), str(d / "jax.npz"))
    return str(conf), str(save), params, ours, theirs


def test_merged_files_hold_the_same_arrays(merged):
    _, _, params, ours, theirs = merged
    with np.load(ours, allow_pickle=False) as a, np.load(theirs, allow_pickle=False) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for k, v in params.items():
            np.testing.assert_array_equal(a[f"param/{k}"], v)


@pytest.mark.parametrize("which", ["port_file", "jax_file"])
def test_merged_files_load_across_packages(merged, which):
    """Each package's merged file serves in both packages' machines."""
    from paddle_tpu.capi import create_for_inference as jcreate

    path = merged[3] if which == "port_file" else merged[4]
    batch = _batch(seed=1)
    ours = capi.create_for_inference(path, device="cpu")
    theirs = jcreate(path)
    got, want = ours.forward(batch), theirs.forward(batch)
    assert set(got) == set(want) == set(ours.output_names())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    np.testing.assert_allclose(ours.get_layer_output("output", batch),
                               theirs.get_layer_output("output", batch),
                               rtol=1e-5, atol=1e-7)


def test_forward_equals_the_trainers_test_forward(merged):
    from paddle_tpu_torch.config import parse_config
    from paddle_tpu_torch.optim import optimizers
    from paddle_tpu_torch.trainer.trainer import SGDTrainer

    conf, _, params, ours, _ = merged
    batch = _batch(seed=2)
    m = capi.create_for_inference(ours, device="cpu")
    (cost_name,) = m.output_names()
    got = m.forward(batch, output_layer=cost_name)
    tr = SGDTrainer(parse_config(conf).outputs, optimizers.Adam(1e-3), device="cpu")
    tr.init_state(batch)
    tr.load_params(params)
    with torch.no_grad():
        want = tr._cost(tr.state["params"], batch, train=False)[0]
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-6)

    results = {}

    def worker(i):
        results[i] = m.get_layer_output("output", _batch(seed=10 + i))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for i in range(3):
        np.testing.assert_array_equal(results[i],
                                      m.get_layer_output("output", _batch(seed=10 + i)))


def test_merge_model_v1_bytes_equal_and_read_back(merged, tmp_path):
    from paddle_tpu.capi.merge_model import merge_model_v1 as jmerge_v1

    conf, save, params, _, _ = merged
    ours = capi.merge_model_v1(conf, save, str(tmp_path / "port.bin"))
    theirs = jmerge_v1(conf, save, str(tmp_path / "jax.bin"))
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        data = a.read()
        assert data == b.read()
    config_bytes, back = v1_format.read_merged(io.BytesIO(data), params)
    assert config_bytes.startswith(b"model_config {")
    for k, v in params.items():
        np.testing.assert_array_equal(back[k], v)


PROVIDER = textwrap.dedent("""
    import numpy as np
    from paddle.trainer.PyDataProvider2 import *

    @provider(input_types={'pixel': dense_vector(64), 'label': integer_value(10)},
              should_shuffle=False)
    def process(settings, filename):
        rs = np.random.RandomState(7)
        for _ in range(96):
            y = rs.randint(10)
            x = rs.randn(64).astype('float32') * 0.1
            x[y] += 2.0
            yield {'pixel': x, 'label': int(y)}
    """)

MLP = textwrap.dedent("""
    from paddle.trainer_config_helpers import *
    hid = get_config_arg('hid', int, 32)
    settings(batch_size=32, learning_rate=0.3, learning_method=MomentumOptimizer(0.9))
    define_py_data_sources2(train_list='dummy', test_list='dummy',
                            module='capi_mlp_provider', obj='process')
    img = data_layer(name='pixel', size=64)
    lbl = data_layer(name='label', size=10)
    h = fc_layer(input=img, size=hid, act=TanhActivation())
    out = fc_layer(input=h, size=10, act=SoftmaxActivation(), name='output')
    cost = classification_cost(input=out, label=lbl)
    classification_error_evaluator(input=out, label=lbl, name='err')
    outputs(cost)
    """)


def test_cli_train_merge_infer(tmp_path, monkeypatch, capsys):
    """Twin of tests/test_config.py:124, the CLI run in process."""
    (tmp_path / "capi_mlp_provider.py").write_text(PROVIDER)
    (tmp_path / "the_conf.py").write_text(MLP)
    monkeypatch.chdir(tmp_path)
    monkeypatch.syspath_prepend(str(tmp_path))
    save_dir = tmp_path / "out"
    assert cli.main(["train", "--config=the_conf.py", "--num_passes=2",
                     f"--save_dir={save_dir}", "--log_period=2", "--device=cpu"]) == 0
    assert "ClassificationErrorEvaluator" in capsys.readouterr().out
    assert (save_dir / "pass-00001").is_dir()
    out = tmp_path / "merged.npz"
    assert cli.main(["merge_model", "--config=the_conf.py", f"--model_dir={save_dir}",
                     f"--output={out}"]) == 0
    assert capsys.readouterr().out.strip() == str(out)
    m = capi.create_for_inference(str(out), device="cpu")
    rs = np.random.RandomState(7)
    x = rs.randn(8, 64).astype(np.float32) * 0.1
    y = rs.randint(0, 10, 8)
    for i in range(8):
        x[i, y[i]] += 2.0
    probs = m.get_layer_output("output", {"pixel": x, "label": y.astype(np.int32)})
    assert probs.shape == (8, 10)
    # 2 passes of momentum SGD on a separable toy problem beat chance
    assert (probs.argmax(-1) == y).mean() > 0.2
    # a pass directory given itself merges that pass
    assert capi.merge_model("the_conf.py", str(save_dir / "pass-00000"),
                            str(tmp_path / "p0.npz")) == str(tmp_path / "p0.npz")


def test_no_device_means_cuda(merged):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        capi.create_for_inference(merged[3])


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_merged_model_serves_through_the_gru_kernels(cuda, tmp_path):
    """A merged bi-GRU model on the card: both GRU forwards launch on every
    forward and get_layer_output, and the outputs agree with the CPU's."""
    from paddle_tpu_torch.config import parse_config
    from paddle_tpu_torch.ops import rnn_kernels

    conf = tmp_path / "conf.py"
    conf.write_text(textwrap.dedent(BIGRU))
    params = parse_config(str(conf)).topology.network.init(_batch(), device="cpu")
    tckpt.save_pass(str(tmp_path / "out"), 0, {k: v.numpy() for k, v in params.items()})
    path = capi.merge_model(str(conf), str(tmp_path / "out"), str(tmp_path / "m.npz"))
    card, cpu = capi.create_for_inference(path), capi.create_for_inference(path, "cpu")
    batch = _batch(seed=4)
    f0 = rnn_kernels.FWD_LAUNCHES
    got = card.forward(batch)
    assert rnn_kernels.FWD_LAUNCHES - f0 == 2
    probs = card.get_layer_output("output", batch)
    assert rnn_kernels.FWD_LAUNCHES - f0 == 4
    for k, v in cpu.forward(batch).items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5)
    np.testing.assert_allclose(probs, cpu.get_layer_output("output", batch), rtol=1e-5,
                               atol=1e-6)
