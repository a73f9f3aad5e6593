"""The port's text tools against the JAX package's: `config/protostr.py`,
`utils/show_pb.py`, `utils/make_model_diagram.py` and CLI `version`.

The reference's golden protostr files are not in this repository
(tests/test_protostr.py skips), so `protostr` is held on the two packages'
own `dump_config` texts of six configs of tests/test_torch_config.py:
`parse_text_proto`, `summarize` and `diff` give equal results in both
packages, on the port's text, on the JAX package's and on a text with
injected discrepancies; the port's dump adds no diff line to what the
JAX package's dump gets against itself. `show_merged_model` and `to_dot`
print the same text for the same input, and `version` the same line."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from paddle_tpu_torch import cli as tcli
from paddle_tpu_torch import proto as tproto
from paddle_tpu_torch.config import parse_config as tparse
from paddle_tpu_torch.config import protostr as tps
from paddle_tpu_torch.utils import make_diagram, show_merged_model, to_dot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DUMP_CASES = ("bigru", "lenet", "text_conv_pool", "lstm_text", "seq_layers",
              "image_helpers")


def _dumps(case, tmp_path):
    """(port text, JAX text) of `dump_config` for a test_torch_config case."""
    from test_torch_config import CASES, write_config

    from paddle_tpu import proto as jproto
    from paddle_tpu.config import parse_config as jparse

    src, args = CASES[case]
    path = write_config(tmp_path, src())
    return (tproto.to_text(tparse(path, args).trainer_config),
            jproto.to_text(jparse(path, args).trainer_config))


def _perturbed(text):
    """The text with a layer size changed, an active_type changed and a
    parameter's dims cut: diff has something to say."""
    out = text.replace("size: 2\n", "size: 3\n", 1)
    out = out.replace('active_type: "softmax"', 'active_type: "relu"', 1)
    return out.replace("dims: ", "dims: 1", 1)


@pytest.mark.parametrize("case", DUMP_CASES)
def test_protostr_matches_jax(case, tmp_path):
    from paddle_tpu.config import protostr as jps

    port_text, jax_text = _dumps(case, tmp_path)
    for text in (port_text, jax_text, _perturbed(jax_text)):
        assert tps.parse_text_proto(text) == jps.parse_text_proto(text)
        assert (dataclasses.asdict(tps.summarize(tps.parse_text_proto(text)))
                == dataclasses.asdict(jps.summarize(jps.parse_text_proto(text))))
    ref_t, ours_t = (tps.summarize(tps.parse_text_proto(t)) for t in (jax_text, port_text))
    ref_j, ours_j = (jps.summarize(jps.parse_text_proto(t)) for t in (jax_text, port_text))
    # `diff` reads its first argument in the reference's parameter naming,
    # so a dump against itself lists those names; the port's dump adds no
    # line to what the JAX package's dump gets against itself
    assert tps.diff(ref_t, ours_t) == jps.diff(ref_j, ours_j) == jps.diff(ref_j, ref_j)
    bad_t = tps.summarize(tps.parse_text_proto(_perturbed(port_text)))
    bad_j = jps.summarize(jps.parse_text_proto(_perturbed(port_text)))
    assert tps.diff(ref_t, bad_t) == jps.diff(ref_j, bad_j)
    assert tps.diff(ref_t, bad_t), "the perturbed text must differ"
    golden = tmp_path / "golden.protostr"
    golden.write_text(jax_text)
    assert (tps.diff_files(str(golden), _perturbed(port_text))
            == jps.diff_files(str(golden), _perturbed(port_text)))


def test_protostr_parser_and_param_names_match_jax():
    from paddle_tpu.config import protostr as jps

    text = ('type: "nn"\nlayers {\n  name: "a"\n  size: 3\n  dims: 1\n  dims: 2\n'
            '  sub {\n    f: true\n    g: -1.5\n    s: "x\\ty"\n  }\n}\n')
    assert tps.parse_text_proto(text) == jps.parse_text_proto(text)
    for bad in ("layers {", "}"):
        with pytest.raises((ValueError, IndexError)):
            tps.parse_text_proto(bad)
    names = ["___fc_layer_0__.w0", "___fc_layer_0__.wbias", "_a.w1", "shared_param",
             "_g@grp.w0", "__fc_layer_0__.w", "__batch_norm_0__.scale", "x.w.1",
             "m.proj2.w", "m.proj0.b", "g.w_hzr", "g.w_hc", "l.w_hh", "bn.bias"]
    for n in names:
        assert tps.normalize_ref_param(n) == jps.normalize_ref_param(n)
        assert tps.normalize_our_param(n) == jps.normalize_our_param(n)


def test_show_merged_model_matches_jax(tmp_path, capsys):
    from paddle_tpu.utils import show_merged_model as jshow

    port_text, _ = _dumps("lenet", tmp_path)
    rs = np.random.RandomState(0)
    path = tmp_path / "merged.npz"
    np.savez(path, __trainer_config__=np.asarray(port_text),
             **{"param/conv.w": rs.randn(5, 5, 1, 4).astype(np.float32),
                "param/fc.b": np.zeros(10, np.float32), "meta": np.arange(3)})
    got = show_merged_model(str(path))
    want = jshow(str(path))
    assert got == want and got.startswith(port_text[:40])
    assert capsys.readouterr().out == got + want


def _net(L, Data, C):
    x = Data("x", shape=(8,))
    lab = Data("label", shape=())
    h = L.Fc(x, 16, act="relu", name="hidden")
    out = L.Fc(h, 3, act="softmax", name="out")
    return C.ClassificationCost(out, lab, name="cost")


def test_to_dot_matches_jax(tmp_path):
    from paddle_tpu.nn import costs as JC
    from paddle_tpu.nn import layers as JL
    from paddle_tpu.nn.graph import reset_name_scope as j_reset
    from paddle_tpu.utils import make_diagram as jmake
    from paddle_tpu.utils import to_dot as jdot

    from paddle_tpu_torch.nn import costs as TC
    from paddle_tpu_torch.nn import layers as TL
    from paddle_tpu_torch.nn.graph import Network
    from paddle_tpu_torch.nn.graph import reset_name_scope as t_reset

    j_reset()
    t_reset()
    jcost = _net(JL, JL.Data, JC)
    tcost = _net(TL, TL.Data, TC)
    assert to_dot(tcost, "m") == jdot(jcost, "m")
    assert to_dot(Network([tcost])) == jdot([jcost])
    assert '"hidden" -> "out";' in to_dot(tcost)
    tp = make_diagram(tcost, str(tmp_path / "port.dot"))
    jp = jmake(jcost, str(tmp_path / "jax.dot"))
    assert open(tp).read() == open(jp).read()


def test_version_prints_the_jax_line(capsys):
    from paddle_tpu import __version__ as jversion
    from paddle_tpu import cli as jcli

    assert jcli.main(["version"]) == 0
    want = capsys.readouterr().out
    assert tcli.main(["version"]) == 0
    assert capsys.readouterr().out == want == f"paddle-tpu {jversion}\n"
    out = subprocess.run([sys.executable, "-m", "paddle_tpu_torch", "version"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout == want
