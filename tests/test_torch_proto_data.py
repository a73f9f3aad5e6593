"""The port's ProtoData shards and providers (`paddle_tpu_torch/data/proto_data.py`,
the `proto*` branch of `data/provider.load_provider`) against the JAX
package's `paddle_tpu/data/proto_data.py`, on the CPU.

  * A shard written by either package's writer is byte for byte the
    other's, and each reader reads the other's back equal (dense, sparse,
    index and sub-sequence slots, is_beginning); a truncated shard is
    rejected naming its file; `resolve_data_path` as the JAX package's.
  * Both providers give the same samples and input types for `proto`
    (dense + index, iid and grouped into sequences by is_beginning) and
    `proto_sequence` (tokens + label, an empty token slot giving the -1
    placeholder), over two training passes (the same per-pass shuffles)
    and a test pass (file order).
  * A tiny v1 config on `TrainData(ProtoData(files=..., type=
    "proto_sequence"))` trains 2 steps through `python -m paddle_tpu_torch
    train` (in process) from the same initial pass as the JAX CLI: the
    per-step costs within 1e-5 relative.
jax is imported inside the tests only."""

import logging
import os
import textwrap

import numpy as np
import pytest

from paddle_tpu_torch.data import proto_data as tpd


def _pkg(name):
    if name == "jax":
        from paddle_tpu.data import proto_data
        return proto_data
    return tpd


def _mixed_samples(pd, n=6):
    return [
        pd.DataSample(
            is_beginning=(i % 3 == 0),
            vector_slots=[pd.VectorSlot(values=np.arange(3, dtype=np.float32) * 0.5 + i),
                          pd.VectorSlot(ids=[i, i + 1, 99][:1 + i % 3])],
            id_slots=[i % 7],
            subseq_slots=[pd.SubseqSlot(slot_id=1, lens=[2, 1])] if i == 0 else [])
        for i in range(n)]


def _mixed_defs(pd):
    return [pd.SlotDef(pd.VECTOR_DENSE, 3), pd.SlotDef(pd.VECTOR_SPARSE_NON_VALUE, 100),
            pd.SlotDef(pd.INDEX, 7)]


def _same_samples(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.is_beginning == y.is_beginning and x.id_slots == y.id_slots
        assert len(x.vector_slots) == len(y.vector_slots)
        for u, v in zip(x.vector_slots, y.vector_slots):
            np.testing.assert_array_equal(u.values, v.values)
            assert (u.ids, u.dims, u.strs) == (v.ids, v.dims, v.strs)
        assert [(s.slot_id, s.lens) for s in x.subseq_slots] == [
            (s.slot_id, s.lens) for s in y.subseq_slots]


@pytest.mark.parametrize("suffix", [".bin", ".bin.gz"])
@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_shards_cross_packages(tmp_path, writer, reader, suffix):
    w, r = _pkg(writer), _pkg(reader)
    path = str(tmp_path / f"shard{suffix}")
    w.write_shard(path, _mixed_defs(w), _mixed_samples(w))
    header, got = r.read_shard(path)
    assert [(sd.type, sd.dim) for sd in header] == [(0, 3), (1, 100), (3, 7)]
    _same_samples(got, _mixed_samples(r))
    if suffix == ".bin":  # gzip stamps the time: compare the raw encoding
        other = str(tmp_path / "other.bin")
        r.write_shard(other, _mixed_defs(r), _mixed_samples(r))
        assert open(path, "rb").read() == open(other, "rb").read()


def test_truncated_shard_is_rejected(tmp_path):
    path = str(tmp_path / "shard.bin")
    tpd.write_shard(path, [tpd.SlotDef(tpd.VECTOR_DENSE, 8)], [
        tpd.DataSample(vector_slots=[tpd.VectorSlot(values=np.arange(8, dtype=np.float32))])
        for _ in range(4)])
    whole = open(path, "rb").read()
    cut = str(tmp_path / "cut.bin")
    with open(cut, "wb") as f:
        f.write(whole[:len(whole) - 9])
    with pytest.raises(ValueError, match="cut.bin"):
        tpd.read_shard(cut)
    assert len(tpd.read_shard(path)[1]) == 4


def test_resolve_data_path_matches_jax(tmp_path):
    jpd = _pkg("jax")
    (tmp_path / "sub").mkdir()
    (tmp_path / "data.bin").write_bytes(b"")
    cfg = str(tmp_path / "sub")
    for p in (None, "", "nope.bin", "data.bin", str(tmp_path / "data.bin")):
        assert tpd.resolve_data_path(p, cfg) == jpd.resolve_data_path(p, cfg)
    assert tpd.resolve_data_path("data.bin", cfg) == str(tmp_path / "data.bin")


def _proto_shard(pd, path, grouped):
    """dense [2] + index (5 classes), 24 samples; grouped: a sequence
    begins every 3rd sample."""
    pd.write_shard(path, [pd.SlotDef(pd.VECTOR_DENSE, 2), pd.SlotDef(pd.INDEX, 5)], [
        pd.DataSample(is_beginning=not grouped or i % 3 == 0,
                      vector_slots=[pd.VectorSlot(values=np.asarray([i, -i], np.float32))],
                      id_slots=[i % 5])
        for i in range(24)])


def _seq_shard(pd, path):
    """proto_sequence: tokens (vocab 40, empty for every 7th sample) +
    label, 20 samples."""
    rs = np.random.RandomState(4)
    pd.write_shard(path, [pd.SlotDef(pd.VECTOR_SPARSE_NON_VALUE, 40),
                          pd.SlotDef(pd.INDEX, 2)], [
        pd.DataSample(vector_slots=[pd.VectorSlot(
            ids=[] if i % 7 == 3 else rs.randint(0, 40, rs.randint(2, 6)).tolist())],
            id_slots=[i % 2])
        for i in range(20)])


def _norm(sample):
    return [np.asarray(f).tolist() if isinstance(f, np.ndarray) else
            [np.asarray(x).tolist() for x in f] if isinstance(f, list) else f
            for f in sample]


@pytest.mark.parametrize("kind", ["proto_iid", "proto_grouped", "proto_sequence"])
def test_providers_match_jax(tmp_path, kind):
    jpd = _pkg("jax")
    path = str(tmp_path / "shard.bin")
    if kind == "proto_sequence":
        _seq_shard(tpd, path)
    else:
        _proto_shard(tpd, path, grouped=kind == "proto_grouped")
    seq_mode = kind == "proto_sequence"
    jprov, tprov = jpd.ProtoProvider(seq_mode, seed=3), tpd.ProtoProvider(seq_mode, seed=3)
    jtypes = jprov.make_settings(file_list=[path]).input_types
    ttypes = tprov.make_settings(file_list=[path]).input_types
    assert [(t.kind, t.dim) for t in ttypes] == [(t.kind, t.dim) for t in jtypes]
    passes = {}
    for name, prov in (("jax", jprov), ("torch", tprov)):
        passes[name] = [[_norm(s) for s in prov(file_list=[path], is_train=train)]
                        for train in (True, True, False)]
        assert [prov.calc_batch_size(s) for s in prov(file_list=[path], is_train=False)] == [
            jprov.calc_batch_size(s) for s in jprov(file_list=[path], is_train=False)]
    assert passes["torch"] == passes["jax"]
    first, second, test = passes["torch"]
    assert first != second and sorted(map(str, first)) == sorted(map(str, test))
    if kind == "proto_sequence":
        assert [[-1], 1] in test  # the empty token slot's placeholder
    if kind == "proto_grouped":
        assert len(test) == 8 and test[0][1] == [0, 1, 2]


TINY = """
from paddle.trainer_config_helpers import *
settings(batch_size=8, learning_rate=1e-2, learning_method=AdamOptimizer())
TrainData(ProtoData(files="train.list", type="proto_sequence"))
word = data_layer(name="word", size=40)
label = data_layer(name="label", size=2)
emb = embedding_layer(input=word, size=8)
bi = bidirectional_gru(input=emb, size=8)
out = fc_layer(input=bi, size=2, act=SoftmaxActivation())
outputs(classification_cost(input=out, label=label))
"""


def test_proto_sequence_config_trains_through_the_cli_like_jax(tmp_path, monkeypatch, caplog):
    import jax
    from paddle_tpu import cli as jcli
    from paddle_tpu.config import parse_config as jparse
    from paddle_tpu.nn.graph import Network as JNetwork
    from paddle_tpu.trainer.checkpoint import save_pass as jsave

    from paddle_tpu_torch import cli as tcli

    _seq_shard(tpd, str(tmp_path / "train.bin"))
    (tmp_path / "train.list").write_text("train.bin\n")
    (tmp_path / "conf.py").write_text(textwrap.dedent(TINY))
    monkeypatch.chdir(tmp_path)
    # one initial pass for both CLIs: the JAX package's parameters
    rs = np.random.RandomState(0)
    batch = {"word": rs.randint(0, 40, (2, 5)).astype(np.int32),
             "word.lengths": np.asarray([5, 3], np.int32),
             "label": np.asarray([0, 1], np.int32)}
    params = JNetwork(jparse("conf.py", emit_proto=False).outputs).init(
        jax.random.PRNGKey(0), batch)[0]
    jsave(str(tmp_path / "init"), 0, {k: np.asarray(v) for k, v in params.items()})
    argv = ["train", "--config=conf.py", "--num_passes=1", "--log_period=1",
            "--init_model_path=init", "--start_pass=1"]
    costs = {}
    for name, main, extra in (("jax", jcli.main, []), ("torch", tcli.main, ["--device=cpu"])):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            assert main(argv + extra) == 0
        costs[name] = [r.args[2] for r in caplog.records if "batch %d cost=" in str(r.msg)]
    assert len(costs["torch"]) == 3  # 20 samples in batches of 8
    np.testing.assert_allclose(costs["torch"][:2], costs["jax"][:2], rtol=1e-5)
    np.testing.assert_allclose(costs["torch"], costs["jax"], rtol=1e-5)
