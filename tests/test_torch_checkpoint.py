"""The port's checkpoints against the JAX package's, on the CPU.

  * save + load into a fresh trainer is bitwise: parameters, states (batch
    norm's moving statistics), Adam's slots, its step counter t and the
    samples counter;
  * the pass directory has the JAX package's files and keys, and its v1
    binary parameter files are byte-identical to the JAX package's for the
    same parameters;
  * the port loads a JAX `SGDTrainer.save` and its next 2 steps match the
    JAX trainer's (costs within 1e-5 relative; parameters within rtol 1e-5
    and an atol of 1e-5 x the tensor's largest magnitude: Adam divides by
    the root of its second moment, so an element passing near 0 keeps a
    few-ulp absolute difference but no relative one), and the JAX package
    loads the port's the same way;
  * auto_resume skips a torn pass (the `ckpt_truncate` fault) and
    keep_last_n prunes old passes;
  * a run killed after pass 1 (the `kill` fault) and auto-resumed ends
    bitwise equal to a run never stopped;
  * the async save writes what the sync save writes."""

import json
import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import faults
from paddle_tpu_torch.models import Seq2SeqModel as TorchSeq2Seq
from paddle_tpu_torch.nn import costs as TC
from paddle_tpu_torch.nn import graph as tgraph
from paddle_tpu_torch.nn import layers as TL
from paddle_tpu_torch.nn.convert import params_from_jax
from paddle_tpu_torch.optim import Adam
from paddle_tpu_torch.trainer import SGDTrainer
from paddle_tpu_torch.trainer import checkpoint as ckpt
from paddle_tpu_torch.trainer.events import EndPass

VOCAB, EMBED, HIDDEN = 20, 8, 12
COST_RTOL = 1e-5
PARAM_RTOL = 1e-5


def s2s_batch(seed, b=4, src_len=6, trg_len=5):
    rs = np.random.RandomState(seed)
    src_l = rs.randint(1, src_len + 1, b).astype(np.int32)
    trg_l = rs.randint(1, trg_len + 1, b).astype(np.int32)
    src_l[0], trg_l[0] = src_len, trg_len
    return {
        "source_ids": rs.randint(2, VOCAB, (b, src_len)).astype(np.int32),
        "source_ids.lengths": src_l,
        "target_ids": rs.randint(2, VOCAB, (b, trg_len)).astype(np.int32),
        "target_ids.lengths": trg_l,
        "label_ids": rs.randint(2, VOCAB, (b, trg_len)).astype(np.int32),
        "label_ids.lengths": trg_l,
    }


def image_batch(seed, b=4):
    rs = np.random.RandomState(seed)
    return {"image": rs.randn(b, 6, 6, 3).astype(np.float32),
            "label": rs.randint(0, 3, b).astype(np.int32)}


def port_s2s(lr=1e-2):
    tgraph.reset_name_scope()
    m = TorchSeq2Seq(VOCAB, VOCAB, embed_dim=EMBED, hidden_dim=HIDDEN)
    return SGDTrainer(m.cost, Adam(learning_rate=lr), seed=0, device="cpu")


def port_bn():
    """A conv + batch norm net: a model with states."""
    tgraph.reset_name_scope()
    x = TL.Conv2D(TL.Data("image", shape=(6, 6, 3)), 4, 3, padding=1, bias=False, name="c")
    x = TL.GlobalPool(TL.BatchNorm(x, act="relu", name="bn"), "avg", name="gap")
    cost = TC.ClassificationCost(TL.Fc(x, 3, act=None, name="fc"),
                                 TL.Data("label", shape=()), name="cost")
    return SGDTrainer(cost, Adam(learning_rate=1e-2), seed=0, device="cpu")


MODELS = {"s2s": (port_s2s, s2s_batch), "bn": (port_bn, image_batch)}


def state_tensors(tr):
    """Every tensor of the state by checkpoint key, plus the samples."""
    flat = {f"{name}/{k}": v for name, tree in tr._trees().items() for k, v in tree.items()}
    return flat, tr.state["samples"]


def assert_same_state(a, b):
    fa, sa = state_tensors(a)
    fb, sb = state_tensors(b)
    assert sa == sb
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


@pytest.mark.parametrize("model", sorted(MODELS))
def test_round_trip_is_bitwise(model, tmp_path):
    make, batch_fn = MODELS[model]
    tr = make()
    for s in range(3):
        tr.step(batch_fn(s))
    pdir = tr.save(str(tmp_path), 0, async_=False)
    assert ckpt.verify_pass(pdir)
    fresh = make()
    fresh.init_state(batch_fn(0))
    fresh.load(str(tmp_path))
    assert_same_state(tr, fresh)
    assert int(fresh.state["opt"]["t"]) == 3 and fresh.state["samples"] == 12
    if model == "bn":
        assert fresh.state["states"] and all(
            float(v.abs().sum()) > 0 for v in fresh.state["states"].values())
    # and the next step is the same step
    assert torch.equal(tr.step(batch_fn(7)), fresh.step(batch_fn(7)))
    assert_same_state(tr, fresh)


@pytest.fixture
def jax_s2s(monkeypatch):
    """A JAX SGDTrainer over the same model at the same widths, Pallas
    off (the plain reference path), with its compiled step."""
    from paddle_tpu.models import Seq2SeqModel
    from paddle_tpu.nn.graph import reset_name_scope
    from paddle_tpu.optim import Adam as JaxAdam
    from paddle_tpu.trainer import SGDTrainer as JaxTrainer

    monkeypatch.setenv("PADDLE_TPU_PALLAS", "0")

    def make():
        reset_name_scope()
        m = Seq2SeqModel(VOCAB, VOCAB, embed_dim=EMBED, hidden_dim=HIDDEN)
        jt = JaxTrainer(m.cost, JaxAdam(learning_rate=1e-2), seed=0)
        jt.init_state(s2s_batch(0))
        return jt

    return make


def jax_steps(jt, batches):
    step = jt._make_step()
    costs = []
    for b in batches:
        jt.state, cost, _ = step(jt.state, b)
        costs.append(float(cost))
    return costs


def assert_params_match(port_params, jax_params):
    assert set(port_params) == set(jax_params)
    for k, v in jax_params.items():
        v = np.asarray(v)
        np.testing.assert_allclose(port_params[k].numpy(), v, err_msg=k, rtol=PARAM_RTOL,
                                   atol=PARAM_RTOL * float(np.abs(v).max()))


def test_pass_directory_is_the_jax_packages(jax_s2s, tmp_path):
    jt = jax_s2s()
    jax_steps(jt, [s2s_batch(1)])
    jt.save(str(tmp_path / "jax"), 0)
    tr = port_s2s()
    tr.init_state(s2s_batch(0))
    tr.load_params(params_from_jax({k: np.asarray(v) for k, v in jt.state["params"].items()},
                                   device="cpu"))
    tr.step(s2s_batch(1))
    tr.load_params(params_from_jax({k: np.asarray(v) for k, v in jt.state["params"].items()},
                                   device="cpu"))
    tr.save(str(tmp_path / "port"), 0)
    jdir, pdir = tmp_path / "jax" / "pass-00000", tmp_path / "port" / "pass-00000"
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(pdir))
    jm, pm = (json.loads((d / "manifest.json").read_text()) for d in (jdir, pdir))
    # the port's extra holds the JAX package's fields and two more: the
    # threefry key and the divergence count (the JAX package leaves them out)
    assert {k: pm["extra"][k] for k in jm["extra"]} == jm["extra"]
    assert set(pm["extra"]) - set(jm["extra"]) == {"rng", "diverged"}
    assert pm["extra"]["rng"] == [0, 0] and pm["extra"]["diverged"] == 0
    assert jm["pass_id"] == pm["pass_id"] == 0
    assert jm["version"] == pm["version"]
    for name in jm["files"]:
        assert jm["files"][name]["keys"] == pm["files"][name]["keys"], name
    assert (tmp_path / "jax" / "latest").read_text() == (tmp_path / "port" / "latest").read_text()
    # the v1 binary parameter files: byte for byte
    for name in jt.state["params"]:
        assert (jdir / name).read_bytes() == (pdir / name).read_bytes(), name
    assert ckpt.is_v1_model_dir(str(tmp_path / "port" / "pass-00000")) is False
    assert ckpt.is_v1_model_dir(str(tmp_path / "v1")) is False


def test_port_loads_a_jax_checkpoint_and_resumes(jax_s2s, tmp_path):
    jt = jax_s2s()
    jt.train(lambda: iter([s2s_batch(1), s2s_batch(2)]), num_passes=1,
             save_dir=str(tmp_path), async_checkpoint=False)
    tr = port_s2s()
    tr.init_state(s2s_batch(0))
    tr.load(str(tmp_path))
    assert tr.state["samples"] == 8 and int(tr.state["opt"]["t"]) == 2
    nxt = [s2s_batch(3), s2s_batch(4)]
    want = jax_steps(jt, nxt)
    got = [float(tr.step(b)) for b in nxt]
    np.testing.assert_allclose(got, want, rtol=COST_RTOL)
    assert_params_match(tr.state["params"], jt.state["params"])
    assert int(jt.state["opt"]["t"]) == int(tr.state["opt"]["t"]) == 4


def test_jax_loads_a_port_checkpoint_and_resumes(jax_s2s, tmp_path):
    tr = port_s2s()
    tr.init_state(s2s_batch(0))
    jt = jax_s2s()
    tr.load_params(params_from_jax({k: np.asarray(v) for k, v in jt.state["params"].items()},
                                   device="cpu"))
    tr.train(lambda: iter([s2s_batch(1), s2s_batch(2)]), num_passes=1,
             save_dir=str(tmp_path), async_checkpoint=False)
    jt.load(str(tmp_path))
    assert int(jt.state["samples"]) == 8 and int(jt.state["opt"]["t"]) == 2
    nxt = [s2s_batch(3), s2s_batch(4)]
    want = jax_steps(jt, nxt)
    got = [float(tr.step(b)) for b in nxt]
    np.testing.assert_allclose(got, want, rtol=COST_RTOL)
    assert_params_match(tr.state["params"], jt.state["params"])


def test_v1_model_dir_loads_parameters_only(tmp_path):
    tr = port_s2s()
    tr.step(s2s_batch(1))
    from paddle_tpu_torch.trainer import v1_format

    v1_format.save_model_dir(str(tmp_path), {k: v.numpy() for k, v in tr.state["params"].items()})
    assert ckpt.is_v1_model_dir(str(tmp_path))
    fresh = port_s2s()
    fresh.init_state(s2s_batch(0))
    fresh.load(str(tmp_path))
    for k, v in tr.state["params"].items():
        assert torch.equal(fresh.state["params"][k], v), k
    assert int(fresh.state["opt"]["t"]) == 0 and fresh.state["samples"] == 0


def batches_reader(seeds):
    return lambda: iter([s2s_batch(s) for s in seeds])


def test_auto_resume_skips_a_torn_pass_and_keep_last_n_prunes(tmp_path):
    tr = port_s2s()
    # pass 2's params.npz is torn after its rename (the 3rd save's 1st file)
    with faults.inject("ckpt_truncate:step=4"):
        tr.train(batches_reader([1, 2]), num_passes=3, save_dir=str(tmp_path),
                 keep_last_n=2, async_checkpoint=False)
    assert sorted(os.listdir(tmp_path)) == ["latest", "pass-00001", "pass-00002"]
    assert not ckpt.verify_pass(str(tmp_path / "pass-00002"))
    assert ckpt.find_latest_valid_pass(str(tmp_path)) == 1
    resumed = port_s2s()
    passes = []
    resumed.train(batches_reader([1, 2]), num_passes=3, save_dir=str(tmp_path),
                  auto_resume=True, event_handler=lambda e: isinstance(e, EndPass)
                  and passes.append(e.pass_id), async_checkpoint=False)
    assert passes == [2]  # pass 1 restored, pass 2 trained again
    assert_same_state(resumed, tr)
    assert ckpt.verify_pass(str(tmp_path / "pass-00002"))


@pytest.mark.parametrize("async_checkpoint", [False, True])
def test_killed_and_resumed_run_is_bitwise_an_unbroken_one(async_checkpoint, tmp_path):
    reader = batches_reader([1, 2, 3])
    unbroken = port_s2s()
    unbroken.train(reader, num_passes=4)
    killed = port_s2s()
    # the kill site is polled before every dispatch: step=4 is pass 1's 2nd
    with faults.inject("kill:step=4"), pytest.raises(faults.InjectedKill):
        killed.train(reader, num_passes=4, save_dir=str(tmp_path),
                     async_checkpoint=async_checkpoint)
    assert ckpt.find_latest_valid_pass(str(tmp_path)) == 0
    resumed = port_s2s()
    resumed.train(reader, num_passes=4, save_dir=str(tmp_path), auto_resume=True,
                  async_checkpoint=async_checkpoint)
    assert_same_state(resumed, unbroken)
    assert ckpt.find_latest_valid_pass(str(tmp_path)) == 3


def test_resume_of_a_finished_run_loads_the_last_pass(tmp_path):
    tr = port_s2s()
    tr.train(batches_reader([1, 2]), num_passes=2, save_dir=str(tmp_path))
    again = port_s2s()
    ran = []
    again.train(batches_reader([1, 2]), num_passes=2, save_dir=str(tmp_path),
                auto_resume=True, event_handler=ran.append)
    assert ran == []
    assert_same_state(again, tr)


def test_async_save_writes_what_the_sync_save_writes(tmp_path):
    tr = port_bn()
    for s in range(2):
        tr.step(image_batch(s))
    tr.save(str(tmp_path / "sync"), 0)
    tr.save(str(tmp_path / "async"), 0, async_=True)
    tr.step(image_batch(5))  # may run while the writer writes
    tr.checkpoint_wait()
    got = [ckpt.load_pass(str(tmp_path / d)) for d in ("sync", "async")]
    for a, b in zip(got[0][:3], got[1][:3]):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    m0, m1 = got[0][3], got[1][3]
    assert m0["extra"] == m1["extra"] and m0["extra"]["samples"] == 8
    for name in m0["files"]:
        assert m0["files"][name]["keys"] == m1["files"][name]["keys"]


def test_load_rejects_a_foreign_optimizer_state(tmp_path):
    tr = port_s2s()
    tr.step(s2s_batch(1))
    pdir = tr.save(str(tmp_path), 0)
    opt = dict(np.load(os.path.join(pdir, "opt.npz")))
    wrong = {k: (v[..., :1] if v.ndim else v) for k, v in opt.items()}
    np.savez(os.path.join(pdir, "opt.npz"), **wrong)
    crc = ckpt.zlib.crc32(open(os.path.join(pdir, "opt.npz"), "rb").read())
    man = json.load(open(os.path.join(pdir, "manifest.json")))
    man["files"]["opt"]["crc32"] = crc
    json.dump(man, open(os.path.join(pdir, "manifest.json"), "w"))
    with pytest.raises(ValueError, match="shapes differ"):
        tr.load(str(tmp_path))


@pytest.mark.parametrize("shape", [(3,), (4, 5), (2, 3, 4, 5)])
def test_v1_param_bytes_match_jax(shape):
    """`Parameter::save` bytes equal the JAX package's (4-D HWIO weights
    written in the reference's [cin, kh, kw, cout] order), and read back."""
    import io

    from paddle_tpu.trainer import v1_format as jv1
    from paddle_tpu_torch.trainer import v1_format as tv1

    arr = np.random.RandomState(0).randn(*shape).astype(np.float32)
    got, want = io.BytesIO(), io.BytesIO()
    tv1.write_param(got, "w", arr)
    jv1.write_param(want, "w", arr)
    assert got.getvalue() == want.getvalue()
    got.seek(0)
    np.testing.assert_array_equal(tv1.read_param(got, "w", shape), arr)
