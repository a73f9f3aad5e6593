"""The paddle.v2 book's chapters on the port against the JAX package, on the
CPU, each reading its records from `paddle.dataset.*`.

The chapters are chip_smoke.py's (`book_*`, `BOOK_CHAPTERS`, `book_run`),
written once against a `paddle` module argument, so the same function
builds the network in both packages: fit_a_line (uci_housing),
recognize_digits (mnist), image_classification (cifar.train10,
vgg_bn_drop), word2vec (imikolov), recommender_system (movielens,
cos_sim), understand_sentiment (imdb,
stacked_lstm_net), label_semantic_roles (conll05, db_lstm, crf +
crf_decoding) and machine_translation (wmt14, the fused GRU). Here they run
at reduced widths (widths <= 16, SRL depth 2, one VGG conv per stage; the
word2vec and NMT dictionaries cut to 64 words, imdb's synthetic ids reach
200 and conll05's 2000).

Both packages' `DATA_HOME` point at one empty directory, so both read the
same synthetic records. Each chapter trains 2 batches in each package from
the same parameters (the port's initial `Parameters` moved across by name
as a tar: the JAX package's `parameters.create` compiles its init op by
op, most of this file's time otherwise) over the same shuffled batches
(Python's `random` seeded alike before each run): the two EndIteration
costs agree within 1e-5 relative.
The twins here drop the sentiment and SRL chapters' ModelAverage (the JAX
package's averages alias its parameters under its donating step, ROADMAP
§3 fault 3); chip_smoke.py's phase 31 keeps it. From the JAX package's
trained parameters, NMT's generated ids (layer.beam_search through infer)
and SRL's crf_decoding ids are the JAX package's exactly.

The JAX twins reach `paddle.layer.gru_step` and `networks.simple_gru(name=)`
through `config.v1_layers.gru_step_layer` and `nn.recurrent.simple_gru`
(ROADMAP §3 faults 9 and 13), and NMT's cost over its decoder group takes
the group's probabilities as the port does (§3 fault 10). On a card
(marked `cuda`, skipped here): the machine translation chapter launches
the GRU kernels every step and agrees with the CPU. jax is imported
inside the CPU tests only."""

import io
import random
import types

import numpy as np
import pytest
import torch

import chip_smoke as cs
import paddle_tpu_torch.v2 as tpaddle
from paddle_tpu_torch.core import init_ctx
from paddle_tpu_torch.nn import graph as tgraph

SMALL = dict(
    fit_a_line=dict(batch=8),
    recognize_digits=dict(batch=8, filters=(4, 8)),
    image_classification=dict(batch=8, stages=((4, 1), (8, 1), (8, 1), (16, 1), (16, 1)),
                              fc=16),
    word2vec=dict(batch=8, emb=8, hidden=16, vocab=64),
    recommender_system=dict(batch=8, emb=8, small=4, combined=16, title_dict=5000),
    understand_sentiment=dict(batch=8, emb=8, hidden=16, stacked=3, average=False),
    label_semantic_roles=dict(batch=8, word_dim=8, mark_dim=5, hidden=16, depth=2,
                              average=False),
    machine_translation=dict(batch=8, vocab=64, size=16, beam=3, max_length=8),
)
COST_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    """One empty DATA_HOME for both packages, no network, fresh auto-names
    and the port's `paddle.init` flags put back."""
    import urllib.request

    def offline(url, *a, **k):
        raise OSError(f"offline: {url}")

    monkeypatch.setattr(urllib.request, "urlretrieve", offline)
    monkeypatch.setattr(tpaddle.dataset.common, "DATA_HOME", str(tmp_path))
    saved = init_ctx.flags().__dict__.copy()
    tgraph.reset_name_scope()
    yield
    init_ctx.flags().__dict__.update(saved)


def _jax_paddle(monkeypatch, tmp_path):
    """The JAX package's paddle.v2, with the book's two names it lacks and
    the port's repaired classification_cost over a group."""
    import paddle_tpu.v2 as jp
    from paddle_tpu.config.v1_layers import gru_step_layer
    from paddle_tpu.nn import costs as jcosts
    from paddle_tpu.nn.graph import reset_name_scope
    from paddle_tpu.nn.recurrent import simple_gru

    monkeypatch.setattr(jp.dataset.common, "DATA_HOME", str(tmp_path))
    reset_name_scope()
    jp.init(use_gpu=False, trainer_count=1, seed=0)

    def named_simple_gru(input, size, reverse=False, name="gru", **_):
        return simple_gru(input, size, reverse=reverse, name=name)

    paddle = types.SimpleNamespace(**{k: getattr(jp, k) for k in dir(jp)
                                      if not k.startswith("__")})
    def classification_cost(input, label, name=None, coeff=1.0, **_):
        """A group ending in a softmax gives probabilities, which the JAX
        package's cost softmaxes again (ROADMAP §3 fault 10); the port's
        looks through the group, as this twin does."""
        if jp.layer.effective_act(input) is not None:
            return jp.layer.classification_cost(input=input, label=label, name=name,
                                                coeff=coeff)
        return jcosts.ClassificationCost(input, label, name=name, coeff=coeff,
                                         from_logits=False)

    paddle.layer = types.SimpleNamespace(**{**vars(jp.layer), "gru_step": gru_step_layer,
                                            "classification_cost": classification_cost})
    paddle.networks = types.SimpleNamespace(**{**vars(jp.networks),
                                               "simple_gru": named_simple_gru})
    return paddle, reset_name_scope


def _tar(params):
    buf = io.BytesIO()
    params.to_tar(buf)
    return buf.getvalue()


def _both(name, monkeypatch, tmp_path):
    """The chapter's 2 batches in the port, then in the JAX package from
    the port's initial parameters -> (jax run, port run, jax paddle)."""
    cfg = SMALL[name]
    tpaddle.init(use_gpu=False, seed=0)
    random.seed(0)
    trun = cs.book_run(tpaddle, name, cfg, 2, keep_init=True)
    jpaddle, jreset = _jax_paddle(monkeypatch, tmp_path)
    random.seed(0)
    jrun = cs.book_run(jpaddle, name, cfg, 2, start_tar=trun["init_tar"])
    assert len(jrun["costs"]) == len(trun["costs"]) == 2
    assert np.isfinite(trun["costs"]).all()
    np.testing.assert_allclose(trun["costs"], jrun["costs"], rtol=COST_RTOL)
    return jrun, trun, (jpaddle, jreset)


@pytest.mark.parametrize("name", ["fit_a_line", "recognize_digits", "image_classification",
                                  "word2vec", "recommender_system",
                                  "understand_sentiment"])
def test_chapter_trains_like_jax(name, monkeypatch, tmp_path):
    _, trun, _ = _both(name, monkeypatch, tmp_path)
    assert tpaddle.dataset.common.SYNTHETIC
    assert trun["trainer"].trainer.graphs == {}  # graphs are captured on a card only


def test_label_semantic_roles_decodes_like_jax(monkeypatch, tmp_path):
    jrun, trun, (jpaddle, _) = _both("label_semantic_roles", monkeypatch, tmp_path)
    feeding = {k: v for k, v in trun["chapter"]["feeding"].items() if k != "target"}
    samples = [s[:-1] for _, s in zip(range(12), tpaddle.dataset.conll05.test()())]
    want = jpaddle.infer(output_layer=jrun["chapter"]["decode"],
                         parameters=jrun["trainer"].parameters, input=samples,
                         feeding=feeding, field="value", batch_size=8)
    params = tpaddle.parameters.Parameters.from_tar(io.BytesIO(_tar(jrun["trainer"].parameters)))
    got = tpaddle.infer(output_layer=trun["chapter"]["decode"], parameters=params,
                        input=samples, feeding=feeding, field="value", batch_size=8)
    want, got = np.asarray(want), np.asarray(got)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    n_labels = trun["chapter"]["label_dict_len"]
    assert 0 <= got.min() and got.max() < n_labels


def test_machine_translation_generates_like_jax(monkeypatch, tmp_path):
    """Training through wmt14, then layer.beam_search + infer(field="value")
    over wmt14.test sources from the JAX package's trained parameters
    (sharpened x3, as tests/test_torch_generation_serving.py does, so
    near-ties are rare): the best beams' ids equal, and every id a word of
    wmt14.get_dict."""
    cfg = SMALL["machine_translation"]
    jrun, _, (jpaddle, jreset) = _both("machine_translation", monkeypatch, tmp_path)
    jparams = jrun["trainer"].parameters
    for k in jparams.names():
        jparams.set(k, 3 * jparams.get(k))
    sources = [(s,) for _, (s, _, _) in zip(range(11), tpaddle.dataset.wmt14.test(cfg["vocab"])())]
    feeding = {"source_language_word": 0}
    jreset()
    want = np.asarray(jpaddle.infer(output_layer=cs.v2_nmt_net(jpaddle, cfg, True),
                                    parameters=jparams, input=sources, feeding=feeding,
                                    field="value", batch_size=8))
    tgraph.reset_name_scope()
    params = tpaddle.parameters.Parameters.from_tar(io.BytesIO(_tar(jparams)))
    got = tpaddle.infer(output_layer=cs.v2_nmt_net(tpaddle, cfg, True), parameters=params,
                        input=sources, feeding=feeding, field="value", batch_size=8)
    assert got.shape == (11, cfg["max_length"]) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    _, trg_words = tpaddle.dataset.wmt14.get_dict(cfg["vocab"])
    assert all(int(i) in trg_words for i in got.ravel())


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_machine_translation_chapter_launches_the_gru_kernels(cuda):
    """The chapter through wmt14 on the card: the GRU kernels launch 2 + 2
    a step (and the init's 2 forwards), and its costs are the CPU's from
    the same parameters over the same batches."""
    from paddle_tpu_torch.ops import rnn_kernels as K

    cfg, steps = SMALL["machine_translation"], 4
    out, tar = {}, None
    for dev in ("cpu", "cuda"):
        tgraph.reset_name_scope()
        tpaddle.init(use_gpu=dev == "cuda", seed=0)
        random.seed(0)
        K.FWD_LAUNCHES = K.BWD_LAUNCHES = 0
        run = cs.book_run(tpaddle, "machine_translation", cfg, steps, start_tar=tar,
                          keep_init=tar is None)
        tar = tar or run["init_tar"]
        out[dev] = (run["costs"], K.FWD_LAUNCHES, K.BWD_LAUNCHES)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=COST_RTOL)
    assert out["cuda"][1:] == (2 * steps + 2, 2 * steps)
