"""The port's beam search and seq2seq generation against the JAX package's,
on the CPU.

  * `expand_beams` and `beam_search_scan` on fixed log-probs give the JAX
    package's ids exactly and its scores within 1e-5, in cases built so
    that ties decide the order (integer-valued log-probs, beams finishing
    early, whose rows of equal candidates `lax.top_k` breaks by the lower
    index);
  * `Seq2SeqModel.build_generator` on parameters carried from a JAX
    `Seq2SeqModel` gives the JAX generator's ids exactly and its scores
    within 1e-4;
  * the JAX package's copy task (`tests/test_seq2seq.py`), trained with the
    port's `train(reader.batch(...), feeder=DataFeeder(...))`, reproduces
    at least 3 of 4 sequences through beam search."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.data import DataFeeder, InputSpec
from paddle_tpu_torch.data import reader as rd
from paddle_tpu_torch.models import Seq2SeqModel as TorchSeq2Seq
from paddle_tpu_torch.nn import beam_core as tbc
from paddle_tpu_torch.nn import graph as tgraph
from paddle_tpu_torch.nn.convert import params_from_jax
from paddle_tpu_torch.optim import Adam
from paddle_tpu_torch.trainer import SGDTrainer

SCORE_TOL = 1e-5
GEN_SCORE_TOL = 1e-4


def _logps(seed, steps, rows, vocab, ties):
    rs = np.random.RandomState(seed)
    if ties:  # few distinct values: ties everywhere
        x = -rs.randint(0, 3, (steps, rows, vocab)).astype(np.float32)
    else:
        x = rs.randn(steps, rows, vocab).astype(np.float32)
        x = x - np.log(np.exp(x).sum(-1, keepdims=True))
    return x


@pytest.mark.parametrize("ties", [False, True])
def test_expand_beams_matches_jax(ties):
    import jax.numpy as jnp

    from paddle_tpu.nn import beam_core as jbc

    b, k, v = 3, 4, 7
    rs = np.random.RandomState(1)
    cand = _logps(2, 1, b * k, v, ties)[0].reshape(b, k, v)
    pre = (-rs.randint(0, 3, (b, k))).astype(np.float32) if ties else rs.randn(b, k).astype(
        np.float32)
    finished = rs.rand(b, k) < 0.5
    finished[0] = True  # a row of finished beams only: all ties
    want = jbc.expand_beams(jnp.asarray(cand), jnp.asarray(pre), jnp.asarray(finished), 1, k)
    got = tbc.expand_beams(torch.from_numpy(cand), torch.from_numpy(pre),
                           torch.from_numpy(finished), 1, k)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=SCORE_TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("ties,eos,penalty", [(False, 1, 0.0), (True, 1, 0.0),
                                              (True, 0, 0.7), (False, 2, 1.0)])
def test_beam_search_scan_matches_jax(ties, eos, penalty):
    import jax.numpy as jnp

    from paddle_tpu.nn import beam_core as jbc

    b, k, v, steps = 3, 3, 6, 7
    logps = _logps(5, steps, b * k, v, ties)
    if ties:
        logps[:, :, eos] = 0.0  # EOS as good as the best: beams finish early
    h0 = np.arange(b * k, dtype=np.float32)[:, None]

    def jstep(tokens, carry, t):
        return jnp.asarray(logps)[t], carry * 2 + tokens[:, None]

    def tstep(tokens, carry, t):
        return torch.from_numpy(logps[t]), carry * 2 + tokens[:, None]

    want = jbc.beam_search_scan(jstep, jnp.asarray(h0), b, v, 0, eos, k, steps,
                                length_penalty=penalty)
    got = tbc.beam_search_scan(tstep, torch.from_numpy(h0), b, v, 0, eos, k, steps,
                               length_penalty=penalty)
    np.testing.assert_array_equal(got.history.numpy(), np.asarray(want.history))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0,
                               atol=SCORE_TOL)


@pytest.mark.parametrize("seed,vocab,beam,max_len", [(0, 16, 3, 7), (1, 24, 4, 9),
                                                     (2, 11, 2, 5)])
def test_generator_matches_jax(seed, vocab, beam, max_len, monkeypatch):
    import jax

    from paddle_tpu.models import Seq2SeqModel
    from paddle_tpu.nn.graph import Network, reset_name_scope

    monkeypatch.setenv("PADDLE_TPU_PALLAS", "0")
    rs = np.random.RandomState(seed)
    src = rs.randint(2, vocab, (3, 6)).astype(np.int32)
    lens = np.array([6, 4, 1], np.int32)
    reset_name_scope()
    jm = Seq2SeqModel(vocab, vocab, embed_dim=8, hidden_dim=12)
    batch = {"source_ids": src, "source_ids.lengths": lens, "target_ids": src,
             "target_ids.lengths": lens, "label_ids": src, "label_ids.lengths": lens}
    params, states = Network(jm.cost).init(jax.random.PRNGKey(seed), batch)
    want_ids, want_scores = jm.build_generator(beam_size=beam, max_len=max_len)(
        params, states, src, lens)
    tgraph.reset_name_scope()
    tm = TorchSeq2Seq(vocab, vocab, embed_dim=8, hidden_dim=12)
    tp = params_from_jax({k: np.asarray(v) for k, v in params.items()}, device="cpu")
    ids, scores = tm.build_generator(beam_size=beam, max_len=max_len)(tp, {}, src, lens)
    assert ids.shape == (3, beam, max_len) and ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), rtol=0,
                               atol=GEN_SCORE_TOL)


def test_copy_task_trained_with_the_feeder_reproduces_sequences():
    vocab = 12  # 0 = BOS, 1 = EOS, 2..11 payload
    rs = np.random.RandomState(1)
    samples = []
    for _ in range(160):
        n = rs.randint(2, 5)
        toks = rs.randint(2, vocab, size=n).tolist()
        samples.append({"source_ids": toks, "target_ids": [0] + toks,
                        "label_ids": toks + [1]})

    def reader():
        yield from samples

    tgraph.reset_name_scope()
    model = TorchSeq2Seq(vocab, vocab, embed_dim=24, hidden_dim=32)
    trainer = SGDTrainer(model.cost, Adam(learning_rate=0.01), seed=0, device="cpu")
    feeder = DataFeeder({name: InputSpec("index_seq", vocab, seq_bucket=[8])
                         for name in ("source_ids", "target_ids", "label_ids")})
    trainer.train(rd.batch(reader, 32, drop_last=True), num_passes=30, feeder=feeder)
    res = trainer.test(rd.batch(reader, 32, drop_last=True), feeder)
    assert res["cost"] < 0.35, res

    gen = model.build_generator(beam_size=3, max_len=8)
    src = np.zeros((4, 8), np.int32)
    want = []
    for i, s in enumerate(samples[:4]):
        src[i, :len(s["source_ids"])] = s["source_ids"]
        want.append(s["source_ids"] + [1])
    lengths = np.array([len(s["source_ids"]) for s in samples[:4]], np.int32)
    seqs, _ = gen(trainer.state["params"], trainer.state["states"], src, lengths)
    ok = 0
    for i in range(4):
        top = seqs[i, 0].tolist()
        if 1 in top:
            top = top[:top.index(1) + 1]
        ok += top == want[i]
    assert ok >= 3, f"beam search reproduced {ok}/4: {seqs[:, 0]} vs {want}"
