"""Seq2seq NMT with attention (counterpart of `paddle_tpu/models/seq2seq.py`),
the teacher-forced training graph: source embedding -> bi-GRU encoder (the
fused GRU kernels) -> attention-GRU decoder over the target embedding ->
vocabulary projection -> masked cross-entropy.

Generation (`build_generator`, beam search) is not ported yet
(ROADMAP.md)."""

from __future__ import annotations

import dataclasses

from paddle_tpu_torch.nn import costs as C
from paddle_tpu_torch.nn import layers as L
from paddle_tpu_torch.nn.attention_layers import AttentionDecoder
from paddle_tpu_torch.nn.graph import ParamAttr
from paddle_tpu_torch.nn.recurrent import bidirectional_gru


@dataclasses.dataclass
class Seq2SeqModel:
    src_vocab: int
    trg_vocab: int
    embed_dim: int = 512
    hidden_dim: int = 512

    def __post_init__(self):
        self.src = L.Data("source_ids", shape=(self.src_vocab,), is_seq=True)
        self.trg = L.Data("target_ids", shape=(self.trg_vocab,), is_seq=True)
        self.label = L.Data("label_ids", shape=(self.trg_vocab,), is_seq=True)
        src_emb = L.Embedding(self.src, self.embed_dim, vocab_size=self.src_vocab,
                              name="src_emb")
        self.encoder = bidirectional_gru(src_emb, self.hidden_dim, name="enc")
        self.trg_emb_layer = L.Embedding(
            self.trg, self.embed_dim, vocab_size=self.trg_vocab,
            param_attr=ParamAttr(name="trg_emb_table"), name="trg_emb")
        self.decoder = AttentionDecoder(self.encoder, self.trg_emb_layer,
                                        self.hidden_dim, name="decoder")
        self.logits = L.Fc(self.decoder, self.trg_vocab, act=None,
                           param_attr=ParamAttr(name="out_w"),
                           bias_attr=ParamAttr(name="out_b"), name="out")
        self.cost = C.ClassificationCost(self.logits, self.label, name="cost")


def seq2seq(src_vocab: int = 30000, trg_vocab: int = 30000, embed_dim: int = 512,
            hidden_dim: int = 512) -> Seq2SeqModel:
    return Seq2SeqModel(src_vocab, trg_vocab, embed_dim, hidden_dim)
