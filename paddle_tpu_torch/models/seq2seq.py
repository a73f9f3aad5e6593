"""Seq2seq NMT with attention (counterpart of `paddle_tpu/models/seq2seq.py`):
the teacher-forced training graph — source embedding -> bi-GRU encoder (the
fused GRU kernels) -> attention-GRU decoder over the target embedding ->
vocabulary projection -> masked cross-entropy — and generation,
`build_generator`: the encoder (its GRU kernels' forwards), then beam search
over the decoder's steps (`nn/beam_search.py`) from `bos_id` until
`eos_id`."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from paddle_tpu_torch.nn import costs as C
from paddle_tpu_torch.nn import layers as L
from paddle_tpu_torch.nn.attention_layers import AttentionDecoder
from paddle_tpu_torch.nn.beam_search import beam_search
from paddle_tpu_torch.nn.graph import Network, ParamAttr
from paddle_tpu_torch.nn.recurrent import bidirectional_gru


@dataclasses.dataclass
class Seq2SeqModel:
    src_vocab: int
    trg_vocab: int
    embed_dim: int = 512
    hidden_dim: int = 512
    bos_id: int = 0
    eos_id: int = 1

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

    # -- generation ----------------------------------------------------------
    def build_generator(self, beam_size: int = 4, max_len: int = 50):
        """-> fn(params, states, src_ids, src_lengths) -> (sequences
        [B, K, max_len] int32, scores [B, K] f32), beams best first, on
        the parameters' device (ids and lengths may be arrays or
        tensors)."""
        enc_net = Network(self.encoder)

        @torch.no_grad()
        def generate(params: Dict[str, torch.Tensor],
                     states: Optional[Dict[str, torch.Tensor]], src_ids, src_lengths):
            dev = params["trg_emb_table"].device
            batch = {"source_ids": _on(src_ids, dev),
                     "source_ids.lengths": _on(src_lengths, dev)}
            outs = enc_net.apply(params, batch, train=False)
            enc = outs[self.encoder.name]
            return beam_search(self.decoder, params, enc.value, enc.lengths,
                               params["trg_emb_table"], params["out_w"], params["out_b"],
                               bos_id=self.bos_id, eos_id=self.eos_id,
                               beam_size=beam_size, max_len=max_len)

        return generate


def _on(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x)).to(device)


def seq2seq(src_vocab: int = 30000, trg_vocab: int = 30000, embed_dim: int = 512,
            hidden_dim: int = 512) -> Seq2SeqModel:
    return Seq2SeqModel(src_vocab, trg_vocab, embed_dim, hidden_dim)
