"""Batched beam-search generation for the attention decoder (counterpart of
`paddle_tpu/nn/beam_search.py`; RecurrentGradientMachine::generateSequence /
beamSearch, RecurrentGradientMachine.h:307/:309).

The encoder's output is projected once and tiled across the beams; each of
the `max_len` steps embeds the beams' last tokens, runs
`AttentionDecoder.step`, projects to the vocabulary and takes an f32
log-softmax, and `nn/beam_core.beam_search_scan` expands and reorders the
beams. Runs eagerly (the JAX package jits it; capturing it as a CUDA graph
is queued in ROADMAP.md)."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from paddle_tpu_torch.nn.attention_layers import AttentionDecoder, DecoderParams
from paddle_tpu_torch.nn.beam_core import beam_search_scan
from paddle_tpu_torch.ops import linalg
from paddle_tpu_torch.ops.rnn import GruParams


@torch.no_grad()
def beam_search(decoder: AttentionDecoder, params: Dict[str, torch.Tensor],
                enc_value: torch.Tensor, enc_lengths: torch.Tensor,
                embed_table: torch.Tensor, w_out: torch.Tensor, b_out: torch.Tensor,
                bos_id: int, eos_id: int, beam_size: int = 4, max_len: int = 50,
                length_penalty: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (sequences [B, K, max_len] int32, scores [B, K]) sorted best first.
    `params` holds the decoder's weights under its layer name."""

    def P(pname: str) -> torch.Tensor:
        return params[f"{decoder.name}.{pname}"]

    dp = DecoderParams(
        w_enc=P("att.w_enc"), w_dec=P("att.w_dec"), v=P("att.v"), w_in=P("w_in"),
        gru=GruParams(w_hzr=P("gru.w_hzr"), w_hc=P("gru.w_hc"), bias=P("gru.b")),
        w_init=P("w_init"),
    )
    b = enc_value.shape[0]
    k = beam_size
    h0 = decoder.initial_state(dp, enc_value, enc_lengths)  # [B, H]
    # project once, then tile across beams -> [B*K, ...]
    enc_proj = linalg.matmul(enc_value, dp.w_enc)
    enc_t = enc_value.repeat_interleave(k, dim=0)
    enc_len_t = enc_lengths.repeat_interleave(k, dim=0)
    enc_proj_t = enc_proj.repeat_interleave(k, dim=0)
    vocab = embed_table.shape[0]

    def step_fn(tokens_flat: torch.Tensor, h_flat: torch.Tensor, t: int):
        emb_t = embed_table[tokens_flat.long()]  # [B*K, Demb]
        h_new = decoder.step(dp, enc_t, enc_proj_t, enc_len_t, emb_t, h_flat)
        logits = linalg.matmul(h_new, w_out) + b_out
        return torch.log_softmax(logits.float(), dim=-1), h_new

    res = beam_search_scan(step_fn, h0.repeat_interleave(k, dim=0), batch=b, vocab=vocab,
                           bos_id=bos_id, eos_id=eos_id, beam_size=k, max_len=max_len,
                           length_penalty=length_penalty)
    return res.history, res.scores
