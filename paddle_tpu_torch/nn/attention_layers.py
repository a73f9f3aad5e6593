"""`SimpleAttention` (simple_attention, the step of a recurrent group's
attention decoder) and the attention decoder (counterparts of
`paddle_tpu/nn/attention_layers.py`). `AttentionDecoder`: the teacher-forced training path
(`forward`) and the step that beam-search generation drives
(`initial_state`, `step`; `nn/beam_search.py`), on the same parameters.

Step t attends over the encoder with the PREVIOUS hidden state (additive
attention), then runs a GRU step on [emb_t, context_t] (`_step_proj`). The
teacher-forced half of the GRU input projection, emb @ w_in[:Demb], is
hoisted out of the loop as one [B, T, Demb] x [Demb, 3H] product. The loop
over target steps is plain PyTorch: the JAX package runs it as a `lax.scan`
with no Pallas kernel.

No remat: the JAX package checkpoints the scan step so autodiff does not
keep each step's [B, Ts, A] attention tensors; at the reference's width
(B=128, Ts=50, A=512, 50 target steps) those are ~0.7 GB in f32, which an
80 GB card holds, so the port keeps them."""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from paddle_tpu_torch.nn import init as init_mod
from paddle_tpu_torch.nn.graph import Argument, Context, Layer
from paddle_tpu_torch.ops import attention as attn_ops
from paddle_tpu_torch.ops import linalg
from paddle_tpu_torch.ops import rnn as rnn_ops
from paddle_tpu_torch.ops import sequence as seq_ops


class SimpleAttention(Layer):
    """simple_attention (networks.py:1304): additive attention of a decoder
    state [B, H] over an encoder sequence [B, T, D] -> the context [B, D].
    As in the JAX package, the encoder projection is the layer's own
    (`w_enc`), computed from the sequence at every call."""

    type_name = "simple_attention"

    def __init__(self, enc: Layer, dec_state: Layer, attention_size: int = 0,
                 name: Optional[str] = None):
        super().__init__([enc, dec_state], name=name)
        self.attention_size = attention_size

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        enc, dec = ins
        assert enc.is_seq, f"{self.name}: simple_attention needs an encoder sequence"
        d_enc, d_dec = enc.value.shape[-1], dec.value.shape[-1]
        a = self.attention_size or d_dec
        sn = init_mod.smart_normal
        w_enc = ctx.param(self, "w_enc", (d_enc, a), sn)
        w_dec = ctx.param(self, "w_dec", (d_dec, a), sn)
        v = ctx.param(self, "v", (a,), sn)
        enc_proj = linalg.matmul(enc.value, w_enc)
        context, _ = attn_ops.additive_attention(enc.value, enc_proj, dec.value, w_dec, v,
                                                 enc.lengths)
        return Argument(context)


class DecoderParams(NamedTuple):
    w_enc: torch.Tensor   # [De, A] attention encoder projection
    w_dec: torch.Tensor   # [H, A] attention decoder projection
    v: torch.Tensor       # [A]
    w_in: torch.Tensor    # [Demb + De, 3H] GRU input projection
    gru: rnn_ops.GruParams
    w_init: torch.Tensor  # [De, H] initial-state projection


class AttentionDecoder(Layer):
    """inputs: [encoder_seq [B,Ts,De], target_embedding_seq [B,Tt,Demb]]
    output: decoder hidden states [B, Tt, H] (project with Fc for logits)."""

    type_name = "attention_decoder"

    def __init__(self, enc: Layer, target_emb: Layer, size: int,
                 attention_size: int = 0, name: Optional[str] = None):
        super().__init__([enc, target_emb], name=name)
        self.size = size
        self.attention_size = attention_size

    def _params(self, ctx: Context, d_enc: int, d_emb: int) -> DecoderParams:
        h = self.size
        a = self.attention_size or h  # attention width, the hidden one by default
        sn = init_mod.smart_normal
        return DecoderParams(
            w_enc=ctx.param(self, "att.w_enc", (d_enc, a), sn),
            w_dec=ctx.param(self, "att.w_dec", (h, a), sn),
            v=ctx.param(self, "att.v", (a,), sn),
            w_in=ctx.param(self, "w_in", (d_emb + d_enc, 3 * h), sn),
            gru=rnn_ops.GruParams(
                w_hzr=ctx.param(self, "gru.w_hzr", (h, 2 * h), sn),
                w_hc=ctx.param(self, "gru.w_hc", (h, h), sn),
                bias=ctx.param(self, "gru.b", (3 * h,), init_mod.zeros),
            ),
            w_init=ctx.param(self, "w_init", (d_enc, h), sn),
        )

    def initial_state(self, p: DecoderParams, enc_value: torch.Tensor,
                      enc_lengths: torch.Tensor) -> torch.Tensor:
        """h0 = tanh(first encoder step @ W_init): the reference seeds the
        decoder from the encoder's first backward state."""
        return torch.tanh(linalg.matmul(seq_ops.seq_first(enc_value), p.w_init))

    def step(self, p: DecoderParams, enc_value: torch.Tensor, enc_proj: torch.Tensor,
             enc_lengths: torch.Tensor, emb_t: torch.Tensor, h: torch.Tensor
             ) -> torch.Tensor:
        """One decoder step from the embedding of the previous token,
        emb_t [B, Demb] -> the new hidden state [B, H]."""
        d_emb = emb_t.shape[-1]
        proj_emb = linalg.matmul(emb_t, p.w_in[:d_emb])
        return self._step_proj(p, enc_value, enc_proj, enc_lengths, proj_emb, h, d_emb)

    def _step_proj(self, p: DecoderParams, enc_value: torch.Tensor,
                   enc_proj: torch.Tensor, enc_lengths: torch.Tensor,
                   proj_emb_t: torch.Tensor, h: torch.Tensor, d_emb: int
                   ) -> torch.Tensor:
        """One decoder step given the pre-projected embedding input
        proj_emb_t = emb_t @ w_in[:Demb]."""
        context, _ = attn_ops.additive_attention(
            enc_value, enc_proj, h, p.w_dec, p.v, enc_lengths)
        proj = proj_emb_t + linalg.matmul(context, p.w_in[d_emb:])
        return rnn_ops.gru_step(proj, h, p.gru)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        enc, emb = ins
        assert enc.is_seq and emb.is_seq
        d_emb = emb.value.shape[-1]
        p = self._params(ctx, enc.value.shape[-1], d_emb)
        enc_proj = linalg.matmul(enc.value, p.w_enc)
        h = self.initial_state(p, enc.value, enc.lengths)
        mask = emb.mask(h.dtype)
        proj_emb = linalg.matmul(emb.value, p.w_in[:d_emb])
        hs = []
        for t in range(proj_emb.shape[1]):
            h_new = self._step_proj(p, enc.value, enc_proj, enc.lengths, proj_emb[:, t],
                                    h, d_emb)
            m = mask[:, t, None]
            h = m * h_new + (1 - m) * h
            hs.append(h)
        return Argument(torch.stack(hs, dim=1), emb.lengths)
