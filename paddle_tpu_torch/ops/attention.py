"""Attention ops (counterpart of `additive_scores`, `additive_attention` and
`dot_product_attention` in `paddle_tpu/ops/attention.py`).

Additive (Bahdanau) attention is plain PyTorch: the JAX package runs it per
decoder step inside a `lax.scan`, with no Pallas kernel. Scaled dot-product
attention dispatches to the fused op (`ops/rnn_kernels.attention_seq_fused`:
the CUDA kernel for CUDA tensors, its plain version for CPU tensors)
wherever the scale is static; the plain body below is the oracle and the
source of the fused op's backward."""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from paddle_tpu_torch.ops import linalg
from paddle_tpu_torch.ops import sequence as seq_ops
from paddle_tpu_torch.ops.rnn_kernels import attention_seq_fused


def additive_scores(
    enc_proj: torch.Tensor,   # [B, T, A] — W_e @ encoder states (precomputed)
    dec_state: torch.Tensor,  # [B, H]
    w_dec: torch.Tensor,      # [H, A]
    v: torch.Tensor,          # [A]
) -> torch.Tensor:
    """v^T tanh(enc_proj + W_d s) -> [B, T]."""
    q = linalg.matmul(dec_state, w_dec)  # [B, A]
    e = torch.tanh(enc_proj + q[:, None, :])
    return torch.einsum("bta,a->bt", e, v)


def additive_attention(
    enc: torch.Tensor,        # [B, T, D] encoder states
    enc_proj: torch.Tensor,   # [B, T, A]
    dec_state: torch.Tensor,  # [B, H]
    w_dec: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (context [B, D], weights [B, T] f32); the masked softmax runs in
    f32 over each row's valid encoder steps."""
    scores = additive_scores(enc_proj, dec_state, w_dec, v)
    weights = seq_ops.seq_softmax(scores, lengths)
    context = torch.einsum("btd,bt->bd", enc, weights)
    return context, weights


def dot_product_attention(
    q: torch.Tensor,                       # [B, Tq, D]
    k: torch.Tensor,                       # [B, Tk, D]
    v: torch.Tensor,                       # [B, Tk, Dv]
    mask: Optional[torch.Tensor] = None,   # [B, Tq, Tk] or [B, 1, Tk], 0/1
    scale: Union[None, float, torch.Tensor] = None,
    fused: Optional[bool] = None,
) -> torch.Tensor:
    """Scaled dot-product attention -> [B, Tq, Dv] in v's dtype; scores are
    kept where mask > 0 and replaced by NEG_INF elsewhere, the softmax is
    f32.

    `fused=None` takes the fused op where `scale` is static (None or a
    Python number), on either device, and the plain body for a tensor
    scale. The kernel tiles D, Dv, Tq and Tk, so it takes every shape: the
    JAX package's `_attn_fuse_ok` VMEM budget (`PADDLE_TPU_FUSED_ATTN_MAX`)
    has no counterpart. `fused=True` takes the fused op (a tensor scale is
    read as a number); `fused=False` runs the plain body."""
    d = q.shape[-1]
    if fused is None:
        fused = scale is None or isinstance(scale, (int, float))
    if fused:
        s = float(scale) if scale is not None else 1.0 / math.sqrt(d)
        m = (torch.ones((q.shape[0], 1, k.shape[1]), dtype=torch.float32, device=q.device)
             if mask is None else mask)
        return attention_seq_fused(q, k, v, m, s)
    if scale is None:
        scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32, device=q.device))
    logits = torch.einsum("bqd,bkd->bqk", q, k)
    if isinstance(scale, torch.Tensor):
        # a tensor scale promotes as a strongly typed jnp scalar does (bf16
        # scores times an f32 scale are f32); a Python number keeps the
        # scores' dtype, as a weakly typed one does
        logits = logits.to(torch.promote_types(logits.dtype, scale.dtype))
    logits = logits * scale
    if mask is not None:
        logits = torch.where(mask > 0, logits, seq_ops.NEG_INF)
    w = torch.softmax(logits.float(), dim=-1).to(v.dtype)
    return torch.einsum("bqk,bkv->bqv", w, v)
