"""Additive (Bahdanau) attention (counterpart of `additive_scores` and
`additive_attention` in `paddle_tpu/ops/attention.py`). Plain PyTorch: the
JAX package runs this per decoder step inside a `lax.scan`, with no Pallas
kernel."""

from __future__ import annotations

from typing import Tuple

import torch

from paddle_tpu_torch.ops import linalg
from paddle_tpu_torch.ops import sequence as seq_ops


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
