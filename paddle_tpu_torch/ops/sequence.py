"""Sequence ops over padded [B, T, ...] batches with per-example lengths
(counterpart of `paddle_tpu/ops/sequence.py`, the parts the seq2seq
training path uses)."""

from __future__ import annotations

from typing import Optional

import torch

# masked scores get NEG_INF, never -inf: a fully masked row degrades to
# uniform weights instead of NaN, as in the JAX package
NEG_INF = -1e9


def mask_from_lengths(lengths: torch.Tensor, max_len: int,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B] lengths -> [B, T] validity mask."""
    steps = torch.arange(max_len, device=lengths.device)
    return (steps[None, :] < lengths[:, None]).to(dtype)


def seq_softmax(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Softmax over the valid steps of [B, T] scores, in f32, then times the
    mask (so padded steps weigh exactly 0)."""
    m = mask_from_lengths(lengths, x.shape[1], torch.bool)
    x = torch.where(m, x, NEG_INF).float()
    return torch.softmax(x, dim=1) * m.to(x.dtype)


def seq_first(x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """First step of each sequence, [B, T, ...] -> [B, ...]."""
    return x[:, 0]
