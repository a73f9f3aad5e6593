"""Sequence ops over padded [B, T, ...] batches with per-example lengths
(counterpart of `paddle_tpu/ops/sequence.py`): masks, the masked softmax,
the pooling reductions of SequencePoolLayer, the first/last instance
picks, the context projection's sliding window and the expansion of a
batch across time."""

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


def seq_sum(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Sum-pool [B, T, D] -> [B, D] over the valid steps."""
    m = mask_from_lengths(lengths, x.shape[1], x.dtype)
    return torch.einsum("btd,bt->bd", x, m)


def seq_mean(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Average over the valid steps (a length-0 row divides by 1)."""
    denom = lengths.clamp(min=1).to(x.dtype)[:, None]
    return seq_sum(x, lengths) / denom


def seq_max(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Max over the valid steps; padded steps read NEG_INF. `amax` splits
    the gradient evenly between ties, as jnp.max's does."""
    m = mask_from_lengths(lengths, x.shape[1], torch.bool)[:, :, None]
    return torch.where(m, x, NEG_INF).amax(dim=1)


def seq_sqrt_pool(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """sum / sqrt(len) (SequencePoolLayer 'sqrt' mode)."""
    denom = torch.sqrt(lengths.clamp(min=1).to(x.dtype))[:, None]
    return seq_sum(x, lengths) / denom


def seq_first(x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """First step of each sequence, [B, T, ...] -> [B, ...]."""
    return x[:, 0]


def seq_last(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Last valid step of each sequence, [B, T, ...] -> [B, ...]. The index
    is clamped into [0, T) as XLA clamps the JAX package's gather."""
    idx = (lengths.long() - 1).clamp(0, x.shape[1] - 1)
    return x[torch.arange(x.shape[0], device=x.device), idx]


def context_projection(x: torch.Tensor, lengths: torch.Tensor, context_start: int,
                       context_len: int) -> torch.Tensor:
    """Sliding-window concat of neighbouring steps (ContextProjection):
    [B, T, D] -> [B, T, context_len * D], column block k holding step
    t + context_start + k; steps outside [0, length) read zero."""
    t = x.shape[1]
    xm = x * mask_from_lengths(lengths, t, x.dtype)[:, :, None]
    cols = []
    for offset in range(context_start, context_start + context_len):
        if offset == 0:
            cols.append(xm)
        elif offset < 0:
            cols.append(torch.nn.functional.pad(xm, (0, 0, -offset, 0))[:, :t])
        else:
            cols.append(torch.nn.functional.pad(xm, (0, 0, 0, offset))[:, offset:])
    return torch.cat(cols, dim=-1)


def expand_to_seq(x: torch.Tensor, like_lengths: Optional[torch.Tensor],
                  max_len: int) -> torch.Tensor:
    """[B, D] -> [B, T, D] broadcast across time (ExpandLayer)."""
    return x[:, None, :].expand(x.shape[0], max_len, x.shape[1])
