"""Linear-chain CRF (counterpart of `paddle_tpu/ops/crf.py`): the negative
log-likelihood and the Viterbi decode.

The start, end and transition weights are packed into one (C+2, C)
parameter, the JAX package's layout: row 0 start weights a, row 1 end
weights b, rows 2.. the transitions w[from, to]. Both the partition
function and Viterbi are loops over frames 1 .. T-1 with T the padded
length, rows past their own length frozen with `torch.where`, and the
backtrace a static reverse loop: nothing is read back to the host, so
both are captured whole in the training step's CUDA graph. The gradient
is autograd of the forward."""

from __future__ import annotations

from typing import Tuple

import torch


def _unpack(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(C+2, C) packed weights -> (start [C], end [C], trans [C, C])."""
    return w[0], w[1], w[2:]


def crf_nll(emissions: torch.Tensor, lengths: torch.Tensor, labels: torch.Tensor,
            w: torch.Tensor) -> torch.Tensor:
    """Per-example negative log-likelihood -> f32 [B].

    emissions [B, T, C] unnormalised scores; lengths [B] valid steps;
    labels [B, T] gold tag ids (padding ignored); w [C+2, C] packed."""
    a, b_w, trans = _unpack(w)
    bsz, t, c = emissions.shape
    emissions = emissions.float()
    # padded labels are read clamped into [0, C) and masked out below
    labels = labels.long().clamp(0, c - 1)
    lengths = lengths.long()
    steps = torch.arange(t, device=emissions.device)

    # the gold path's score
    lab_emit = torch.gather(emissions, 2, labels[:, :, None])[..., 0]
    valid = steps[None, :] < lengths[:, None]
    emit_score = torch.where(valid, lab_emit, 0.0).sum(1)
    trans_steps = trans[labels[:, :-1], labels[:, 1:]]  # [B, T-1]
    tvalid = steps[None, 1:] < lengths[:, None]
    trans_score = torch.where(tvalid, trans_steps, 0.0).sum(1)
    last_lab = torch.gather(labels, 1, (lengths - 1).clamp(min=0)[:, None])[:, 0]
    path = emit_score + trans_score + a[labels[:, 0]] + b_w[last_lab]

    # the partition function (forward algorithm)
    alpha = a[None, :] + emissions[:, 0]
    for ti in range(1, t):
        new = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) + emissions[:, ti]
        alpha = torch.where(valid[:, ti, None], new, alpha)
    log_z = torch.logsumexp(alpha + b_w[None, :], dim=1)
    return log_z - path


def crf_decode(emissions: torch.Tensor, lengths: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """Viterbi decode -> [B, T] int32 best tags; steps past a row's length
    repeat its last tag (mask them with the lengths downstream)."""
    a, b_w, trans = _unpack(w)
    bsz, t, c = emissions.shape
    emissions = emissions.float()
    dev = emissions.device
    active = torch.arange(t, device=dev)[None, :] < lengths[:, None]
    own = torch.arange(c, device=dev)[None, :]
    delta = a[None, :] + emissions[:, 0]
    backptrs = []
    for ti in range(1, t):
        scores = delta[:, :, None] + trans[None]  # [B, from, to]
        best, best_prev = scores.max(dim=1)
        on = active[:, ti, None]
        delta = torch.where(on, best + emissions[:, ti], delta)
        # frozen frames point back at themselves so the backtrace passes
        backptrs.append(torch.where(on, best_prev, own))
    tag = (delta + b_w[None, :]).argmax(dim=1)
    tags = [tag]
    for bp in reversed(backptrs):
        tag = torch.gather(bp, 1, tag[:, None])[:, 0]
        tags.append(tag)
    return torch.stack(tags[::-1], dim=1).to(torch.int32)
