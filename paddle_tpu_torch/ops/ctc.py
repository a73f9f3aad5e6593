"""Connectionist Temporal Classification (counterpart of
`paddle_tpu/ops/ctc.py`): the loss and the best-path decode.

The forward is the JAX package's alpha recursion in log space over the
blank-extended label row [blank, y1, blank, y2, ..., blank] (S = 2L + 1
states), a loop over frames 1 .. T-1 with T the padded length: a static
count, rows past their own last frame frozen with `torch.where`, so the
loss reads nothing back to the host and is captured whole in the training
step's CUDA graph. The backward is autograd of this forward.

`torch.nn.functional.ctc_loss` is not used: its CUDA path copies the
lengths to the host (no capture) and its reductions differ; `chip_smoke.py`
holds this loss against it as an independent check only."""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def _logadd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log(e^a + e^b), NaN-free under autograd: where both terms are at
    -1e30 the sum of exps is 0 and its log would give a NaN cotangent that
    a later `where` cannot stop, so the sum is clamped (exact otherwise,
    since the finite branch's sum is >= 1) and the result reset to -1e30."""
    mx = torch.maximum(a, b)
    dead = mx <= _NEG_INF
    mx_safe = torch.where(dead, 0.0, mx)
    ssum = torch.exp(a - mx_safe) + torch.exp(b - mx_safe)
    out = mx_safe + torch.log(ssum.clamp(min=1e-30))
    return torch.where(dead, _NEG_INF, out)


def ctc_loss(logits: torch.Tensor, logit_lengths: torch.Tensor, labels: torch.Tensor,
             label_lengths: torch.Tensor, blank: int = 0,
             norm_by_times: bool = False) -> torch.Tensor:
    """Per-example negative log-likelihood of the label sequences -> f32 [B].

    logits [B, T, C] unnormalised scores; logit_lengths [B] valid frames;
    labels [B, L] ids padded with anything; label_lengths [B]; `blank` the
    blank id; `norm_by_times` divides each NLL by its frame count."""
    b, t, _ = logits.shape
    dev = logits.device
    l = labels.shape[1]
    s = 2 * l + 1
    logp = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    label_lengths = label_lengths.long()

    idx = torch.arange(s, device=dev)[None, :]
    odd = idx % 2 == 1
    # blank-extended row: blank at even states, label (idx - 1) / 2 at odd
    ext = torch.where(odd, labels[:, ((idx[0] - 1) // 2).clamp(min=0)], blank)
    valid_s = idx < (2 * label_lengths[:, None] + 1)
    # the skip s-2 -> s where ext[s] is a label other than ext[s-2]
    ext_shift2 = torch.cat([torch.full((b, 2), -1, dtype=ext.dtype, device=dev),
                            ext[:, :-2]], dim=1)
    can_skip = odd & (ext != ext_shift2)

    # emission log-probs of each extended state: [B, T, S]; ids are clamped
    # into [0, C) as XLA clamps the JAX package's gather
    ext_c = ext.clamp(0, logp.shape[-1] - 1)
    emit = torch.gather(logp, 2, ext_c[:, None, :].expand(b, t, s))

    alpha = torch.where(idx == 0, emit[:, 0, :1], _NEG_INF)
    if s > 1:
        alpha = torch.where((idx == 1) & (label_lengths[:, None] > 0),
                            emit[:, 0, 1:2], alpha)
    alpha = torch.where(valid_s, alpha, _NEG_INF)
    neg1 = torch.full((b, 1), _NEG_INF, device=dev)
    neg2 = torch.full((b, 2), _NEG_INF, device=dev)
    active = torch.arange(t, device=dev)[None, :] < logit_lengths[:, None]
    for ti in range(1, t):
        prev1 = torch.cat([neg1, alpha[:, :-1]], dim=1)
        prev2 = torch.cat([neg2, alpha[:, :-2]], dim=1)
        acc = _logadd(alpha, prev1)
        acc = _logadd(acc, torch.where(can_skip, prev2, _NEG_INF))
        new = torch.where(valid_s, acc + emit[:, ti], _NEG_INF)
        # frozen past each row's last frame so the end read is stable
        alpha = torch.where(active[:, ti, None], new, alpha)

    end = 2 * label_lengths  # the final blank
    a_end = torch.gather(alpha, 1, end[:, None])[:, 0]
    a_last = torch.gather(alpha, 1, (end - 1).clamp(min=0)[:, None])[:, 0]
    a_last = torch.where(label_lengths > 0, a_last, _NEG_INF)
    nll = -_logadd(a_end, a_last)
    if norm_by_times:
        nll = nll / logit_lengths.to(nll.dtype).clamp(min=1.0)
    return nll


def ctc_greedy_decode(logits: torch.Tensor, logit_lengths: torch.Tensor,
                      blank: int = 0) -> torch.Tensor:
    """Best-path decode: argmax a frame, collapse repeats, drop blanks ->
    [B, T] ids left-packed and padded with -1 (int32, as the JAX
    package's). The kept ids land at their cumsum positions; the dropped
    ones go to a spare column T, which is cut off."""
    ids = logits.argmax(dim=-1)  # [B, T]
    b, t = ids.shape
    valid = torch.arange(t, device=ids.device)[None, :] < logit_lengths[:, None]
    prev = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], dim=1)
    keep = valid & (ids != blank) & (ids != prev)
    pos = torch.cumsum(keep.long(), dim=1) - 1
    out = torch.full((b, t + 1), -1, dtype=ids.dtype, device=ids.device)
    out.scatter_(1, torch.where(keep, pos, t), torch.where(keep, ids, -1))
    return out[:, :t].to(torch.int32)
