"""Softmax cross-entropy over large vocabularies (counterpart of
`paddle_tpu/ops/xent.py`).

The JAX package hand-writes the VJP so that no f32 copy of the [N, V]
logits exists under its bf16 policy. The port's logits reach here in f32
under both policies (an f32 bias add promotes a bf16 product), where that
saving does not arise, so autograd of the plain form below is the backward. The
reductions are f32, as in the JAX package: lse = m + log(sum(exp(x - m)))."""

from __future__ import annotations

import torch


def softmax_xent_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example -log softmax(logits)[label] -> f32 [N] (labels int [N])."""
    x32 = logits.float()
    m = x32.amax(dim=-1)
    lse = m + torch.log(torch.exp(x32 - m[..., None]).sum(dim=-1))
    picked = torch.gather(x32, -1, labels.long()[..., None])[..., 0]
    return lse - picked
