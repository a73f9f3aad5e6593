"""Cost layers (counterpart of `paddle_tpu/nn/costs.py`): `CostLayer` and
`ClassificationCost`.

A sequence cost sums the per-step costs over the valid steps and divides by
the batch size B (not by the number of valid steps), exactly as the JAX
package's `_masked_mean` does without a sample mask. The padded-batch
sample mask of the JAX package's DataParallel path waits with the parallel
updaters (ROADMAP.md)."""

from __future__ import annotations

from typing import List, Optional

import torch

from paddle_tpu_torch.nn.graph import Argument, Context, Layer
from paddle_tpu_torch.ops import sequence as seq_ops
from paddle_tpu_torch.ops import xent as xent_ops


def _flatten_seq(value: torch.Tensor, lengths: Optional[torch.Tensor]):
    """[B,T,...] + lengths -> flat [(B*T), ...] values and [(B*T)] weight
    mask; non-sequence [B, ...] passes through."""
    if lengths is None:
        return value, None
    b, t = value.shape[0], value.shape[1]
    mask = seq_ops.mask_from_lengths(lengths, t).reshape(-1)
    return value.reshape((b * t,) + tuple(value.shape[2:])), mask


class CostLayer(Layer):
    """Base for costs: sequence flattening, masking and the mean over B."""

    is_cost = True

    def __init__(self, input: Layer, label: Layer, name: Optional[str] = None):
        super().__init__([input, label], name=name)

    def per_example(self, ctx: Context, pred: torch.Tensor,
                    label: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        pred_arg, label_arg = ins
        pred, pmask = _flatten_seq(pred_arg.value, pred_arg.lengths)
        label, _ = _flatten_seq(label_arg.value, label_arg.lengths)
        cost = self.per_example(ctx, pred, label)
        if cost.dim() > 1:
            cost = cost.reshape(cost.shape[0], -1).sum(-1)
        if pmask is not None:
            cost = cost * pmask
        return Argument(cost.sum() / pred_arg.value.shape[0])


class ClassificationCost(CostLayer):
    """Softmax + multi-class cross-entropy from logits (reductions in f32)."""

    type_name = "classification_cost"

    def per_example(self, ctx, pred, label):
        return xent_ops.softmax_xent_with_logits(pred, label.reshape(-1))
