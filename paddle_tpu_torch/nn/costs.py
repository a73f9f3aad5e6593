"""Cost layers (counterpart of `paddle_tpu/nn/costs.py`): `CostLayer`,
`ClassificationCost`, `SoftBinaryCrossEntropy`, `SquareError`,
`CrossEntropyWithSelfNorm`, `HuberRegression`, `HuberTwoClassification`,
`RankCost`, `MultiBinaryLabelCrossEntropy`, `SumCost` and `SmoothL1`.

A cost layer computes a per-example cost, times the optional per-example
`weight` input, and returns `coeff` times its sum over the batch divided by
the batch size B. A sequence cost sums the per-step costs over the valid
steps and divides by B too (not by the number of valid steps), exactly as
the JAX package's `_masked_mean` does; a sequence prediction against one
label per sequence applies that label to every step.

`_masked_mean` honours the padded batch's row mask (`Context.sample_mask`):
padded rows weigh 0 and the denominator is the global real row count
(`Context.sample_count`). Under a mesh the batch is this rank's rows, and
the denominator is the global batch's, so the ranks' costs (and
gradients) sum to the unsharded batch's. An unpadded batch on one rank
keeps the plain sum / B, bit for bit."""

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


def _masked_mean(ctx: Context, cost: torch.Tensor, batch_rows: int,
                 timesteps: Optional[int] = None) -> torch.Tensor:
    """Sum of a per-example cost over the global batch's real rows: the
    counterpart of `paddle_tpu/nn/costs.py` `_masked_mean`. Without a mask,
    sum / (B x world); with one, padded rows weigh 0 and the denominator is
    the real row count."""
    smask = getattr(ctx, "sample_mask", None)
    if smask is None:
        return cost.sum() / (batch_rows * getattr(ctx, "world", 1))
    w = smask.to(cost.dtype).reshape(-1)
    if timesteps is not None:  # sequence costs flatten to [(B*T)]
        w = w.repeat_interleave(timesteps)
    count = getattr(ctx, "sample_count", None)
    count = count if count is not None else smask.float().sum()
    return (cost * w).sum() / torch.clamp(count, min=1.0)


def _dense_label(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Regression costs against an id label slot: one-hot is the dense view
    of ids (an id outside [0, C) is a row of zeros, as `jax.nn.one_hot`)."""
    if label.dim() == pred.dim() - 1:
        classes = torch.arange(pred.shape[-1], device=label.device)
        return (label.long()[..., None] == classes).float()
    return label.float()


class CostLayer(Layer):
    """Base for costs: sequence flattening, the per-sequence label
    broadcast, the per-example weight and the mean over B."""

    is_cost = True

    def __init__(self, input: Layer, label: Layer, weight: Optional[Layer] = None,
                 name: Optional[str] = None, coeff: float = 1.0):
        super().__init__([input, label] + ([weight] if weight is not None else []),
                         name=name)
        self.coeff = coeff
        self.has_weight = weight is not None

    def per_example(self, ctx: Context, pred: torch.Tensor,
                    label: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        pred_arg, label_arg = ins[0], ins[1]
        if pred_arg.lengths is not None and label_arg.lengths is None:
            # one label per sequence applies to every (valid) step
            t = pred_arg.value.shape[1]
            lv = label_arg.value.reshape(label_arg.value.shape[0], -1)
            label_arg = Argument(lv[:, :1].expand(lv.shape[0], t), pred_arg.lengths)
        pred, pmask = _flatten_seq(pred_arg.value, pred_arg.lengths)
        label, _ = _flatten_seq(label_arg.value, label_arg.lengths)
        cost = self.per_example(ctx, pred, label)
        if cost.dim() > 1:
            cost = cost.reshape(cost.shape[0], -1).sum(-1)
        if pmask is not None:
            cost = cost * pmask
        if self.has_weight:
            cost = cost * ins[2].value.reshape(-1)
        t = pred_arg.value.shape[1] if pred_arg.lengths is not None else None
        return Argument(self.coeff * _masked_mean(ctx, cost, pred_arg.value.shape[0], t))


class ClassificationCost(CostLayer):
    """Softmax + multi-class cross-entropy. From logits by default
    (reductions in f32); `from_logits=False` takes probabilities and
    computes -log(max(p, 1e-10))[label]."""

    type_name = "classification_cost"

    def __init__(self, input: Layer, label: Layer, weight: Optional[Layer] = None,
                 name: Optional[str] = None, coeff: float = 1.0, from_logits: bool = True):
        super().__init__(input, label, weight, name, coeff)
        self.from_logits = from_logits

    def per_example(self, ctx, pred, label):
        label = label.reshape(-1).long()
        if self.from_logits:
            return xent_ops.softmax_xent_with_logits(pred, label)
        logp = torch.log(pred.float().clamp(min=1e-10))
        return -torch.gather(logp, -1, label[:, None])[:, 0]


class SoftBinaryCrossEntropy(CostLayer):
    """Per-dimension binary cross-entropy with soft targets; the
    probabilities are clipped to [1e-7, 1 - 1e-7] in f32."""

    type_name = "soft_binary_class_cross_entropy"

    def per_example(self, ctx, pred, label):
        p = pred.float().clamp(1e-7, 1 - 1e-7)
        y = label.float()
        return -(y * torch.log(p) + (1 - y) * torch.log(1 - p)).sum(-1)


class SquareError(CostLayer):
    """Sum-of-squares error: 0.5 * ||pred - label||^2."""

    type_name = "square_error"

    def per_example(self, ctx, pred, label):
        d = pred.float() - _dense_label(pred, label)
        return 0.5 * (d * d).sum(-1)


class CrossEntropyWithSelfNorm(CostLayer):
    """Cross-entropy + alpha * log(Z)^2 (the self-normalising softmax)."""

    type_name = "cross_entropy_with_selfnorm"

    def __init__(self, input: Layer, label: Layer, weight: Optional[Layer] = None,
                 name: Optional[str] = None, coeff: float = 1.0,
                 softmax_selfnorm_alpha: float = 0.1):
        super().__init__(input, label, weight, name, coeff)
        self.alpha = softmax_selfnorm_alpha

    def per_example(self, ctx, pred, label):
        logits = pred.float()
        logz = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, label.reshape(-1).long()[:, None])[:, 0]
        return (logz - picked) + self.alpha * logz * logz


class HuberRegression(CostLayer):
    """Huber regression loss with threshold `delta`."""

    type_name = "huber_regression_cost"

    def __init__(self, input: Layer, label: Layer, weight: Optional[Layer] = None,
                 name: Optional[str] = None, coeff: float = 1.0, delta: float = 1.0):
        super().__init__(input, label, weight, name, coeff)
        self.delta = delta

    def per_example(self, ctx, pred, label):
        d = (pred.float() - _dense_label(pred, label)).abs()
        quad = d.clamp(max=self.delta)
        return (0.5 * quad * quad + self.delta * (d - quad)).sum(-1)


class HuberTwoClassification(CostLayer):
    """Huber two-class loss: labels {0, 1} as y in {-1, 1}, z = pred * y;
    -4z below -1, (1 - z)^2 below 1, else 0."""

    type_name = "huber_classification_cost"

    def per_example(self, ctx, pred, label):
        y = 2.0 * label.float().reshape(-1) - 1.0
        z = pred.float().reshape(-1) * y
        return torch.where(z < -1, -4 * z, torch.where(z < 1, (1 - z) ** 2, 0.0))


class RankCost(Layer):
    """Pairwise ranking cost: inputs (left score, right score, label in
    [0, 1]), cost log(1 + e^o) - t * o with o = left - right."""

    type_name = "rank_cost"
    is_cost = True

    def __init__(self, left: Layer, right: Layer, label: Layer,
                 weight: Optional[Layer] = None, name: Optional[str] = None,
                 coeff: float = 1.0):
        super().__init__([left, right, label] + ([weight] if weight is not None else []),
                         name=name)
        self.coeff = coeff
        self.has_weight = weight is not None

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        o = (ins[0].value - ins[1].value).float().reshape(-1)
        t = ins[2].value.float().reshape(-1)
        cost = torch.logaddexp(o, torch.zeros_like(o)) - t * o
        if self.has_weight:
            cost = cost * ins[3].value.reshape(-1)
        return Argument(self.coeff * _masked_mean(ctx, cost, cost.shape[0]))


class MultiBinaryLabelCrossEntropy(CostLayer):
    """Sigmoid cross-entropy on logits against multi-hot labels."""

    type_name = "multi_binary_label_cross_entropy"

    def per_example(self, ctx, pred, label):
        x = pred.float()
        y = _dense_label(pred, label)
        return (x.clamp(min=0) - x * y + torch.log1p(torch.exp(-x.abs()))).sum(-1)


class SumCost(Layer):
    """The cost is the sum of the input's activations over B."""

    type_name = "sum_cost"
    is_cost = True

    def __init__(self, input: Layer, name: Optional[str] = None, coeff: float = 1.0):
        super().__init__(input, name=name)
        self.coeff = coeff

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        v = ins[0].value
        if getattr(ctx, "sample_mask", None) is None:
            return Argument(self.coeff * v.sum() / (v.shape[0] * getattr(ctx, "world", 1)))
        per_row = v.reshape(v.shape[0], -1).sum(-1)
        return Argument(self.coeff * _masked_mean(ctx, per_row, v.shape[0]))


class SmoothL1(CostLayer):
    """Smooth L1: 0.5 d^2 below 1, d - 0.5 above, summed over features."""

    type_name = "smooth_l1_cost"

    def per_example(self, ctx, pred, label):
        d = (pred.float() - _dense_label(pred, label)).abs()
        return torch.where(d < 1.0, 0.5 * d * d, d - 0.5).sum(-1)
