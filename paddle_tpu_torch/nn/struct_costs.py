"""Structured-prediction costs (counterpart of `paddle_tpu/nn/struct_costs.py`):
`CTCCost`, `CRFCost` and `CRFDecoding`, over `ops/ctc.py` and `ops/crf.py`.

Each cost is the mean of its per-example vector over the batch, as the JAX
package's `_mean_over_examples` is without a sample mask; the padded-batch
sample mask waits with the parallel updaters (ROADMAP.md §1 item 8).
Not ported yet (ROADMAP.md §1 item 6): NCE, hierarchical sigmoid, lambda
rank and cross-entropy over beams."""

from __future__ import annotations

from typing import Any, List, Optional

import torch

from paddle_tpu_torch.nn import init as init_mod
from paddle_tpu_torch.nn.graph import Argument, Context, Layer
from paddle_tpu_torch.nn.layers import _attr
from paddle_tpu_torch.ops import crf as crf_ops
from paddle_tpu_torch.ops import ctc as ctc_ops


def _mean_over_examples(per_sample: torch.Tensor) -> torch.Tensor:
    return per_sample.mean()


class CTCCost(Layer):
    """CTC negative log-likelihood. Inputs (logits [B, T, C], labels
    [B, L]), both sequences with lengths; labels are fed as
    `Data(shape=(), is_seq=True)`. `size` (the alphabet with the blank) is
    the config surface's value and not read."""

    type_name = "ctc"
    is_cost = True

    def __init__(self, input: Layer, label: Layer, blank: int = 0,
                 norm_by_times: bool = False, size: Optional[int] = None,
                 name: Optional[str] = None, coeff: float = 1.0):
        super().__init__([input, label], name=name)
        self.blank = blank
        self.norm_by_times = norm_by_times
        self.size = size
        self.coeff = coeff

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        logits, labels = ins
        if not (logits.is_seq and labels.is_seq):
            raise ValueError(f"{self.name}: ctc needs sequence inputs")
        nll = ctc_ops.ctc_loss(logits.value, logits.lengths, labels.value,
                               labels.lengths, blank=self.blank,
                               norm_by_times=self.norm_by_times)
        return Argument(self.coeff * _mean_over_examples(nll))


class CRFCost(Layer):
    """Linear-chain CRF negative log-likelihood over the packed (C+2, C)
    weight `w` (row 0 start, row 1 end, rows 2.. transitions)."""

    type_name = "crf"
    is_cost = True

    def __init__(self, input: Layer, label: Layer, size: Optional[int] = None,
                 param_attr: Any = None, name: Optional[str] = None, coeff: float = 1.0):
        super().__init__([input, label], name=name)
        self.size = size
        self.param_attr = _attr(param_attr)
        self.coeff = coeff

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        emit, labels = ins
        if not emit.is_seq:
            raise ValueError(f"{self.name}: crf needs a sequence input")
        c = self.size or emit.value.shape[-1]
        w = ctx.param(self, "w", (c + 2, c), init_mod.smart_normal, self.param_attr)
        nll = crf_ops.crf_nll(emit.value, emit.lengths, labels.value, w)
        return Argument(self.coeff * _mean_over_examples(nll))


class CRFDecoding(Layer):
    """Viterbi decode over the CRF weight (shared by `param_attr` name):
    the best tags [B, T], or with a label input the per-step error
    indicators (1.0 where the decoded tag is not the gold one)."""

    type_name = "crf_decoding"

    def __init__(self, input: Layer, size: Optional[int] = None,
                 label: Optional[Layer] = None, param_attr: Any = None,
                 name: Optional[str] = None):
        super().__init__([input] + ([label] if label is not None else []), name=name)
        self.size = size
        self.param_attr = _attr(param_attr)
        self.has_label = label is not None

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        emit = ins[0]
        c = self.size or emit.value.shape[-1]
        w = ctx.param(self, "w", (c + 2, c), init_mod.smart_normal, self.param_attr)
        tags = crf_ops.crf_decode(emit.value, emit.lengths, w)
        if self.has_label:
            err = (tags != ins[1].value.to(tags.dtype)).float()
            return Argument(err, emit.lengths)
        return Argument(tags, emit.lengths)
