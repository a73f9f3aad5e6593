"""Sequence-structure layers (counterpart of `paddle_tpu/nn/seq_layers.py`):
`SeqPool` (SequencePoolLayer: sum, average/avg, max, sqrt) over a padded
[B, T, ...] batch, at `agg_level="non-seq"`.

Not ported yet (ROADMAP.md): `agg_level="seq"` over nested sequences,
`stride` windows, and the other layers of the module (first/last instance,
expand, concat, reshape, slice, k-max score)."""

from __future__ import annotations

from typing import List, Optional

import torch

from paddle_tpu_torch.nn.graph import Argument, Context, Layer
from paddle_tpu_torch.ops import sequence as seq_ops


def _seq_view(arg: Argument):
    """(values [B,T,...], lengths [B]): a non-sequence input is a length-1
    sequence (the reference's SequencePoolLayer tolerates NO_SEQUENCE)."""
    if arg.lengths is None:
        v = arg.value[:, None]
        return v, torch.ones((v.shape[0],), dtype=torch.int32, device=v.device)
    return arg.value, arg.lengths


_POOL_FNS = {
    "sum": seq_ops.seq_sum,
    "average": seq_ops.seq_mean,
    "avg": seq_ops.seq_mean,
    "max": seq_ops.seq_max,
    "sqrt": seq_ops.seq_sqrt_pool,
}


class SeqPool(Layer):
    """SequencePoolLayer: pool over time -> [B, D]."""

    type_name = "seq_pool"

    def __init__(self, input: Layer, pool_type: str = "sum", name: Optional[str] = None,
                 agg_level: str = "non-seq", stride: int = -1):
        super().__init__(input, name=name)
        if pool_type not in _POOL_FNS:
            raise ValueError(f"{self.name}: pool_type {pool_type!r} not in {sorted(_POOL_FNS)}")
        self.pool_type = pool_type
        self.agg_level = agg_level or "non-seq"
        self.stride = stride if stride and stride > 0 else -1
        if self.agg_level == "seq":
            raise NotImplementedError(
                f"{self.name}: SeqPool agg_level='seq' (nested sequences) is not "
                "ported yet")
        if self.stride > 0:
            raise NotImplementedError(
                f"{self.name}: SeqPool stride windows are not ported yet")

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        x, lengths = _seq_view(ins[0])
        return Argument(_POOL_FNS[self.pool_type](x, lengths))
