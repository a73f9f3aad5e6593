"""Core layers (counterpart of `paddle_tpu/nn/layers.py`), the ones the
seq2seq path uses: Data, Fc, Embedding, Concat."""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Union

import torch

from paddle_tpu_torch.nn import activations as act_mod
from paddle_tpu_torch.nn import init as init_mod
from paddle_tpu_torch.nn.graph import Argument, Context, Layer, ParamAttr
from paddle_tpu_torch.ops import linalg


def _attr(a: Any) -> Optional[ParamAttr]:
    """A ParamAttr from None, a ParamAttr, a bool (a bias on/off toggle,
    which carries no attributes), a dict of its fields, or a list of those
    (one per input)."""
    if a is None or isinstance(a, ParamAttr):
        return a
    if isinstance(a, bool):
        return None
    if isinstance(a, (list, tuple)):
        return [_attr(x) for x in a]
    return ParamAttr(**a)


class Data(Layer):
    """Input slot. `shape` excludes the batch dim; sequence inputs carry
    `<name>.lengths` in the batch dict."""

    type_name = "data"

    def __init__(self, name: str, shape: Sequence[int] = (), is_seq: bool = False):
        super().__init__(None, name=name)
        self.shape = tuple(shape)
        self.is_seq = is_seq

    def forward(self, ctx, ins):  # data layers are fed by Network._run
        raise AssertionError("data layer forward should not be called")


class Fc(Layer):
    """Fully connected. Several inputs each get their own weight (`w.0`,
    `w.1`, ...; `param_attr` may be a list, one per input), summed before
    bias and activation. Sequence inputs apply per step; a flat input mixed
    with sequence inputs broadcasts over time."""

    type_name = "fc"

    def __init__(self, input: Union[Layer, Sequence[Layer]], size: int,
                 act: act_mod.ActLike = "tanh", bias: bool = True,
                 param_attr: Union[None, ParamAttr, List[Optional[ParamAttr]]] = None,
                 bias_attr: Optional[ParamAttr] = None, name: Optional[str] = None):
        super().__init__(input, name=name)
        self.size = size
        self.act = act
        self.bias = bias
        self.param_attr = param_attr
        self.bias_attr = bias_attr

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        total = None
        any_seq = any(a.is_seq for a in ins)
        for i, arg in enumerate(ins):
            x = arg.value
            suffix = "" if len(ins) == 1 else f".{i}"
            pa = self.param_attr
            if isinstance(pa, list):
                pa = pa[i] if i < len(pa) else None
            w = ctx.param(self, "w" + suffix, (x.shape[-1], self.size),
                          init_mod.smart_normal, pa)
            y = linalg.matmul(x, w)
            if any_seq and y.dim() == 2:
                y = y[:, None]
            total = y if total is None else total + y
        if self.bias:
            total = total + ctx.param(self, "b", (self.size,), init_mod.zeros,
                                      self.bias_attr)
        return ins[0].with_value(act_mod.apply(self.act, total))


class Embedding(Layer):
    """Embedding lookup: integer ids [B] or [B, T] -> rows of the table."""

    type_name = "embedding"

    def __init__(self, input: Layer, size: int, vocab_size: int,
                 param_attr: Optional[ParamAttr] = None, name: Optional[str] = None):
        super().__init__(input, name=name)
        self.size = size
        self.vocab_size = vocab_size
        self.param_attr = param_attr

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        table = ctx.param(self, "w", (self.vocab_size, self.size),
                          init_mod.smart_normal, self.param_attr)
        return ins[0].with_value(table[ins[0].value.long()])


class Concat(Layer):
    """Feature-axis concat of N inputs."""

    type_name = "concat"

    def __init__(self, input: Sequence[Layer], name: Optional[str] = None):
        super().__init__(input, name=name)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        return ins[0].with_value(torch.cat([a.value for a in ins], dim=-1))
