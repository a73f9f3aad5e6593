"""Recurrent layers (counterpart of `paddle_tpu/nn/recurrent.py`), the GRU
the seq2seq encoder uses: `Gru` (grumemory), `simple_gru` (fc(3H) + Gru)
and `bidirectional_gru` (forward and reverse simple_gru, concatenated).

`Gru` computes the reference defaults only (sigmoid gates, tanh candidate),
which is what the fused kernel computes; the JAX layer's other
activations and its named `param_attr` sharing are not ported yet."""

from __future__ import annotations

from typing import List, Optional

from paddle_tpu_torch.nn import init as init_mod
from paddle_tpu_torch.nn.graph import Argument, Context, Layer
from paddle_tpu_torch.nn.layers import Concat, Fc
from paddle_tpu_torch.ops import rnn as rnn_ops


class Gru(Layer):
    """grumemory: the input must be the 3H-wide projection."""

    type_name = "grumemory"

    def __init__(self, input: Layer, size: Optional[int] = None,
                 reverse: bool = False, name: Optional[str] = None):
        super().__init__(input, name=name)
        self.size = size
        self.reverse = reverse

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        arg = ins[0]
        assert arg.is_seq, f"{self.name}: grumemory needs a sequence input"
        proj = arg.value
        hdim = self.size or proj.shape[-1] // 3
        if proj.shape[-1] != 3 * hdim:
            raise ValueError(f"{self.name}: input width {proj.shape[-1]} != 3*size")
        p = rnn_ops.GruParams(
            w_hzr=ctx.param(self, "w_hzr", (hdim, 2 * hdim), init_mod.smart_normal),
            w_hc=ctx.param(self, "w_hc", (hdim, hdim), init_mod.smart_normal),
            bias=ctx.param(self, "b", (3 * hdim,), init_mod.zeros),
        )
        hs, _ = rnn_ops.gru_scan(proj, arg.mask(proj.dtype), p, reverse=self.reverse)
        return Argument(hs, arg.lengths)


def simple_gru(input: Layer, size: int, reverse: bool = False,
               name: str = "gru") -> Layer:
    """fc(3H) + grumemory."""
    proj = Fc(input, 3 * size, act=None, name=f"{name}.input_proj")
    return Gru(proj, size=size, reverse=reverse, name=name)


def bidirectional_gru(input: Layer, size: int, name: str = "bigru") -> Layer:
    fwd = simple_gru(input, size, reverse=False, name=f"{name}.fw")
    bwd = simple_gru(input, size, reverse=True, name=f"{name}.bw")
    return Concat([fwd, bwd], name=f"{name}.cat")
