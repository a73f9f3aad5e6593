"""Recurrent layers (counterpart of `paddle_tpu/nn/recurrent.py`): `Lstm`
(lstmemory), `simple_lstm` (fc(4H) + Lstm) and `bidirectional_lstm`;
`Gru` (grumemory), `simple_gru` (fc(3H) + Gru) and `bidirectional_gru`
(forward and reverse directions, concatenated).

`Lstm` takes the JAX layer's options (activations, peepholes, param and
bias attributes); with the defaults and `use_peephole=False` it runs the
fused LSTM kernels, otherwise the plain step loop (`ops/rnn.lstm_scan`).
`Gru` takes them too (`act` the candidate's, `gate_act` the gates'); with
the defaults (sigmoid gates, tanh candidate) it runs the fused GRU
kernels, otherwise the plain step loop (`ops/rnn.gru_scan`). A named
`param_attr` shares `w_hzr` under its name and `w_hc` under the name +
".c", as in the JAX package (the two differ in shape)."""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

from paddle_tpu_torch.nn import init as init_mod
from paddle_tpu_torch.nn.graph import Argument, Context, Layer
from paddle_tpu_torch.nn.layers import Concat, Fc, _attr
from paddle_tpu_torch.ops import rnn as rnn_ops


class Lstm(Layer):
    """lstmemory (LstmLayer.cpp): the input must be the 4H-wide projection.
    `use_peephole` adds the 'check' weights of hl_lstm."""

    type_name = "lstmemory"

    def __init__(self, input: Layer, size: Optional[int] = None, reverse: bool = False,
                 act: Any = "tanh", gate_act: Any = "sigmoid", state_act: Any = "tanh",
                 use_peephole: bool = True, param_attr: Any = None, bias_attr: Any = None,
                 name: Optional[str] = None):
        super().__init__(input, name=name)
        self.size = size
        self.reverse = reverse
        self.act = act
        self.gate_act = gate_act
        self.state_act = state_act
        self.use_peephole = use_peephole
        self.param_attr = _attr(param_attr)
        self.bias_attr = _attr(bias_attr)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        arg = ins[0]
        assert arg.is_seq, f"{self.name}: lstmemory needs a sequence input"
        proj = arg.value
        hdim = self.size or proj.shape[-1] // 4
        if proj.shape[-1] != 4 * hdim:
            raise ValueError(
                f"{self.name}: input width {proj.shape[-1]} != 4*size ({4 * hdim})")
        w_hh = ctx.param(self, "w_hh", (hdim, 4 * hdim), init_mod.smart_normal,
                         self.param_attr)
        bias = ctx.param(self, "b", (4 * hdim,), init_mod.zeros, self.bias_attr)
        checks = (None, None, None)
        if self.use_peephole:
            checks = tuple(ctx.param(self, f"check_{g}", (hdim,), init_mod.zeros)
                           for g in ("i", "f", "o"))
        p = rnn_ops.LstmParams(w_hh, bias, *checks)
        hs, _, _ = rnn_ops.lstm_scan(
            proj, arg.mask(proj.dtype), p, reverse=self.reverse,
            gate_act=self.gate_act, cell_act=self.act, state_act=self.state_act)
        return Argument(hs, arg.lengths)


class Gru(Layer):
    """grumemory: the input must be the 3H-wide projection."""

    type_name = "grumemory"

    def __init__(self, input: Layer, size: Optional[int] = None,
                 reverse: bool = False, act: Any = "tanh", gate_act: Any = "sigmoid",
                 param_attr: Any = None, bias_attr: Any = None,
                 name: Optional[str] = None):
        super().__init__(input, name=name)
        self.size = size
        self.reverse = reverse
        self.act = act
        self.gate_act = gate_act
        self.param_attr = _attr(param_attr)
        self.bias_attr = _attr(bias_attr)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        arg = ins[0]
        assert arg.is_seq, f"{self.name}: grumemory needs a sequence input"
        proj = arg.value
        hdim = self.size or proj.shape[-1] // 3
        if proj.shape[-1] != 3 * hdim:
            raise ValueError(f"{self.name}: input width {proj.shape[-1]} != 3*size")
        c_attr = self.param_attr
        if c_attr is not None and c_attr.name:
            c_attr = dataclasses.replace(c_attr, name=c_attr.name + ".c")
        p = rnn_ops.GruParams(
            w_hzr=ctx.param(self, "w_hzr", (hdim, 2 * hdim), init_mod.smart_normal,
                            self.param_attr),
            w_hc=ctx.param(self, "w_hc", (hdim, hdim), init_mod.smart_normal, c_attr),
            bias=ctx.param(self, "b", (3 * hdim,), init_mod.zeros, self.bias_attr),
        )
        hs, _ = rnn_ops.gru_scan(proj, arg.mask(proj.dtype), p, reverse=self.reverse,
                                 gate_act=self.gate_act, cand_act=self.act)
        return Argument(hs, arg.lengths)


def simple_lstm(input: Layer, size: int, reverse: bool = False, name: str = "lstm",
                **lstm_kwargs: Any) -> Layer:
    """fc(4H) + lstmemory (the simple_lstm helper of networks.py:553)."""
    proj = Fc(input, 4 * size, act=None, name=f"{name}.input_proj")
    return Lstm(proj, size=size, reverse=reverse, name=name, **lstm_kwargs)


def bidirectional_lstm(input: Layer, size: int, name: str = "bilstm", **kw: Any) -> Layer:
    """Concat of a forward and a reverse simple_lstm."""
    fwd = simple_lstm(input, size, reverse=False, name=f"{name}.fw", **kw)
    bwd = simple_lstm(input, size, reverse=True, name=f"{name}.bw", **kw)
    return Concat([fwd, bwd], name=f"{name}.cat")


def simple_gru(input: Layer, size: int, reverse: bool = False,
               name: str = "gru", **kw: Any) -> Layer:
    """fc(3H) + grumemory; `kw` goes to `Gru`."""
    proj = Fc(input, 3 * size, act=None, name=f"{name}.input_proj")
    return Gru(proj, size=size, reverse=reverse, name=name, **kw)


def bidirectional_gru(input: Layer, size: int, name: str = "bigru", **kw: Any) -> Layer:
    """Concat of a forward and a reverse simple_gru."""
    fwd = simple_gru(input, size, reverse=False, name=f"{name}.fw", **kw)
    bwd = simple_gru(input, size, reverse=True, name=f"{name}.bw", **kw)
    return Concat([fwd, bwd], name=f"{name}.cat")
