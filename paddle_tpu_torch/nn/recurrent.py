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
".c", as in the JAX package (the two differ in shape).

`SimpleRnn` (recurrent) is the vanilla full-matrix recurrence and `MDLstm`
(mdlstmemory) the 2-D multi-dimensional LSTM over a projected grid, both
plain PyTorch loops (`ops/rnn.simple_rnn_scan`, `ops/mdlstm.mdlstm_2d`), as
the JAX package runs `lax.scan` for them.

`LstmStep`, `GruStep` and `StepArgOutput` are the one-step layers a
recurrent group's step net is built from (`nn/recurrent_group.py`): plain
PyTorch, run once a step of the group's loop."""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

from paddle_tpu_torch.nn import activations as act_mod
from paddle_tpu_torch.nn import init as init_mod
from paddle_tpu_torch.nn.graph import Argument, Context, Layer
from paddle_tpu_torch.nn.layers import Concat, Fc, _attr
from paddle_tpu_torch.ops import mdlstm as md_ops
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


class SimpleRnn(Layer):
    """The vanilla full-matrix recurrence (RecurrentLayer.cpp): the input
    is already of width H; weight `w_hh` [H, H], bias `b` [H]."""

    type_name = "recurrent"

    def __init__(self, input: Layer, act: Any = "tanh", reverse: bool = False,
                 bias: bool = True, param_attr: Any = None, bias_attr: Any = None,
                 name: Optional[str] = None):
        super().__init__(input, name=name)
        self.act = act
        self.reverse = reverse
        self.bias = bias
        self.param_attr = _attr(param_attr)
        self.bias_attr = _attr(bias_attr)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        arg = ins[0]
        assert arg.is_seq, f"{self.name}: recurrent needs a sequence input"
        proj = arg.value
        hdim = proj.shape[-1]
        w_hh = ctx.param(self, "w_hh", (hdim, hdim), init_mod.smart_normal, self.param_attr)
        b = (ctx.param(self, "b", (hdim,), init_mod.zeros, self.bias_attr)
             if self.bias else None)
        hs, _ = rnn_ops.simple_rnn_scan(proj, arg.mask(proj.dtype), w_hh, b, self.act,
                                        reverse=self.reverse)
        return Argument(hs, arg.lengths)


class MDLstm(Layer):
    """The 2-D multi-dimensional LSTM (MDLstmLayer.cpp:180): the input is
    the projected grid [B, H, W, 5*size] (as lstmemory's is 4H wide),
    the output [B, H, W, size]; parameters `w_h` [size, 5*size], `b`
    [5*size], peepholes `check_i` [size], `check_f` [2, size], `check_o`
    [size]. directions[d] False walks dimension d backwards."""

    type_name = "mdlstmemory"

    def __init__(self, input: Layer, size: Optional[int] = None, directions=(True, True),
                 param_attr: Any = None, bias_attr: Any = None, name: Optional[str] = None):
        super().__init__(input, name=name)
        self.size = size
        self.directions = tuple(directions)
        self.param_attr = _attr(param_attr)
        self.bias_attr = _attr(bias_attr)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        proj = ins[0].value
        if proj.dim() != 4:
            raise ValueError(f"{self.name}: mdlstmemory needs a [B, H, W, 5*size] grid "
                             f"input, got {tuple(proj.shape)}")
        hid = self.size or proj.shape[-1] // 5
        if proj.shape[-1] != 5 * hid:
            raise ValueError(f"{self.name}: input width {proj.shape[-1]} != 5*size ({5 * hid})")
        p = md_ops.MDLstmParams(
            w_h=ctx.param(self, "w_h", (hid, 5 * hid), init_mod.smart_normal,
                          self.param_attr),
            bias=ctx.param(self, "b", (5 * hid,), init_mod.zeros, self.bias_attr),
            check_i=ctx.param(self, "check_i", (hid,), init_mod.zeros),
            check_f=ctx.param(self, "check_f", (2, hid), init_mod.zeros),
            check_o=ctx.param(self, "check_o", (hid,), init_mod.zeros),
        )
        return ins[0].with_value(md_ops.mdlstm_2d(proj, p, self.directions))


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


# -- step layers of a recurrent group (nn/recurrent_group.py) ----------------


class LstmStep(Layer):
    """LstmStepLayer.cpp: one LSTM cell step inside a recurrent group.
    Inputs: the [B, 4H] projection (Wx + Uh, mixed by the caller) and the
    cell-state memory [B, H]. Output: h; the new cell state is published
    in the run's cache under `{name}::state` for StepArgOutput (the
    reference's second output, read by get_output_layer(arg_name='state'))."""

    type_name = "lstm_step"

    def __init__(self, input: Layer, state: Layer, size: int, act: Any = "tanh",
                 gate_act: Any = "sigmoid", state_act: Any = "tanh", bias: bool = True,
                 bias_attr: Any = None, name: Optional[str] = None):
        super().__init__([input, state], name=name)
        self.size = size
        self.act = act or "tanh"
        self.gate_act = gate_act or "sigmoid"
        self.state_act = state_act or "tanh"
        self.bias = bias
        self.bias_attr = _attr(bias_attr)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        m, c_prev = ins[0].value, ins[1].value
        hid = self.size
        assert m.shape[-1] == 4 * hid, (
            f"{self.name}: lstm_step input width {m.shape[-1]} != 4*size")
        ci = cf = co = 0.0
        if self.bias:
            # the step layer's own parameter is the [3H] peephole block
            # (checkI/checkF/checkO); the additive 4H gate bias lives in the
            # input projection
            b = ctx.param(self, "b", (3 * hid,), init_mod.zeros, self.bias_attr)
            ci, cf, co = b[:hid], b[hid:2 * hid], b[2 * hid:]
        gi = act_mod.apply(self.gate_act, m[..., :hid] + ci * c_prev)
        gf = act_mod.apply(self.gate_act, m[..., hid:2 * hid] + cf * c_prev)
        gc = act_mod.apply(self.act, m[..., 2 * hid:3 * hid])
        c = gf * c_prev + gi * gc
        go = act_mod.apply(self.gate_act, m[..., 3 * hid:] + co * c)
        h = go * act_mod.apply(self.state_act, c)
        ctx.cache[f"{self.name}::state"] = Argument(c)
        return Argument(h)


class GruStep(Layer):
    """GruStepLayer.cpp: one GRU step inside a recurrent group. Inputs: the
    [B, 3H] projection Wx and the previous output memory [B, H]. Its
    parameters carry `Gru`'s names and shapes (`w_hzr`, `w_hc`, `b`)."""

    type_name = "gru_step"

    def __init__(self, input: Layer, output_mem: Layer, size: int, act: Any = "tanh",
                 gate_act: Any = "sigmoid", bias: bool = True, bias_attr: Any = None,
                 param_attr: Any = None, name: Optional[str] = None):
        super().__init__([input, output_mem], name=name)
        self.size = size
        self.act = act or "tanh"
        self.gate_act = gate_act or "sigmoid"
        self.bias = bias
        self.bias_attr = _attr(bias_attr)
        self.param_attr = _attr(param_attr)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        m, h_prev = ins[0].value, ins[1].value
        hid = self.size
        assert m.shape[-1] == 3 * hid, (
            f"{self.name}: gru_step input width {m.shape[-1]} != 3*size")
        w_hzr = ctx.param(self, "w_hzr", (hid, 2 * hid), init_mod.smart_normal,
                          self.param_attr)
        c_attr = self.param_attr
        if c_attr is not None and c_attr.name:
            c_attr = dataclasses.replace(c_attr, name=c_attr.name + ".c")
        w_hc = ctx.param(self, "w_hc", (hid, hid), init_mod.smart_normal, c_attr)
        if self.bias:
            m = m + ctx.param(self, "b", (3 * hid,), init_mod.zeros, self.bias_attr)
        zr = m[..., :2 * hid] + h_prev @ w_hzr
        z = act_mod.apply(self.gate_act, zr[..., :hid])
        r = act_mod.apply(self.gate_act, zr[..., hid:])
        c = act_mod.apply(self.act, m[..., 2 * hid:] + (r * h_prev) @ w_hc)
        return Argument((1.0 - z) * h_prev + z * c)


class StepArgOutput(Layer):
    """In-step get_output_layer: reads an auxiliary output another step
    layer published in the run's cache (GetOutputLayer.cpp)."""

    type_name = "step_arg_output"

    def __init__(self, input: Layer, arg_name: str, name: Optional[str] = None):
        super().__init__(input, name=name)
        self.arg_name = arg_name

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        key = f"{self.inputs[0].name}::{self.arg_name}"
        if key not in ctx.cache:
            raise ValueError(f"{self.name}: {self.inputs[0].name} published no "
                             f"{self.arg_name!r} output")
        return ctx.cache[key]
