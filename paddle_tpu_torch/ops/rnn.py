"""LSTM and GRU cells and whole-sequence scans, and the vanilla recurrence
(counterpart of `LstmParams`, `lstm_step`, `lstm_scan`, `GruParams`,
`gru_step`, `gru_scan` and `simple_rnn_scan` in `paddle_tpu/ops/rnn.py`).

LSTM gate blocks [input i, forget f, cell candidate c, output o] (the JAX
package's order, not the reference's [c, i, f, o]), optional peephole
("check") weights. GRU gate order [update z, reset r, candidate c]; the
reset gate multiplies the RECURRENT candidate term, c = tanh(p_c + (r*h)
W_c) (GruCompute / hl_gpu_gru.cuh semantics). Masked steps carry the state
through.

Dispatch mirrors the JAX package's `_use_fused`: the activation test first,
then a shape test.
  * `lstm_scan` takes the fused whole-sequence op
    (`ops/rnn_kernels.lstm_seq_fused`) for sigmoid gates, tanh cell and
    state, no peepholes and no `return_cell_seq`; `gru_scan` takes
    `gru_seq_fused` for sigmoid gates and a tanh candidate, the only
    activations its kernels compute. Every other LSTM or GRU runs the plain
    step loop (`lstm_step_loop` / `gru_step_loop`) on either device, as the
    JAX package runs `lax.scan` for it on the TPU.
  * CPU tensors that pass take the fused op's plain versions. CUDA tensors
    that pass take the fused op's kernels where the kernels' static layout
    plan has a layout for (T, B, H) (`rnn_kernels.lstm_seq_fits` /
    `gru_seq_fits`, the return code of the C plan entry points, read once
    per shape), and the step loop (`lstm_step_loop` / `gru_step_loop`:
    masked carry, autograd for the gradient) where it has none. The plan
    keeps a row group's per-cell state in shared memory, one block per SM,
    so on a 132-SM card it runs out at large B*H: the first batch without
    a layout is, at H = 512 / 1024 / 1280, 1266 / 574 / 207 for the LSTM
    forward and 1333 / 638 / 249 for the GRU backward (the GRU forward and
    the LSTM backward go further; either leg without a layout routes both).
    This takes the place of the JAX package's B*H budget
    (`PADDLE_TPU_FUSED_RNN_MAX_BH`, a TPU VMEM number), which has no
    counterpart, nor has its `pal.enabled()` switch: the route reads no
    environment and never catches a kernel's error."""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from paddle_tpu_torch.nn import activations as act_mod
from paddle_tpu_torch.ops import linalg, rnn_kernels
from paddle_tpu_torch.ops.rnn_kernels import gru_seq_fused, lstm_seq_fused


def takes_fused(device: torch.device, fits: Callable[..., bool], hdim: int, b: int,
                t: int) -> bool:
    """The shape test of the route: tensors off the card always take the
    fused op (on the CPU its plain versions); on a CUDA device it is taken
    where `fits` (the kernels' layout plan) says the kernels lay out
    (T, B, H) on that card."""
    return device.type != "cuda" or fits(hdim, b, t, device)


class LstmParams(NamedTuple):
    w_hh: torch.Tensor  # [H, 4H] recurrent weights
    bias: torch.Tensor  # [4H]
    check_i: Optional[torch.Tensor] = None  # peephole [H] of the input gate
    check_f: Optional[torch.Tensor] = None
    check_o: Optional[torch.Tensor] = None


def lstm_step(
    proj_t: torch.Tensor,  # [B, 4H] (x_t already projected)
    h: torch.Tensor,
    c: torch.Tensor,
    p: LstmParams,
    gate_act: act_mod.ActLike = "sigmoid",
    cell_act: act_mod.ActLike = "tanh",
    state_act: act_mod.ActLike = "tanh",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step (hl_lstm semantics, peepholes included) -> (h, c)."""
    gates = proj_t + linalg.matmul(h, p.w_hh) + p.bias
    gi, gf, gc, go = torch.chunk(gates, 4, dim=-1)
    ga = act_mod.get(gate_act)
    if p.check_i is not None:
        gi = gi + c * p.check_i
        gf = gf + c * p.check_f
    i = ga(gi)
    f = ga(gf)
    c_new = f * c + i * act_mod.get(cell_act)(gc)
    if p.check_o is not None:
        go = go + c_new * p.check_o
    h_new = ga(go) * act_mod.get(state_act)(c_new)
    return h_new, c_new


def lstm_scan(
    proj: torch.Tensor,  # [B, T, 4H]
    mask: torch.Tensor,  # [B, T]
    p: LstmParams,
    h0: Optional[torch.Tensor] = None,
    c0: Optional[torch.Tensor] = None,
    reverse: bool = False,
    gate_act: act_mod.ActLike = "sigmoid",
    cell_act: act_mod.ActLike = "tanh",
    state_act: act_mod.ActLike = "tanh",
    return_cell_seq: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence LSTM -> (h_seq [B,T,H], h_last, c_last); masked steps
    carry the previous state through. `return_cell_seq=True` returns
    (h_seq, c_seq [B,T,H], h_last) instead (the fluid lstm_op contract) and
    always takes the step loop, as in the JAX package."""
    b, t_len, h4 = proj.shape
    hdim = h4 // 4
    if h0 is None:
        h0 = torch.zeros((b, hdim), dtype=proj.dtype, device=proj.device)
    if c0 is None:
        c0 = torch.zeros((b, hdim), dtype=proj.dtype, device=proj.device)
    standard = (gate_act == "sigmoid" and cell_act == "tanh" and state_act == "tanh"
                and p.check_i is None and p.check_f is None and p.check_o is None)
    if (standard and not return_cell_seq
            and takes_fused(proj.device, rnn_kernels.lstm_seq_fits, hdim, b, t_len)):
        hs, h_last, c_last = lstm_seq_fused(
            proj.transpose(0, 1), mask.transpose(0, 1), p.w_hh, p.bias, h0, c0, reverse)
        return (hs.transpose(0, 1).to(proj.dtype), h_last.to(proj.dtype),
                c_last.to(proj.dtype))
    return lstm_step_loop(proj, mask, p, h0, c0, reverse, gate_act, cell_act, state_act,
                          return_cell_seq)


def lstm_step_loop(
    proj: torch.Tensor,  # [B, T, 4H]
    mask: torch.Tensor,  # [B, T]
    p: LstmParams,
    h0: torch.Tensor,
    c0: torch.Tensor,
    reverse: bool = False,
    gate_act: act_mod.ActLike = "sigmoid",
    cell_act: act_mod.ActLike = "tanh",
    state_act: act_mod.ActLike = "tanh",
    return_cell_seq: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`lstm_scan` as a loop of `lstm_step` over time (the JAX package's
    `lax.scan` branch); masked steps carry (h, c). Autograd gives the
    gradient."""
    t_len = proj.shape[1]
    h, c = h0, c0
    hs: List[Optional[torch.Tensor]] = [None] * t_len
    cs: List[Optional[torch.Tensor]] = [None] * t_len
    steps = range(t_len - 1, -1, -1) if reverse else range(t_len)
    for t in steps:
        h_new, c_new = lstm_step(proj[:, t], h, c, p, gate_act, cell_act, state_act)
        m = mask[:, t, None].to(h_new.dtype)
        h = m * h_new + (1 - m) * h
        c = m * c_new + (1 - m) * c
        hs[t], cs[t] = h, c
    if return_cell_seq:
        return torch.stack(hs, dim=1), torch.stack(cs, dim=1), h
    return torch.stack(hs, dim=1), h, c


class GruParams(NamedTuple):
    w_hzr: torch.Tensor  # [H, 2H] recurrent weights for update + reset gates
    w_hc: torch.Tensor   # [H, H] recurrent weight for the candidate
    bias: torch.Tensor   # [3H]


def gru_step(proj_t: torch.Tensor, h: torch.Tensor, p: GruParams,
             gate_act: act_mod.ActLike = "sigmoid",
             cand_act: act_mod.ActLike = "tanh") -> torch.Tensor:
    """One GRU step: proj_t [B, 3H] (x_t already projected), h [B, H]."""
    hdim = h.shape[-1]
    pz, pr, pc = torch.split(proj_t + p.bias, hdim, dim=-1)
    rz = linalg.matmul(h, p.w_hzr)
    ga = act_mod.get(gate_act)
    z = ga(pz + rz[:, :hdim])
    r = ga(pr + rz[:, hdim:])
    c = act_mod.get(cand_act)(pc + linalg.matmul(r * h, p.w_hc))
    return (1.0 - z) * h + z * c


def gru_scan(
    proj: torch.Tensor,  # [B, T, 3H]
    mask: torch.Tensor,  # [B, T]
    p: GruParams,
    h0: Optional[torch.Tensor] = None,
    reverse: bool = False,
    gate_act: act_mod.ActLike = "sigmoid",
    cand_act: act_mod.ActLike = "tanh",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence GRU -> (h_seq [B, T, H], h_last [B, H]). Batch-major in
    and out, time-major inside the fused op."""
    b, t_len, h3 = proj.shape
    hdim = h3 // 3
    if h0 is None:
        h0 = torch.zeros((b, hdim), dtype=proj.dtype, device=proj.device)
    standard = gate_act == "sigmoid" and cand_act == "tanh"
    if not (standard and takes_fused(proj.device, rnn_kernels.gru_seq_fits, hdim, b,
                                     t_len)):
        return gru_step_loop(proj, mask, p, h0, reverse, gate_act, cand_act)
    hs, h_last = gru_seq_fused(
        proj.transpose(0, 1), mask.transpose(0, 1), p.w_hzr, p.w_hc, p.bias,
        h0, reverse,
    )
    return hs.transpose(0, 1).to(proj.dtype), h_last.to(proj.dtype)


def gru_step_loop(
    proj: torch.Tensor,  # [B, T, 3H]
    mask: torch.Tensor,  # [B, T]
    p: GruParams,
    h0: torch.Tensor,
    reverse: bool = False,
    gate_act: act_mod.ActLike = "sigmoid",
    cand_act: act_mod.ActLike = "tanh",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`gru_scan` as a loop of `gru_step` over time (the JAX package's
    `lax.scan` branch); masked steps carry h. Autograd gives the gradient."""
    t_len = proj.shape[1]
    h = h0
    hs: List[Optional[torch.Tensor]] = [None] * t_len
    steps = range(t_len - 1, -1, -1) if reverse else range(t_len)
    for t in steps:
        h_new = gru_step(proj[:, t], h, p, gate_act, cand_act)
        m = mask[:, t, None].to(h_new.dtype)
        h = m * h_new + (1 - m) * h
        hs[t] = h
    return torch.stack(hs, dim=1), h


def simple_rnn_scan(
    proj: torch.Tensor,  # [B, T, H] (the input already projected)
    mask: torch.Tensor,  # [B, T]
    w_hh: torch.Tensor,  # [H, H]
    bias: Optional[torch.Tensor],
    act: act_mod.ActLike = "tanh",
    h0: Optional[torch.Tensor] = None,
    reverse: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The vanilla recurrence (RecurrentLayer.cpp), h_t = act(x_t + h_{t-1}
    W + b) -> (h_seq [B, T, H], h_last). A loop over time of a few kernels a
    step, no host read (capturable); masked steps carry h; `reverse` walks
    from the last step. Autograd gives the gradient."""
    b, t_len, hdim = proj.shape
    h = h0 if h0 is not None else torch.zeros((b, hdim), dtype=proj.dtype, device=proj.device)
    a = act_mod.get(act)
    hs: List[Optional[torch.Tensor]] = [None] * t_len
    xs = proj.unbind(1)  # one backward stack, not T full-size slice gradients
    for t in (range(t_len - 1, -1, -1) if reverse else range(t_len)):
        pre = xs[t] + linalg.matmul(h, w_hh)
        if bias is not None:
            pre = pre + bias
        m = mask[:, t, None].to(proj.dtype)
        h = m * a(pre) + (1 - m) * h
        hs[t] = h
    return torch.stack(hs, dim=1), h
