"""The 2-D multi-dimensional LSTM (counterpart of `paddle_tpu/ops/mdlstm.py`;
MDLstmLayer.cpp:180, mdlstmemory).

The grid [H, W] is skewed so that its anti-diagonals become columns (cell
(i, j) to column i + j), and one loop over the H + W - 1 columns updates
every row of a column at once: the wavefront schedule. Cell (i, j) reads
its up neighbour (i - 1, j), the same column of the row above in the
previous skewed column, and its left neighbour (i, j - 1), the same row
of the previous column. Gates = x W_x (projected outside) + (h_up + h_left)
W_h + b, in blocks [input node, input gate, forget gate of each dim x 2,
output gate], with peepholes check_i on the input gate, check_f[d] on each
forget gate and check_o on the output gate. A direction walked backwards is
a flip of that axis before and after. The loop reads nothing back to the
host, so it runs inside a captured graph."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.ops import linalg


class MDLstmParams(NamedTuple):
    w_h: torch.Tensor  # [H, 5H] recurrent weight, shared by both dims
    bias: torch.Tensor  # [5H]: [inode, ig, fg0, fg1, og]
    check_i: torch.Tensor  # [H]
    check_f: torch.Tensor  # [2, H]
    check_o: torch.Tensor  # [H]


def _skew(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H, H+W-1, C]: row i shifted right by i."""
    h = x.shape[1]
    return torch.stack([F.pad(x[:, i], (0, 0, i, h - 1 - i)) for i in range(h)], dim=1)


def _unskew(x: torch.Tensor, w: int) -> torch.Tensor:
    return torch.stack([x[:, i, i:i + w] for i in range(x.shape[1])], dim=1)


def mdlstm_2d(proj: torch.Tensor, p: MDLstmParams,
              directions: Tuple[bool, bool] = (True, True)) -> torch.Tensor:
    """proj [B, H, W, 5*hid] (x W_x) -> h [B, H, W, hid]. directions[d]
    False walks dim d backwards."""
    b, gh, gw, h5 = proj.shape
    hid = h5 // 5
    flip = [ax + 1 for ax, fwd in enumerate(directions) if not fwd]
    if flip:
        proj = torch.flip(proj, flip)
    sk = _skew(proj)  # [B, gh, T, 5*hid]
    valid = _skew(torch.ones((1, gh, gw, 1), dtype=proj.dtype, device=proj.device))
    dt = proj.dtype
    w_h, bias = p.w_h.to(dt), p.bias.to(dt)
    ci, co = p.check_i.to(dt), p.check_o.to(dt)
    cf0, cf1 = p.check_f[0].to(dt), p.check_f[1].to(dt)
    h_prev = c_prev = torch.zeros((b, gh, hid), dtype=dt, device=proj.device)
    hs = []
    cols = sk.unbind(2)  # one backward stack, not a full-size gradient a column
    for t in range(gh + gw - 1):
        h_up = F.pad(h_prev, (0, 0, 1, 0))[:, :-1]  # row i gets row i-1
        c_up = F.pad(c_prev, (0, 0, 1, 0))[:, :-1]
        gates = cols[t] + linalg.matmul(h_up + h_prev, w_h) + bias
        g, ig, f0, f1, og = torch.chunk(gates, 5, dim=-1)
        i_t = torch.sigmoid(ig + ci * (c_up + c_prev))
        f0_t = torch.sigmoid(f0 + cf0 * c_up)
        f1_t = torch.sigmoid(f1 + cf1 * c_prev)
        c_t = i_t * torch.tanh(g) + f0_t * c_up + f1_t * c_prev
        o_t = torch.sigmoid(og + co * c_t)
        m = valid[:, :, t]  # the skew's padding reads as a zero neighbour
        h_prev = o_t * torch.tanh(c_t) * m
        c_prev = c_t * m
        hs.append(h_prev)
    out = _unskew(torch.stack(hs, dim=2), gw)
    return torch.flip(out, flip) if flip else out


def mdlstm_2d_reference(proj, p: MDLstmParams, directions=(True, True)) -> np.ndarray:
    """The per-cell walk (the reference's CoordIterator), in numpy: the
    tests' slow oracle."""
    proj = np.asarray(proj, np.float32)
    w_h, bias = np.asarray(p.w_h), np.asarray(p.bias)
    ck_i, ck_f, ck_o = np.asarray(p.check_i), np.asarray(p.check_f), np.asarray(p.check_o)
    b, gh, gw, h5 = proj.shape
    hid = h5 // 5
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
    h = np.zeros((b, gh, gw, hid), np.float32)
    c = np.zeros((b, gh, gw, hid), np.float32)
    zero = np.zeros((b, hid), np.float32)
    for i in (range(gh) if directions[0] else range(gh - 1, -1, -1)):
        for j in (range(gw) if directions[1] else range(gw - 1, -1, -1)):
            pi = i - 1 if directions[0] else i + 1
            pj = j - 1 if directions[1] else j + 1
            h_up = h[:, pi, j] if 0 <= pi < gh else zero
            c_up = c[:, pi, j] if 0 <= pi < gh else zero
            h_left = h[:, i, pj] if 0 <= pj < gw else zero
            c_left = c[:, i, pj] if 0 <= pj < gw else zero
            gates = proj[:, i, j] + (h_up + h_left) @ w_h + bias
            g, ig, f0, f1, og = np.split(gates, 5, axis=-1)
            i_t = sig(ig + ck_i * (c_up + c_left))
            c_t = (i_t * np.tanh(g) + sig(f0 + ck_f[0] * c_up) * c_up
                   + sig(f1 + ck_f[1] * c_left) * c_left)
            h[:, i, j] = sig(og + ck_o * c_t) * np.tanh(c_t)
            c[:, i, j] = c_t
    return h
