"""Masked whole-sequence GRU: the CUDA kernels' wrappers, their plain
PyTorch versions and the autograd.Function that joins them.

Counterpart of `gru_seq_fused` in `paddle_tpu/ops/pallas/rnn_kernels.py`:
one call runs the whole time loop over time-major [T, B, ...] arrays
(`proj` [T,B,3H] in gate order z, r, c; `mask` [T,B]), the forward saves the
post-activation gates `zrc` [T,B,3H], and the backward is a reverse-time
walk that accumulates dW_zr, dW_c, db and dh0. `reverse=True` walks time
backwards with every array left in original time order, which equals the
JAX package's flip, run, flip (`_run_fused`).

  * `gru_seq_fused_ref` / `gru_seq_bwd_ref`: the plain versions, a loop over
    t of the gate math of `_gru_fwd_kernel` / `_gru_bwd_kernel`.
  * `gru_seq_fwd` / `gru_seq_bwd`: one launch of `csrc/gru_seq.cu`'s forward
    or backward entry point each (the time loop runs inside the kernel).
  * `GruSeqFused` (`gru_seq_fused`): CPU tensors take the plain versions,
    CUDA tensors the kernels, or an error — never the plain version on the
    card. All math is f32; cotangents come back in the primals' dtypes.

`FWD_LAUNCHES` / `BWD_LAUNCHES` count entry-point launches (never
plain-version calls)."""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from paddle_tpu_torch.ops import build

# kernel launches since import (or since a caller last set them to 0)
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

_SOURCE = "gru_seq"


# -- plain versions -----------------------------------------------------------


def _time_order(t: int, reverse: bool):
    return range(t - 1, -1, -1) if reverse else range(t)


def _h_prev_seq(hs: torch.Tensor, h0: torch.Tensor, reverse: bool) -> torch.Tensor:
    """[T,B,H] state each step started from: h0 at the first processed step,
    else the output of the step processed just before."""
    if reverse:
        return torch.cat([hs[1:], h0[None]], dim=0)
    return torch.cat([h0[None], hs[:-1]], dim=0)


def gru_seq_fused_ref(
    proj: torch.Tensor,   # [T, B, 3H]
    mask: torch.Tensor,   # [T, B] (or [T, B, 1])
    w_hzr: torch.Tensor,  # [H, 2H]
    w_hc: torch.Tensor,   # [H, H]
    bias: torch.Tensor,   # [3H]
    h0: torch.Tensor,     # [B, H]
    reverse: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain forward -> (hs [T,B,H], zrc [T,B,3H]), f32, differentiable
    by autograd."""
    t_len, _, h3 = proj.shape
    hdim = h3 // 3
    proj, w_hzr, w_hc, bias = (x.float() for x in (proj, w_hzr, w_hc, bias))
    mask = mask.float().reshape(t_len, -1, 1)
    h = h0.float()
    hs = [None] * t_len
    zrc = [None] * t_len
    for t in _time_order(t_len, reverse):
        p = proj[t] + bias
        rz = h @ w_hzr
        z = torch.sigmoid(p[:, :hdim] + rz[:, :hdim])
        r = torch.sigmoid(p[:, hdim:2 * hdim] + rz[:, hdim:])
        c = torch.tanh(p[:, 2 * hdim:] + (r * h) @ w_hc)
        h_tilde = (1.0 - z) * h + z * c
        m = mask[t]
        h = m * h_tilde + (1.0 - m) * h
        zrc[t] = torch.cat([z, r, c], dim=-1)
        hs[t] = h
    return torch.stack(hs), torch.stack(zrc)


def gru_seq_bwd_ref(
    zrc: torch.Tensor,      # [T, B, 3H] saved gates
    hs: torch.Tensor,       # [T, B, H] saved outputs
    h0: torch.Tensor,       # [B, H]
    mask: torch.Tensor,     # [T, B] (or [T, B, 1])
    w_hzr: torch.Tensor,
    w_hc: torch.Tensor,
    dhs: torch.Tensor,      # [T, B, H]
    dh_last: torch.Tensor,  # [B, H]
    reverse: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """The plain backward: the reverse walk of `_gru_bwd_kernel` over the
    saved residuals -> (dproj [T,B,3H], dW_zr, dW_c, db, dh0), f32."""
    t_len, b, h3 = zrc.shape
    hdim = h3 // 3
    w_hzr, w_hc = w_hzr.float(), w_hc.float()
    mask = mask.float().reshape(t_len, b, 1)
    h_prev = _h_prev_seq(hs.float(), h0.float(), reverse)
    dproj = torch.empty_like(zrc, dtype=torch.float32)
    dwzr = torch.zeros_like(w_hzr)
    dwc = torch.zeros_like(w_hc)
    db = torch.zeros(h3, dtype=torch.float32, device=zrc.device)
    dh_carry = dh_last.float()
    for t in reversed(list(_time_order(t_len, reverse))):
        z, r, c = zrc[t, :, :hdim], zrc[t, :, hdim:2 * hdim], zrc[t, :, 2 * hdim:]
        hp = h_prev[t]
        m = mask[t]
        dh = dh_carry + dhs[t]
        dht = m * dh
        dz = dht * (c - hp)
        dc = dht * z
        dgc = dc * (1.0 - c * c)
        d_rh = dgc @ w_hc.T
        dr = d_rh * hp
        dgz = dz * z * (1.0 - z)
        dgr = dr * r * (1.0 - r)
        dgzr = torch.cat([dgz, dgr], dim=-1)
        dproj[t] = torch.cat([dgz, dgr, dgc], dim=-1)
        dh_carry = dht * (1.0 - z) + d_rh * r + dgzr @ w_hzr.T + (1.0 - m) * dh
        dwzr = dwzr + hp.T @ dgzr
        dwc = dwc + (r * hp).T @ dgc
        db = db + dproj[t].sum(dim=0)
    return dproj, dwzr, dwc, db, dh_carry


# -- kernels -----------------------------------------------------------------


def check_inputs(proj, mask, w_hzr, w_hc, bias, h0) -> Tuple[int, int, int]:
    """Raise on anything the kernels do not take: f32, contiguous, one CUDA
    device, proj [T,B,3H], mask [T,B], w_hzr [H,2H], w_hc [H,H], bias [3H],
    h0 [B,H]. Returns (T, B, H)."""
    if proj.dim() != 3 or proj.shape[2] % 3:
        raise ValueError(f"proj must be [T, B, 3H], got {tuple(proj.shape)}")
    t, b, h3 = proj.shape
    h = h3 // 3
    want = {
        "mask": (mask, (t, b)), "w_hzr": (w_hzr, (h, 2 * h)),
        "w_hc": (w_hc, (h, h)), "bias": (bias, (h3,)), "h0": (h0, (b, h)),
    }
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {list(x.shape)}")
    _check_tensors(proj=proj, mask=mask, w_hzr=w_hzr, w_hc=w_hc, bias=bias, h0=h0)
    return t, b, h


def _check_tensors(**tensors: torch.Tensor) -> None:
    dev = next(iter(tensors.values())).device
    if dev.type != "cuda":
        raise ValueError(f"the GRU kernels run on CUDA tensors, got {dev}")
    for name, x in tensors.items():
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the others on {dev}")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the "
                             "kernels load 4 floats at a time); pass a copy")


def _entry(name: str, n_ptrs: int):
    """A built, loaded entry point with every argument type declared:
    pointers and the stream c_void_p, sizes and flags c_int (undeclared,
    ctypes would cut pointers to 32 bits)."""
    fn = getattr(build.load(_SOURCE), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * n_ptrs + [i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def gru_seq_fwd(proj, mask, w_hzr, w_hc, bias, h0, reverse: bool = False):
    """One launch of the forward kernel -> (hs [T,B,H], zrc [T,B,3H])."""
    global FWD_LAUNCHES
    t, b, h = check_inputs(proj, mask, w_hzr, w_hc, bias, h0)
    hs = torch.empty((t, b, h), dtype=torch.float32, device=proj.device)
    zrc = torch.empty((t, b, 3 * h), dtype=torch.float32, device=proj.device)
    rh = torch.empty((b, h), dtype=torch.float32, device=proj.device)  # r*h scratch
    rc = _entry("gru_seq_fwd_f32", 9)(
        proj.data_ptr(), mask.data_ptr(), w_hzr.data_ptr(), w_hc.data_ptr(),
        bias.data_ptr(), h0.data_ptr(), hs.data_ptr(), zrc.data_ptr(),
        rh.data_ptr(), t, b, h, int(reverse), _stream(proj),
    )
    if rc != 0:
        raise RuntimeError(f"gru_seq forward kernel launch failed: CUDA error {rc}")
    FWD_LAUNCHES += 1
    return hs, zrc


def gru_seq_bwd(zrc, hs, h0, mask, w_hzr, w_hc, dhs, dh_last, reverse: bool = False):
    """One launch of the backward entry point (recurrent walk, dW reduction
    and db column sum) -> (dproj, dW_zr, dW_c, db, dh0)."""
    global BWD_LAUNCHES
    t, b, h3 = zrc.shape
    h = h3 // 3
    for name, x, shape in (("hs", hs, (t, b, h)), ("h0", h0, (b, h)),
                           ("mask", mask, (t, b)), ("w_hzr", w_hzr, (h, 2 * h)),
                           ("w_hc", w_hc, (h, h)), ("dhs", dhs, (t, b, h)),
                           ("dh_last", dh_last, (b, h))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {list(x.shape)}")
    _check_tensors(zrc=zrc, hs=hs, h0=h0, mask=mask, w_hzr=w_hzr, w_hc=w_hc,
                   dhs=dhs, dh_last=dh_last)
    dev = zrc.device
    dproj = torch.empty((t, b, h3), dtype=torch.float32, device=dev)
    dwzr = torch.empty((h, 2 * h), dtype=torch.float32, device=dev)
    dwc = torch.empty((h, h), dtype=torch.float32, device=dev)
    db = torch.empty((h3,), dtype=torch.float32, device=dev)
    dh0 = torch.empty((b, h), dtype=torch.float32, device=dev)
    # double-buffered dgc [2, B, H] and dgzr [2, B, 2H]
    scratch = torch.empty((6 * b * h,), dtype=torch.float32, device=dev)
    rc = _entry("gru_seq_bwd_f32", 14)(
        zrc.data_ptr(), hs.data_ptr(), h0.data_ptr(), mask.data_ptr(),
        w_hzr.data_ptr(), w_hc.data_ptr(), dhs.data_ptr(), dh_last.data_ptr(),
        dproj.data_ptr(), dwzr.data_ptr(), dwc.data_ptr(), db.data_ptr(),
        dh0.data_ptr(), scratch.data_ptr(), t, b, h, int(reverse), _stream(zrc),
    )
    if rc != 0:
        raise RuntimeError(f"gru_seq backward kernel launch failed: CUDA error {rc}")
    BWD_LAUNCHES += 1
    return dproj, dwzr, dwc, db, dh0


# -- autograd ----------------------------------------------------------------


def _kernel_ready(x: torch.Tensor) -> torch.Tensor:
    """f32, contiguous and 16-byte aligned (a view into the middle of a
    tensor may not be), copying only when it is not."""
    x = x.float().contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _on(device: torch.device, what: str) -> bool:
    """True for CUDA (kernels), False for CPU (plain versions); raises for
    anything else."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"{what} runs on CUDA (kernel) or CPU (plain version); got {device}")


class GruSeqFused(torch.autograd.Function):
    """(proj, mask, w_hzr, w_hc, bias, h0) -> (hs, h_last), time-major. The
    mask's cotangent is None (zero)."""

    @staticmethod
    def forward(ctx, proj, mask, w_hzr, w_hc, bias, h0, reverse: bool):
        t = proj.shape[0]
        mask2 = _kernel_ready(mask.reshape(t, -1))
        p32, wzr32, wc32, b32, h032 = (
            _kernel_ready(x) for x in (proj, w_hzr, w_hc, bias, h0))
        if _on(proj.device, "gru_seq_fused"):
            hs, zrc = gru_seq_fwd(p32, mask2, wzr32, wc32, b32, h032, reverse)
        else:
            with torch.no_grad():
                hs, zrc = gru_seq_fused_ref(p32, mask2, wzr32, wc32, b32, h032, reverse)
        ctx.save_for_backward(zrc, hs, h032, mask2, wzr32, wc32)
        ctx.reverse = reverse
        ctx.dtypes = (proj.dtype, w_hzr.dtype, w_hc.dtype, bias.dtype, h0.dtype)
        h_last = (hs[0] if reverse else hs[-1]).clone()
        return hs, h_last

    @staticmethod
    def backward(ctx, dhs, dh_last):
        zrc, hs, h0, mask, w_hzr, w_hc = ctx.saved_tensors
        dhs, dh_last = _kernel_ready(dhs), _kernel_ready(dh_last)
        if _on(zrc.device, "gru_seq_fused"):
            grads = gru_seq_bwd(zrc, hs, h0, mask, w_hzr, w_hc, dhs, dh_last, ctx.reverse)
        else:
            grads = gru_seq_bwd_ref(zrc, hs, h0, mask, w_hzr, w_hc, dhs, dh_last,
                                    ctx.reverse)
        dproj, dwzr, dwc, db, dh0 = (g.to(dt) for g, dt in zip(grads, ctx.dtypes))
        return dproj, None, dwzr, dwc, db, dh0, None


def gru_seq_fused(
    proj: torch.Tensor, mask: torch.Tensor, w_hzr: torch.Tensor,
    w_hc: torch.Tensor, bias: torch.Tensor, h0: torch.Tensor,
    reverse: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Time-major fused GRU: proj [T,B,3H] (z, r, c), mask [T,B] or [T,B,1]
    -> (hs [T,B,H] f32, h_last [B,H]: the state after the last processed
    step, hs[0] when `reverse`)."""
    return GruSeqFused.apply(proj, mask, w_hzr, w_hc, bias, h0, reverse)
