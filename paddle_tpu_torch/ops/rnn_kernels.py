"""Whole-sequence GRU and LSTM and fused scaled-dot attention: the CUDA
kernels' wrappers, their plain PyTorch versions and the autograd.Functions
that join them.

Counterpart of `gru_seq_fused`, `lstm_seq_fused` and `attention_seq_fused`
in `paddle_tpu/ops/pallas/rnn_kernels.py`. The recurrences run the whole
time loop in one call over time-major [T, B, ...] arrays (`mask` [T,B]);
the forward saves the post-activation gates, and the backward is a
reverse-time walk that accumulates the weight and bias gradients and the
initial-state cotangents. `reverse=True` walks time backwards with every
array left in original time order, which equals the JAX package's flip,
run, flip (`_run_fused`).

  * GRU (`proj` [T,B,3H], gates z, r, c; saves `zrc` [T,B,3H]):
    `gru_seq_fused_ref` / `gru_seq_bwd_ref` are the plain versions, a loop
    over t of the gate math of `_gru_fwd_kernel` / `_gru_bwd_kernel`;
    `gru_seq_fwd` / `gru_seq_bwd` launch `csrc/gru_seq.cu`; `GruSeqFused`.
  * LSTM without peepholes (`proj` [T,B,4H], gates i, f, c, o; saves the
    gates [T,B,4H], c~ before the mask and the masked c sequence):
    `lstm_seq_fused_ref` / `lstm_seq_bwd_ref` (the gate math of
    `_lstm_fwd_kernel` / `_lstm_bwd_kernel`), `lstm_seq_fwd` /
    `lstm_seq_bwd` (`csrc/lstm_seq.cu`), `LstmSeqFused`.
  * Attention (q [B,Tq,D], k [B,Tk,D], v [B,Tk,Dv], a 0/1 mask [B,Mq,Tk],
    Mq in {1, Tq}): `attention_seq_fused_ref` is the oracle (`_attn_oracle`),
    `attention_seq_fwd` launches `csrc/attention_seq.cu`, and
    `AttentionSeqFused`'s backward differentiates the oracle, as
    `_attn_vjp_bwd` does; there is no backward kernel.

CPU tensors take the plain versions, CUDA tensors the kernels, or an error —
never the plain version on the card. All kernel math is f32; cotangents come
back in the primals' dtypes.

`FWD_LAUNCHES` / `BWD_LAUNCHES` (GRU), `LSTM_FWD_LAUNCHES` /
`LSTM_BWD_LAUNCHES` and `ATTN_LAUNCHES` count entry-point launches (never
plain-version calls). A call made while its stream is capturing a CUDA
graph (the training step's, `trainer/step_graph.py`) launches nothing: it
is counted in `CAPTURED` under the same name, and whoever replays the graph
adds what it captured to the counters on each replay (`note_replay`), since
a replay runs no Python. `gru_seq_plan` / `lstm_seq_plan` report the kernels'
layouts on the card, and `gru_seq_fwd_sync` / `lstm_seq_fwd_sync` run a
forward's grid syncs alone (a measuring probe, on no model's path)."""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from paddle_tpu_torch.ops import build

# kernel launches since import (or since a caller last set them to 0)
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
LSTM_FWD_LAUNCHES = 0
LSTM_BWD_LAUNCHES = 0
ATTN_LAUNCHES = 0
# calls recorded into CUDA graphs under capture, by counter name
CAPTURED = {"FWD_LAUNCHES": 0, "BWD_LAUNCHES": 0, "LSTM_FWD_LAUNCHES": 0,
            "LSTM_BWD_LAUNCHES": 0, "ATTN_LAUNCHES": 0}

# masked attention scores are replaced by this (ops/sequence.NEG_INF)
_ATTN_NEG_INF = -1e9


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
    _check_shapes(mask=(mask, (t, b)), w_hzr=(w_hzr, (h, 2 * h)),
                  w_hc=(w_hc, (h, h)), bias=(bias, (h3,)), h0=(h0, (b, h)))
    _check_tensors("GRU", proj=proj, mask=mask, w_hzr=w_hzr, w_hc=w_hc, bias=bias, h0=h0)
    return t, b, h


def _check_shapes(**named) -> None:
    """named = {name: (tensor, wanted shape)}; raises on the first mismatch."""
    for name, (x, shape) in named.items():
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} must be {list(shape)}, got {list(x.shape)}")


def _check_tensors(what: str, **tensors: torch.Tensor) -> None:
    dev = next(iter(tensors.values())).device
    if dev.type != "cuda":
        raise ValueError(f"the {what} kernels run on CUDA tensors, got {dev}")
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


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the recurrences' entry points end in (T, B, H, reverse, stream)
_RNN_TAIL = (_I, _I, _I, _I, _P)


def _entry(source: str, name: str, n_ptrs: int, tail=_RNN_TAIL, restype=ctypes.c_int):
    """A built, loaded entry point with every argument type declared:
    pointers and the stream c_void_p, sizes and flags c_int, a scale
    c_float (undeclared, ctypes would cut pointers to 32 bits and fail on
    floats)."""
    fn = getattr(build.load(source), name)
    if fn.argtypes is None:
        fn.argtypes = [_P] * n_ptrs + list(tail)
        fn.restype = restype
    return fn


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _count(name: str) -> None:
    """One entry-point call of the kernel counted as `name`: a launch, or a
    captured call where the current stream is capturing a graph (the
    autograd thread runs a backward on its forward's stream)."""
    if torch.cuda.is_current_stream_capturing():
        CAPTURED[name] += 1
    else:
        globals()[name] += 1


def note_replay(captured_calls: dict) -> None:
    """A CUDA graph holding `captured_calls` ({counter name: calls}, the
    growth of `CAPTURED` over its capture) was replayed: each of those
    calls launched its kernel once."""
    for name, n in captured_calls.items():
        globals()[name] += n


_PLAN_KEYS = ("fwd_units", "fwd_row_groups", "fwd_rows_per_group", "fwd_blocks",
              "fwd_w_resident", "bwd_units", "bwd_row_groups", "bwd_rows_per_group",
              "bwd_blocks", "bwd_w_resident", "dw_split_k", "scratch_floats")
_plans: dict = {}


def _plan_dict(values) -> dict:
    """`<source>_plan`'s numbers by name, the W-resident flags as bools."""
    plan = {k: int(v) for k, v in zip(_PLAN_KEYS, values, strict=True)}
    for k in ("fwd_w_resident", "bwd_w_resident"):
        plan[k] = bool(plan[k])
    return plan


# cudaErrorInvalidValue: what a plan entry point returns for a shape it
# cannot lay out
_NO_LAYOUT = 1


def _call_plan(source: str, index: int, t: int, b: int, h: int):
    """One call of the C entry point `<source>_plan` on card `index` ->
    (return code, its numbers)."""
    out = (ctypes.c_longlong * len(_PLAN_KEYS))()
    fn = _entry(source, f"{source}_plan", 0, (_I, _I, _I, _P))
    with torch.cuda.device(index):
        rc = fn(t, b, h, out)
    return rc, out


def _plan_entry(source: str, t: int, b: int, h: int, device=None):
    """(return code, numbers or None) of `<source>_plan` for (T, B, H) on
    `device`'s card, read once per (card, shape)."""
    dev = torch.device("cuda" if device is None else device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    key = (source, index, t, b, h)
    got = _plans.get(key)
    if got is None:
        rc, out = _call_plan(source, index, t, b, h)
        got = _plans[key] = (rc, _plan_dict(out) if rc == 0 else None)
    return got


def _plan(source: str, t: int, b: int, h: int, device=None) -> dict:
    """The layouts `<source>_plan` chooses for (T, B, H) on `device`'s card.
    The forward and the backward walk are each a grid of (row group, unit
    group) blocks, one per SM at most: units per block, row groups, rows
    per group, blocks and whether the block's W stays resident in shared
    memory (else it is staged per k tile), as `fwd_*` and `bwd_*`; then
    the dW reduction's split of the T*B rows and the scratch floats the
    backward takes. Raises where no layout exists. Cached per (card,
    shape)."""
    rc, plan = _plan_entry(source, t, b, h, device)
    if rc != 0:
        raise ValueError(f"the {source} kernels have no layout for T={t}, B={b}, H={h} "
                         f"on this card (CUDA error {rc})")
    return dict(plan)


def _seq_fits(source: str, h: int, b: int, t: int, device=None) -> bool:
    """Whether both `<source>` kernels (forward and backward) have a layout
    for (T, B, H) on `device`'s card: the return code of `<source>_plan`,
    cached as `_plan` is. False where the plan has no layout (a row group's
    per-cell state outgrows a block's shared memory at large B*H); any
    other CUDA error raises."""
    rc, _ = _plan_entry(source, t, b, h, device)
    if rc not in (0, _NO_LAYOUT):
        raise RuntimeError(f"{source}_plan failed: CUDA error {rc}")
    return rc == 0


def _fwd_sync(source: str, t: int, b: int, h: int, device=None) -> None:
    """Launch `<source>_fwd_sync_f32`: the forward's step loop for (T, B, H)
    with nothing but its grid syncs, on the forward's own grid, on the
    current stream of `device`'s card. A measuring probe (chip_smoke.py
    times it beside the forward), never on a model's path."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError(f"the {source} sync probe runs on a CUDA device, got {dev}")
    fn = _entry(source, f"{source}_fwd_sync_f32", 0, (_I, _I, _I, _P))
    with torch.cuda.device(dev):
        rc = fn(t, b, h, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{source} sync probe launch failed: CUDA error {rc}")


def gru_seq_plan(h: int, b: int, t: int = 1, device=None) -> dict:
    """How the GRU kernels lay out hidden size `h` at batch `b` (and `t`
    steps) on the current card; see `_plan`. Raises where no layout
    exists."""
    return _plan("gru_seq", t, b, h, device)


def gru_seq_fits(h: int, b: int, t: int = 1, device=None) -> bool:
    """Whether the GRU kernels lay out (T, B, H) on the card; see
    `_seq_fits`. `ops/rnn.gru_scan` routes a CUDA tensor by it."""
    return _seq_fits("gru_seq", h, b, t, device)


def gru_seq_fwd_sync(h: int, b: int, t: int, device=None) -> None:
    """The GRU forward's two grid syncs per step alone, T steps at its grid
    for (H, B); see `_fwd_sync`."""
    _fwd_sync("gru_seq", t, b, h, device)


def gru_seq_fwd(proj, mask, w_hzr, w_hc, bias, h0, reverse: bool = False):
    """One launch of the forward kernel -> (hs [T,B,H], zrc [T,B,3H])."""
    t, b, h = check_inputs(proj, mask, w_hzr, w_hc, bias, h0)
    hs = torch.empty((t, b, h), dtype=torch.float32, device=proj.device)
    zrc = torch.empty((t, b, 3 * h), dtype=torch.float32, device=proj.device)
    rh = torch.empty((b, h), dtype=torch.float32, device=proj.device)  # r*h scratch
    rc = _entry("gru_seq", "gru_seq_fwd_f32", 9)(
        proj.data_ptr(), mask.data_ptr(), w_hzr.data_ptr(), w_hc.data_ptr(),
        bias.data_ptr(), h0.data_ptr(), hs.data_ptr(), zrc.data_ptr(),
        rh.data_ptr(), t, b, h, int(reverse), _stream(proj),
    )
    if rc != 0:
        raise RuntimeError(f"gru_seq forward kernel launch failed: CUDA error {rc}")
    _count("FWD_LAUNCHES")
    return hs, zrc


def gru_seq_bwd(zrc, hs, h0, mask, w_hzr, w_hc, dhs, dh_last, reverse: bool = False):
    """One call of the backward entry point (the recurrent walk, then the
    split-K dW/db reduction) -> (dproj, dW_zr, dW_c, db, dh0)."""
    t, b, h3 = zrc.shape
    h = h3 // 3
    _check_shapes(hs=(hs, (t, b, h)), h0=(h0, (b, h)), mask=(mask, (t, b)),
                  w_hzr=(w_hzr, (h, 2 * h)), w_hc=(w_hc, (h, h)),
                  dhs=(dhs, (t, b, h)), dh_last=(dh_last, (b, h)))
    _check_tensors("GRU", zrc=zrc, hs=hs, h0=h0, mask=mask, w_hzr=w_hzr, w_hc=w_hc,
                   dhs=dhs, dh_last=dh_last)
    dev = zrc.device
    dproj = torch.empty((t, b, h3), dtype=torch.float32, device=dev)
    dwzr = torch.empty((h, 2 * h), dtype=torch.float32, device=dev)
    dwc = torch.empty((h, h), dtype=torch.float32, device=dev)
    db = torch.empty((h3,), dtype=torch.float32, device=dev)
    dh0 = torch.empty((b, h), dtype=torch.float32, device=dev)
    # the dW reduction's partial sums and its list of valid rows
    scratch = torch.empty((gru_seq_plan(h, b, t, dev)["scratch_floats"],),
                          dtype=torch.float32, device=dev)
    rc = _entry("gru_seq", "gru_seq_bwd_f32", 14)(
        zrc.data_ptr(), hs.data_ptr(), h0.data_ptr(), mask.data_ptr(),
        w_hzr.data_ptr(), w_hc.data_ptr(), dhs.data_ptr(), dh_last.data_ptr(),
        dproj.data_ptr(), dwzr.data_ptr(), dwc.data_ptr(), db.data_ptr(),
        dh0.data_ptr(), scratch.data_ptr(), t, b, h, int(reverse), _stream(zrc),
    )
    if rc != 0:
        raise RuntimeError(f"gru_seq backward kernel launch failed: CUDA error {rc}")
    _count("BWD_LAUNCHES")
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


# ============================================================================
# LSTM (no peepholes)
# ============================================================================


def lstm_seq_fused_ref(
    proj: torch.Tensor,   # [T, B, 4H] gate blocks i, f, c, o
    mask: torch.Tensor,   # [T, B] (or [T, B, 1])
    w_hh: torch.Tensor,   # [H, 4H]
    bias: torch.Tensor,   # [4H]
    h0: torch.Tensor,     # [B, H]
    c0: torch.Tensor,     # [B, H]
    reverse: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """The plain forward -> (hs [T,B,H], gates [T,B,4H] post-activation,
    ct [T,B,H] = c~ before the mask, cs [T,B,H] masked cells), f32,
    differentiable by autograd."""
    t_len, _, h4 = proj.shape
    hdim = h4 // 4
    proj, w_hh, bias = (x.float() for x in (proj, w_hh, bias))
    mask = mask.float().reshape(t_len, -1, 1)
    h, c = h0.float(), c0.float()
    hs, gates, ct, cs = ([None] * t_len for _ in range(4))
    for t in _time_order(t_len, reverse):
        g = proj[t] + h @ w_hh + bias
        i = torch.sigmoid(g[:, :hdim])
        f = torch.sigmoid(g[:, hdim:2 * hdim])
        cand = torch.tanh(g[:, 2 * hdim:3 * hdim])
        o = torch.sigmoid(g[:, 3 * hdim:])
        c_tilde = f * c + i * cand
        h_tilde = o * torch.tanh(c_tilde)
        m = mask[t]
        h = m * h_tilde + (1.0 - m) * h
        c = m * c_tilde + (1.0 - m) * c
        gates[t] = torch.cat([i, f, cand, o], dim=-1)
        ct[t], cs[t], hs[t] = c_tilde, c, h
    return torch.stack(hs), torch.stack(gates), torch.stack(ct), torch.stack(cs)


def lstm_seq_bwd_ref(
    gates: torch.Tensor,    # [T, B, 4H] saved post-activation gates
    ct: torch.Tensor,       # [T, B, H] saved c~ (before the mask)
    hs: torch.Tensor,       # [T, B, H] saved outputs
    cs: torch.Tensor,       # [T, B, H] saved masked cells
    h0: torch.Tensor,
    c0: torch.Tensor,
    mask: torch.Tensor,     # [T, B] (or [T, B, 1])
    w_hh: torch.Tensor,
    dhs: torch.Tensor,      # [T, B, H]
    dh_last: torch.Tensor,  # [B, H]
    dc_last: torch.Tensor,  # [B, H]
    reverse: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """The plain backward: the reverse walk of `_lstm_bwd_kernel` over the
    saved residuals -> (dproj [T,B,4H], dW [H,4H], db [4H], dh0, dc0), f32.
    h_prev and c_prev of a step are the outputs of the step processed
    before it (h0, c0 at the first); c_prev is the MASKED cell."""
    t_len, b, h4 = gates.shape
    hdim = h4 // 4
    w_hh = w_hh.float()
    mask = mask.float().reshape(t_len, b, 1)
    h_prev = _h_prev_seq(hs.float(), h0.float(), reverse)
    c_prev = _h_prev_seq(cs.float(), c0.float(), reverse)
    dproj = torch.empty_like(gates, dtype=torch.float32)
    dw = torch.zeros_like(w_hh)
    db = torch.zeros(h4, dtype=torch.float32, device=gates.device)
    dh_carry, dc_carry = dh_last.float(), dc_last.float()
    for t in reversed(list(_time_order(t_len, reverse))):
        i, f, cand, o = (gates[t, :, k * hdim:(k + 1) * hdim] for k in range(4))
        m = mask[t]
        dh = dh_carry + dhs[t]
        dc = dc_carry
        tanh_ct = torch.tanh(ct[t])
        dh_tilde = m * dh
        dc_tilde = m * dc + dh_tilde * o * (1.0 - tanh_ct * tanh_ct)
        dgates = torch.cat([
            dc_tilde * cand * i * (1.0 - i),
            dc_tilde * c_prev[t] * f * (1.0 - f),
            dc_tilde * i * (1.0 - cand * cand),
            dh_tilde * tanh_ct * o * (1.0 - o),
        ], dim=-1)
        dproj[t] = dgates
        dh_carry = dgates @ w_hh.T + (1.0 - m) * dh
        dc_carry = dc_tilde * f + (1.0 - m) * dc
        dw = dw + h_prev[t].T @ dgates
        db = db + dgates.sum(dim=0)
    return dproj, dw, db, dh_carry, dc_carry


def check_lstm_inputs(proj, mask, w_hh, bias, h0, c0) -> Tuple[int, int, int]:
    """Raise on anything the LSTM kernels do not take: f32, contiguous, one
    CUDA device, 16-byte aligned, proj [T,B,4H], mask [T,B], w_hh [H,4H],
    bias [4H], h0 and c0 [B,H]. Returns (T, B, H)."""
    if proj.dim() != 3 or proj.shape[2] % 4:
        raise ValueError(f"proj must be [T, B, 4H], got {tuple(proj.shape)}")
    t, b, h4 = proj.shape
    h = h4 // 4
    _check_shapes(mask=(mask, (t, b)), w_hh=(w_hh, (h, h4)), bias=(bias, (h4,)),
                  h0=(h0, (b, h)), c0=(c0, (b, h)))
    _check_tensors("LSTM", proj=proj, mask=mask, w_hh=w_hh, bias=bias, h0=h0, c0=c0)
    return t, b, h


def lstm_seq_plan(h: int, b: int, t: int = 1, device=None) -> dict:
    """How the LSTM kernels lay out hidden size `h` at batch `b` (and `t`
    steps, for the dW reduction) on the current card; see `_plan`. Raises
    where no layout exists."""
    return _plan("lstm_seq", t, b, h, device)


def lstm_seq_fits(h: int, b: int, t: int = 1, device=None) -> bool:
    """Whether the LSTM kernels lay out (T, B, H) on the card; see
    `_seq_fits`. `ops/rnn.lstm_scan` routes a CUDA tensor by it."""
    return _seq_fits("lstm_seq", h, b, t, device)


def lstm_seq_fwd_sync(h: int, b: int, t: int, device=None) -> None:
    """The LSTM forward's one grid sync per step alone, T steps at its grid
    for (H, B); see `_fwd_sync`."""
    _fwd_sync("lstm_seq", t, b, h, device)


def lstm_seq_fwd(proj, mask, w_hh, bias, h0, c0, reverse: bool = False):
    """One launch of the forward kernel -> (hs, gates, ct, cs)."""
    t, b, h = check_lstm_inputs(proj, mask, w_hh, bias, h0, c0)
    dev = proj.device
    hs, ct, cs = (torch.empty((t, b, h), dtype=torch.float32, device=dev) for _ in range(3))
    gates = torch.empty((t, b, 4 * h), dtype=torch.float32, device=dev)
    rc = _entry("lstm_seq", "lstm_seq_fwd_f32", 10)(
        proj.data_ptr(), mask.data_ptr(), w_hh.data_ptr(), bias.data_ptr(),
        h0.data_ptr(), c0.data_ptr(), hs.data_ptr(), gates.data_ptr(),
        ct.data_ptr(), cs.data_ptr(), t, b, h, int(reverse), _stream(proj),
    )
    if rc != 0:
        raise RuntimeError(f"lstm_seq forward kernel launch failed: CUDA error {rc}")
    _count("LSTM_FWD_LAUNCHES")
    return hs, gates, ct, cs


def lstm_seq_bwd(gates, ct, hs, cs, h0, c0, mask, w_hh, dhs, dh_last, dc_last,
                 reverse: bool = False):
    """One call of the backward entry point (the recurrent walk, then the
    split-K dW/db reduction) -> (dproj, dW, db, dh0, dc0)."""
    t, b, h4 = gates.shape
    h = h4 // 4
    seq, state = (t, b, h), (b, h)
    _check_shapes(ct=(ct, seq), hs=(hs, seq), cs=(cs, seq), h0=(h0, state),
                  c0=(c0, state), mask=(mask, (t, b)), w_hh=(w_hh, (h, h4)),
                  dhs=(dhs, seq), dh_last=(dh_last, state), dc_last=(dc_last, state))
    _check_tensors("LSTM", gates=gates, ct=ct, hs=hs, cs=cs, h0=h0, c0=c0, mask=mask,
                   w_hh=w_hh, dhs=dhs, dh_last=dh_last, dc_last=dc_last)
    dev = gates.device
    dproj = torch.empty((t, b, h4), dtype=torch.float32, device=dev)
    dw = torch.empty((h, h4), dtype=torch.float32, device=dev)
    db = torch.empty((h4,), dtype=torch.float32, device=dev)
    dh0 = torch.empty(state, dtype=torch.float32, device=dev)
    dc0 = torch.empty(state, dtype=torch.float32, device=dev)
    # the dW reduction's partial sums and its list of valid rows
    scratch = torch.empty((lstm_seq_plan(h, b, t, dev)["scratch_floats"],),
                          dtype=torch.float32, device=dev)
    rc = _entry("lstm_seq", "lstm_seq_bwd_f32", 17)(
        gates.data_ptr(), ct.data_ptr(), hs.data_ptr(), cs.data_ptr(), h0.data_ptr(),
        c0.data_ptr(), mask.data_ptr(), w_hh.data_ptr(), dhs.data_ptr(),
        dh_last.data_ptr(), dc_last.data_ptr(), dproj.data_ptr(), dw.data_ptr(),
        db.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), scratch.data_ptr(), t, b, h,
        int(reverse), _stream(gates),
    )
    if rc != 0:
        raise RuntimeError(f"lstm_seq backward kernel launch failed: CUDA error {rc}")
    _count("LSTM_BWD_LAUNCHES")
    return dproj, dw, db, dh0, dc0


class LstmSeqFused(torch.autograd.Function):
    """(proj, mask, w_hh, bias, h0, c0) -> (hs, h_last, c_last),
    time-major. The mask's cotangent is None (zero)."""

    @staticmethod
    def forward(ctx, proj, mask, w_hh, bias, h0, c0, reverse: bool):
        t = proj.shape[0]
        mask2 = _kernel_ready(mask.reshape(t, -1))
        p32, w32, b32, h032, c032 = (_kernel_ready(x) for x in (proj, w_hh, bias, h0, c0))
        if _on(proj.device, "lstm_seq_fused"):
            hs, gates, ct, cs = lstm_seq_fwd(p32, mask2, w32, b32, h032, c032, reverse)
        else:
            with torch.no_grad():
                hs, gates, ct, cs = lstm_seq_fused_ref(p32, mask2, w32, b32, h032, c032,
                                                       reverse)
        ctx.save_for_backward(gates, ct, hs, cs, h032, c032, mask2, w32)
        ctx.reverse = reverse
        ctx.dtypes = (proj.dtype, w_hh.dtype, bias.dtype, h0.dtype, c0.dtype)
        last = 0 if reverse else -1
        return hs, hs[last].clone(), cs[last].clone()

    @staticmethod
    def backward(ctx, dhs, dh_last, dc_last):
        saved = ctx.saved_tensors
        grads = (_kernel_ready(g) for g in (dhs, dh_last, dc_last))
        if _on(saved[0].device, "lstm_seq_fused"):
            out = lstm_seq_bwd(*saved, *grads, ctx.reverse)
        else:
            out = lstm_seq_bwd_ref(*saved, *grads, ctx.reverse)
        dproj, dw, db, dh0, dc0 = (g.to(dt) for g, dt in zip(out, ctx.dtypes))
        return dproj, None, dw, db, dh0, dc0, None


def lstm_seq_fused(
    proj: torch.Tensor, mask: torch.Tensor, w_hh: torch.Tensor, bias: torch.Tensor,
    h0: torch.Tensor, c0: torch.Tensor, reverse: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Time-major fused LSTM: proj [T,B,4H] (i, f, c, o), mask [T,B] or
    [T,B,1] -> (hs [T,B,H] f32, h_last, c_last [B,H]: the state after the
    last processed step, hs[0] / cs[0] when `reverse`)."""
    return LstmSeqFused.apply(proj, mask, w_hh, bias, h0, c0, reverse)


# ============================================================================
# Fused scaled-dot attention forward
# ============================================================================


def attention_seq_fused_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            mask: torch.Tensor, scale: float) -> torch.Tensor:
    """The oracle (`_attn_oracle`): scores kept where mask > 0 and replaced
    by -1e9 elsewhere, an f32 softmax, the weights cast to v's dtype, and
    the output in v's dtype. Differentiable by autograd."""
    logits = torch.einsum("bqd,bkd->bqk", q, k) * scale
    logits = torch.where(mask > 0, logits, _ATTN_NEG_INF)
    w = torch.softmax(logits.float(), dim=-1).to(v.dtype)
    return torch.einsum("bqk,bkv->bqv", w, v)


def attention_seq_fwd(q, k, v, mask, scale: float) -> torch.Tensor:
    """One launch of the forward kernel on f32 tensors -> out [B,Tq,Dv]
    f32. q [B,Tq,D], k [B,Tk,D], v [B,Tk,Dv], mask [B,Mq,Tk], Mq in
    {1, Tq}; any sizes (the kernel tiles D, Dv, Tq and Tk)."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 or mask.dim() != 3:
        raise ValueError("q, k, v and mask must be 3-d: [B,Tq,D], [B,Tk,D], "
                         "[B,Tk,Dv], [B,Mq,Tk]")
    b, tq, d = q.shape
    tk, dv = k.shape[1], v.shape[2]
    mq = mask.shape[1]
    if mq not in (1, tq):
        raise ValueError(f"mask must be [B, 1, Tk] or [B, Tq, Tk], got {list(mask.shape)}")
    _check_shapes(k=(k, (b, tk, d)), v=(v, (b, tk, dv)), mask=(mask, (b, mq, tk)))
    _check_tensors("attention", q=q, k=k, v=v, mask=mask)
    out = torch.empty((b, tq, dv), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        n = _entry("attention_seq", "attention_seq_scratch_floats", 0,
                   (_I, _I, _I, _I, _I, _I), ctypes.c_longlong)(b, tq, tk, d, dv, mq)
        if n < 0:
            raise RuntimeError(f"attention_seq launch plan failed: CUDA error {-n}")
        # the key splits' partials, where the kernel splits the keys
        scratch = torch.empty(n, dtype=torch.float32, device=q.device) if n else out
        rc = _entry("attention_seq", "attention_seq_fwd_f32", 6,
                    (ctypes.c_longlong, _I, _I, _I, _I, _I, _I, _F, _P))(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), n, b, tq, tk, d, dv, mq, float(scale), _stream(q),
        )
    if rc != 0:
        raise RuntimeError(f"attention_seq forward kernel launch failed: CUDA error {rc}")
    _count("ATTN_LAUNCHES")
    return out


class AttentionSeqFused(torch.autograd.Function):
    """(q, k, v, mask, scale) -> out in v's dtype. The forward runs in f32
    (the kernel on CUDA, the oracle on f32 copies on the CPU); the backward
    differentiates the oracle at the primals' dtypes, as `_attn_vjp_bwd`
    does. The mask's cotangent is None (zero)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale: float):
        args = [_kernel_ready(x) for x in (q, k, v, mask)]
        if _on(q.device, "attention_seq_fused"):
            out = attention_seq_fwd(*args, scale)
        else:
            out = attention_seq_fused_ref(*args, scale)
        ctx.save_for_backward(q, k, v, mask)
        ctx.scale = scale
        return out.to(v.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask = ctx.saved_tensors
        with torch.enable_grad():
            prim = [x.detach().requires_grad_(True) for x in (q, k, v)]
            out = attention_seq_fused_ref(*prim, mask, ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, prim, g.to(v.dtype))
        return dq, dk, dv, None, None


def attention_seq_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor, scale: float) -> torch.Tensor:
    """Fused scaled-dot attention forward: q [B,Tq,D], k [B,Tk,D],
    v [B,Tk,Dv], mask [B,Mq,Tk] (0/1; Mq in {1, Tq}) -> [B,Tq,Dv] in v's
    dtype. `scale` is a Python number; the softmax is f32 whatever the
    input dtype."""
    return AttentionSeqFused.apply(q, k, v, mask.float(), float(scale))
