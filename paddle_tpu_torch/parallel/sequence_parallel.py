"""Sequence parallelism over the mesh's `seq` axis: ring attention and
Ulysses all-to-all (counterpart of `paddle_tpu/parallel/sequence_parallel.py`).

Both take this rank's shard [B, T_local, H, D] of q, k and v, the sequence
split over the axis in index order, and return this rank's shard of the
output; both are exact (not approximations) and hold against
`reference_attention` on the whole sequence.

- `ring_attention`: Q stays put; K and V (packed into one tensor) rotate
  around the axis' ring by send/recv (`Mesh.shift`, n - 1 times), while an
  online softmax (running max, numerator, denominator) accumulates in f32.
  The JAX package's `lax.ppermute` has a transpose; torch.distributed's
  send/recv has no autograd, so `_Ring.backward` walks the ring itself: the
  saved log-sum-exp gives each block's weights again, and each K/V block
  travels with its gradient accumulator, one more hop bringing the
  accumulator home (Liu et al., Ring Attention, 2023).
- `ulysses_attention`: one all-to-all (q, k and v stacked) swaps the split
  from the sequence to the heads, full attention runs on H/n heads, one
  all-to-all swaps back; their backward is the inverse swap
  (DeepSpeed-Ulysses, 2023).

The blocks' products run in plain torch, as the JAX package computes them in
`jnp.einsum`: no TPU kernel sits on this path."""

from __future__ import annotations

from typing import Optional

import torch

from paddle_tpu_torch.parallel.mesh import Mesh

NEG_INF = -1e30


def _mask_scores(scores: torch.Tensor,        # [B, H, Tq, Tk]
                 q_pos: torch.Tensor,         # [Tq] global positions
                 k_pos: torch.Tensor,         # [Tk] global positions
                 lengths: Optional[torch.Tensor],  # [B]
                 causal: bool) -> torch.Tensor:
    if causal:
        scores = torch.where(k_pos[None, None, None, :] > q_pos[None, None, :, None],
                             NEG_INF, scores)
    if lengths is not None:
        valid = k_pos[None, :] < lengths.to(k_pos.device)[:, None]  # [B, Tk]
        scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    return scores


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, D] -> [B, H, T, D] in f32."""
    return x.transpose(1, 2).float()


def _lengths(lengths, device) -> Optional[torch.Tensor]:
    return None if lengths is None else torch.as_tensor(lengths, device=device).long()


class _Ring(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, lengths, causal, scale):
        n, my = mesh.extent(axis), mesh.index(axis)
        b, tq, h, d = q.shape
        tk = k.shape[1]
        dev = q.device
        q_pos = my * tq + torch.arange(tq, device=dev)
        qh = _heads_first(q) * scale
        m = torch.full((b, h, tq), NEG_INF, dtype=torch.float32, device=dev)
        num = torch.zeros((b, h, tq, v.shape[-1]), dtype=torch.float32, device=dev)
        den = torch.zeros((b, h, tq), dtype=torch.float32, device=dev)
        kv = torch.stack([k, v])
        for i in range(n):
            src = (my + i) % n  # which global block kv holds now
            k_pos = src * tk + torch.arange(tk, device=dev)
            s = _mask_scores(qh @ _heads_first(kv[0]).transpose(-1, -2), q_pos, k_pos,
                             lengths, causal)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            num = num * alpha[..., None] + p @ _heads_first(kv[1])
            den = den * alpha + p.sum(-1)
            m = m_new
            if i < n - 1:
                (kv,) = mesh.shift([kv], axis, -1)  # block i+1 arrives from the next rank
        den = torch.clamp(den, min=1e-20)
        out = (num / den[..., None]).transpose(1, 2).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, m + torch.log(den))
        ctx.mesh, ctx.axis, ctx.lengths, ctx.causal, ctx.scale = (
            mesh, axis, lengths, causal, scale)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, axis, scale = ctx.mesh, ctx.axis, ctx.scale
        n, my = mesh.extent(axis), mesh.index(axis)
        tq, tk = q.shape[1], k.shape[1]
        dev = q.device
        q_pos = my * tq + torch.arange(tq, device=dev)
        qh = _heads_first(q) * scale
        do = _heads_first(d_out)
        delta = (do * _heads_first(out)).sum(-1)  # [B, H, Tq]
        dq = torch.zeros_like(qh)
        # K, V and their gradient accumulators travel together, f32
        blk = torch.stack([_heads_first(k), _heads_first(v),
                           torch.zeros_like(_heads_first(k)), torch.zeros_like(_heads_first(v))])
        for i in range(n):
            src = (my + i) % n
            k_pos = src * tk + torch.arange(tk, device=dev)
            kh, vh = blk[0], blk[1]
            s = qh @ kh.transpose(-1, -2)
            masked = _mask_scores(s, q_pos, k_pos, ctx.lengths, ctx.causal)
            p = torch.exp(masked - lse[..., None])
            ds = p * (do @ vh.transpose(-1, -2) - delta[..., None])
            # a masked score is a constant: no gradient reaches q or k there
            ds = torch.where(masked == NEG_INF, 0.0, ds)
            dq = dq + ds @ kh
            blk = torch.stack([kh, vh, blk[2] + ds.transpose(-1, -2) @ qh,
                               blk[3] + p.transpose(-1, -2) @ do])
            if i < n - 1:
                (blk,) = mesh.shift([blk], axis, -1)
        # one more hop brings each block's accumulators home
        (dkv,) = mesh.shift([blk[2:]], axis, -1)
        dq = (dq * scale).transpose(1, 2).to(q.dtype)
        dk = dkv[0].transpose(1, 2).to(k.dtype)
        dv = dkv[1].transpose(1, 2).to(v.dtype)
        return dq, dk, dv, None, None, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                   axis: str = "seq", lengths: Optional[torch.Tensor] = None,
                   causal: bool = False, scale: Optional[float] = None) -> torch.Tensor:
    """Exact blockwise attention with K/V rotating over the ring; q, k, v
    are this rank's [B, T_local, H, D] shards, `lengths` [B] the valid key
    lengths (the same on every rank)."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    return _Ring.apply(q, k, v, mesh, axis, _lengths(lengths, q.device), causal, scale)


def _seq_to_heads(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """[..., B, T_loc, H, D] -> [..., B, T, H/n, D]: the all-to-all that
    swaps the split from the sequence to the heads."""
    n = mesh.extent(axis)
    *lead, b, tl, h, d = x.shape
    parts = x.reshape(*lead, b, tl, n, h // n, d).movedim(-3, 0).contiguous()
    got = mesh.all_to_all(parts.reshape(n, -1), axis).reshape(parts.shape)
    # row j now holds sequence block j of this rank's heads
    return got.movedim(0, -4).reshape(*lead, b, n * tl, h // n, d)


def _heads_to_seq(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The inverse of `_seq_to_heads`: [..., B, T, H/n, D] -> [..., B,
    T_loc, H, D]."""
    n = mesh.extent(axis)
    *lead, b, t, hl, d = x.shape
    parts = x.reshape(*lead, b, n, t // n, hl, d).movedim(-4, 0).contiguous()
    got = mesh.all_to_all(parts.reshape(n, -1), axis).reshape(parts.shape)
    # row j now holds this rank's sequence block of head group j
    return got.movedim(0, -3).reshape(*lead, b, t // n, n * hl, d)


class _Swap(torch.autograd.Function):
    """An all-to-all swap whose backward is the inverse swap."""

    @staticmethod
    def forward(ctx, x, mesh, axis, to_heads):
        ctx.mesh, ctx.axis, ctx.to_heads = mesh, axis, to_heads
        return (_seq_to_heads if to_heads else _heads_to_seq)(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        back = _heads_to_seq if ctx.to_heads else _seq_to_heads
        return back(g.contiguous(), ctx.mesh, ctx.axis), None, None, None


def _attend(q, k, v, lengths, causal, scale):
    """[B, T, H, D] each -> the masked softmax attention, f32 inside."""
    t = q.shape[1]
    pos = torch.arange(t, device=q.device)
    s = (_heads_first(q) * scale) @ _heads_first(k).transpose(-1, -2)
    s = _mask_scores(s, pos, pos, lengths, causal)
    out = torch.softmax(s, -1) @ _heads_first(v)
    return out.transpose(1, 2).to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                      axis: str = "seq", lengths: Optional[torch.Tensor] = None,
                      causal: bool = False, scale: Optional[float] = None) -> torch.Tensor:
    """All-to-all head/sequence swap: full-T attention on H/n local heads;
    this rank's [B, T_local, H, D] shards in and out (H divisible by the
    axis)."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    n_seq = mesh.extent(axis)
    if q.shape[2] % n_seq != 0:
        raise ValueError(
            f"ulysses needs heads ({q.shape[2]}) divisible by mesh axis {axis!r} "
            f"({n_seq}); use ring_attention otherwise")
    qkv = _Swap.apply(torch.stack([q, k, v]), mesh, axis, True)
    out = _attend(qkv[0], qkv[1], qkv[2], _lengths(lengths, q.device), causal, scale)
    return _Swap.apply(out, mesh, axis, False)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lengths: Optional[torch.Tensor] = None, causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Single-device oracle (same math, no sharding)."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    return _attend(q, k, v, _lengths(lengths, q.device), causal, scale)
