"""Sequence-structure layers (counterpart of `paddle_tpu/nn/seq_layers.py`)
over padded [B, T, ...] batches with lengths, and nested [B, S, T, ...]
batches with lengths [B] (valid subsequences) and sub_lengths [B, S]:
`SeqPool` (sum, average/avg, max, sqrt; `agg_level="seq"` pools within
each subsequence, `stride` pools fixed windows), `LastSeq` and `FirstSeq`,
`Expand`, `SeqConcat`, `SeqReshape`, `SeqSlice`, `KmaxSeqScore`, `SubSeq`
and `SubNestedSeq`.

Where the JAX package maps a sequence op over the subsequences or windows
of axis 1 (`jax.vmap(fn, in_axes=1, out_axes=1)`), the port folds that axis
into the batch, applies the op once and unfolds it. Gathers clamp their
indices into range, as XLA clamps the JAX package's."""

from __future__ import annotations

from typing import Callable, List, Optional

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


def _nested(arg: Argument) -> bool:
    return arg.sub_lengths is not None and arg.value.dim() > 2


def _over_axis1(fn: Callable, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """`fn` over each slice of axis 1: x [B, S, T, ...] with lengths [B, S]
    -> [B, S, ...] (the JAX package's vmap over axis 1)."""
    b, s = x.shape[:2]
    out = fn(x.reshape((b * s,) + tuple(x.shape[2:])), lengths.reshape(-1))
    return out.reshape((b, s) + tuple(out.shape[1:]))


def _strided_windows(x: torch.Tensor, lengths: torch.Tensor, stride: int):
    """[B, T, ...] in windows of `stride` steps -> (windows [B, W, stride,
    ...], valid steps of each window [B, W] clamped to [1, stride], output
    lengths ceil(len / stride))."""
    b, t = x.shape[:2]
    n_win = -(-t // stride)
    pad = n_win * stride - t
    if pad:
        x = torch.cat([x, x.new_zeros((b, pad) + tuple(x.shape[2:]))], dim=1)
    win = x.reshape((b, n_win, stride) + tuple(x.shape[2:]))
    starts = torch.arange(n_win, device=x.device) * stride
    wlen = (lengths[:, None] - starts[None, :]).clamp(1, stride).to(lengths.dtype)
    return win, wlen, torch.div(lengths + stride - 1, stride, rounding_mode="floor")


def _gather_steps(x: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """`take_along_axis(x, idx, axis)` with idx over x's leading axes up to
    `axis` and broadcast over the feature axes after it."""
    idx = idx.long().reshape(tuple(idx.shape) + (1,) * (x.dim() - axis - 1))
    shape = tuple(idx.shape[:axis + 1]) + tuple(x.shape[axis + 1:])
    return torch.gather(x.expand(tuple(idx.shape[:axis]) + tuple(x.shape[axis:])),
                        axis, idx.expand(shape))


_POOL_FNS = {
    "sum": seq_ops.seq_sum,
    "average": seq_ops.seq_mean,
    "avg": seq_ops.seq_mean,
    "max": seq_ops.seq_max,
    "sqrt": seq_ops.seq_sqrt_pool,
}


class SeqPool(Layer):
    """SequencePoolLayer: pool over time -> [B, D]. `agg_level="seq"` pools
    each subsequence of a nested input -> a sequence [B, S, D] (a flat
    input gives a length-1 sequence); `stride` > 0 pools windows of
    `stride` steps -> a sequence of ceil(len / stride) window results."""

    type_name = "seq_pool"

    def __init__(self, input: Layer, pool_type: str = "sum", name: Optional[str] = None,
                 agg_level: str = "non-seq", stride: int = -1):
        super().__init__(input, name=name)
        if pool_type not in _POOL_FNS:
            raise ValueError(f"{self.name}: pool_type {pool_type!r} not in {sorted(_POOL_FNS)}")
        self.pool_type = pool_type
        self.agg_level = agg_level or "non-seq"
        self.stride = stride if stride and stride > 0 else -1

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        arg = ins[0]
        fn = _POOL_FNS[self.pool_type]
        if self.agg_level == "seq":
            if _nested(arg):
                return Argument(_over_axis1(fn, arg.value, arg.sub_lengths), arg.lengths)
            x, lengths = _seq_view(arg)
            return Argument(fn(x, lengths)[:, None], torch.ones_like(lengths))
        x, lengths = _seq_view(arg)
        if self.stride > 0:
            win, wlen, out_len = _strided_windows(x, lengths, self.stride)
            return Argument(_over_axis1(fn, win, wlen), out_len)
        return Argument(fn(x, lengths))


class _SeqInstance(Layer):
    """SequenceLastInstanceLayer (`select_first` picks the first step).
    `agg_level="seq"` picks one instance per subsequence of a nested input
    -> a sequence [B, S, ...]; on a nested input the default level spans
    the whole token stream (the last valid token of the last valid
    subsequence, or the first token of the first); `stride` > 0 picks one
    instance per window."""

    select_first = False

    def __init__(self, input: Layer, name: Optional[str] = None,
                 agg_level: str = "non-seq", stride: int = -1):
        super().__init__(input, name=name)
        self.agg_level = agg_level or "non-seq"
        self.stride = stride if stride and stride > 0 else -1

    def _pick(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        if self.select_first:
            return seq_ops.seq_first(x)
        return seq_ops.seq_last(x, lengths)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        arg = ins[0]
        if _nested(arg):
            if self.agg_level == "seq":
                return Argument(_over_axis1(self._pick, arg.value, arg.sub_lengths),
                                arg.lengths)
            if self.select_first:
                return Argument(seq_ops.seq_first(arg.value[:, 0]))
            rows = torch.arange(arg.value.shape[0], device=arg.value.device)
            s_idx = (arg.lengths.long() - 1).clamp(min=0)
            sub = arg.value[rows, s_idx]
            return Argument(seq_ops.seq_last(sub, arg.sub_lengths[rows, s_idx]))
        x, lengths = _seq_view(arg)
        if self.agg_level == "seq":
            return Argument(self._pick(x, lengths)[:, None], torch.ones_like(lengths))
        if self.stride > 0:
            win, wlen, out_len = _strided_windows(x, lengths, self.stride)
            return Argument(_over_axis1(self._pick, win, wlen), out_len)
        return Argument(self._pick(x, lengths))


class LastSeq(_SeqInstance):
    """The last valid step of each sequence."""

    type_name = "last_seq"
    select_first = False


class FirstSeq(_SeqInstance):
    """The first step of each sequence."""

    type_name = "first_seq"
    select_first = True


class Expand(Layer):
    """ExpandLayer: broadcast [B, D] across the time axis of the reference
    sequence `expand_as` -> [B, T, D]; onto a nested reference over both
    levels, or with `expand_level="seq"` one value a subsequence [B, S, D]
    across that subsequence's tokens."""

    type_name = "expand"

    def __init__(self, input: Layer, expand_as: Layer, name: Optional[str] = None,
                 expand_level: str = "non-seq"):
        super().__init__([input, expand_as], name=name)
        self.expand_level = expand_level or "non-seq"

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        x, ref = ins
        if not ref.is_seq:
            raise ValueError(f"{self.name}: expand needs a sequence to expand as")
        v = x.value
        if _nested(ref):
            s_max, t_max = ref.value.shape[1], ref.value.shape[2]
            if self.expand_level == "seq" and v.dim() == 3:
                out = v[:, :, None].expand(v.shape[:2] + (t_max,) + v.shape[2:])
            else:
                out = v[:, None, None].expand((v.shape[0], s_max, t_max) + v.shape[1:])
            return Argument(out, ref.lengths, ref.sub_lengths)
        return Argument(seq_ops.expand_to_seq(v, ref.lengths, ref.max_len), ref.lengths)


class SeqConcat(Layer):
    """SequenceConcatLayer: each row's valid steps of `a`, then its valid
    steps of `b`, in a [B, Ta + Tb, D] batch of lengths la + lb (zeros
    past them)."""

    type_name = "seq_concat"

    def __init__(self, a: Layer, b: Layer, name: Optional[str] = None):
        super().__init__([a, b], name=name)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        a, b = ins
        if not (a.is_seq and b.is_seq):
            raise ValueError(f"{self.name}: seq_concat needs two sequences")
        ta, tb = a.max_len, b.max_len
        dev = a.value.device
        av = a.value * a.mask(a.value.dtype)[:, :, None]
        bv = b.value * b.mask(b.value.dtype)[:, :, None]
        av = torch.cat([av, av.new_zeros((av.shape[0], tb) + tuple(av.shape[2:]))], dim=1)
        # output step j reads b's step j - la where that lies in [0, Tb)
        j = torch.arange(ta + tb, device=dev)[None, :] - a.lengths.long()[:, None]
        from_b = _gather_steps(bv, j.clamp(0, tb - 1), 1)
        in_b = ((j >= 0) & (j < tb))[:, :, None]
        out = av + torch.where(in_b, from_b, 0.0)
        return Argument(out, a.lengths + b.lengths)


class SeqReshape(Layer):
    """SequenceReshapeLayer: regroup the steps to width `reshape_size`
    (T * D = T' * D'); a row's length is ceil(len * D / D'), so a partial
    last step is kept, zero-padded."""

    type_name = "seq_reshape"

    def __init__(self, input: Layer, reshape_size: int, name: Optional[str] = None):
        super().__init__(input, name=name)
        self.reshape_size = reshape_size

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        arg = ins[0]
        b, t, d = arg.value.shape
        new_d = self.reshape_size
        if (t * d) % new_d:
            raise ValueError(f"{self.name}: {t}x{d} not divisible by {new_d}")
        out = arg.value.reshape(b, t * d // new_d, new_d)
        lengths = torch.div(arg.lengths * d + new_d - 1, new_d, rounding_mode="floor")
        return Argument(out, lengths)


class SeqSlice(Layer):
    """SequenceSliceLayer: the first or last `k` steps of each sequence, or
    [start, end] windows (end inclusive) from companion integer layers:
    K windows a row give a nested [B, K, T, ...] sequence; on a nested
    input they cut within each subsequence."""

    type_name = "seq_slice"

    def __init__(self, input: Layer, k: Optional[int] = None, from_start: bool = True,
                 starts: Optional[Layer] = None, ends: Optional[Layer] = None,
                 name: Optional[str] = None):
        extra = [l for l in (starts, ends) if l is not None]
        super().__init__([input] + extra, name=name)
        if k is None and not extra:
            raise ValueError(f"{name}: seq_slice needs k= or starts=/ends=")
        self.k = k
        self.from_start = from_start
        self.has_starts = starts is not None
        self.has_ends = ends is not None

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        arg = ins[0]
        x, lengths = arg.value, arg.lengths
        b, t = x.shape[:2]
        if self.has_starts or self.has_ends:
            nxt = 1
            starts = ends = None
            if self.has_starts:
                starts = ins[nxt].value.to(torch.int32)
                nxt += 1
            if self.has_ends:
                ends = ins[nxt].value.to(torch.int32)
            if arg.sub_lengths is not None and x.dim() > 3:
                t_sub = x.shape[2]
                sub_len = arg.sub_lengths
                if starts is None:
                    starts = torch.zeros_like(sub_len)
                if ends is None:
                    ends = sub_len - 1
                idx = starts[:, :, None] + torch.arange(t_sub, device=x.device)
                out = _gather_steps(x, idx.clamp(0, t_sub - 1), 2)
                return Argument(out, lengths, (ends - starts + 1).clamp(1, t_sub))
            if starts is None:
                starts = torch.zeros_like(ends)
            if ends is None:
                ends = lengths[:, None].expand(starts.shape).to(starts.dtype)
            k = starts.shape[1]
            idx = starts[:, :, None] + torch.arange(t, device=x.device)
            out = _gather_steps(x[:, None], idx.clamp(0, t - 1), 2)
            return Argument(out, torch.full((b,), k, dtype=torch.int32, device=x.device),
                            (ends - starts + 1).clamp(1, t))
        k = min(self.k, t)
        new_len = lengths.clamp(max=k)
        if self.from_start:
            return Argument(x[:, :k], new_len)
        start = (lengths.long() - k).clamp(min=0)
        idx = start[:, None] + torch.arange(k, device=x.device)
        return Argument(_gather_steps(x, idx.clamp(max=t - 1), 1), new_len)


class KmaxSeqScore(Layer):
    """KmaxSeqScoreLayer: int32 indices [B, beam_size] of the highest
    scores among each sequence's valid steps (ties and padding in index
    order, as `lax.top_k` gives them); on a nested input indices into its
    flattened [S * T] token grid."""

    type_name = "kmax_seq_score"

    def __init__(self, input: Layer, beam_size: int, name: Optional[str] = None):
        super().__init__(input, name=name)
        self.beam_size = beam_size

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        arg = ins[0]
        scores = arg.value
        dev = scores.device
        if arg.sub_lengths is not None and scores.dim() >= 3:
            if scores.dim() == 4:
                scores = scores[..., 0]
            b, s_max, t_max = scores.shape
            valid = ((torch.arange(s_max, device=dev)[None, :, None]
                      < arg.lengths[:, None, None])
                     & (torch.arange(t_max, device=dev)[None, None, :]
                        < arg.sub_lengths[:, :, None]))
            flat = torch.where(valid, scores, seq_ops.NEG_INF).reshape(b, -1)
        else:
            if scores.dim() == 3:
                scores = scores[..., 0]
            flat = torch.where(arg.mask(torch.bool), scores, seq_ops.NEG_INF)
        order = torch.sort(flat, dim=1, descending=True, stable=True).indices
        return Argument(order[:, :self.beam_size].to(torch.int32))


class SubSeq(Layer):
    """SubSequenceLayer: each row's window [offset, offset + size) from
    companion integer inputs, as a sequence of length min(size, T)."""

    type_name = "sub_seq"

    def __init__(self, input: Layer, offsets: Layer, sizes: Layer,
                 name: Optional[str] = None):
        super().__init__([input, offsets, sizes], name=name)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        arg, off_arg, size_arg = ins
        x = arg.value
        t = x.shape[1]
        offsets = off_arg.value.reshape(-1).to(torch.int32)
        sizes = size_arg.value.reshape(-1).to(torch.int32)
        idx = offsets[:, None] + torch.arange(t, device=x.device)
        return Argument(_gather_steps(x, idx.clamp(0, t - 1), 1), sizes.clamp(max=t))


class SubNestedSeq(Layer):
    """SubNestedSequenceLayer: keep the selected subsequences of a nested
    input. Inputs: nested [B, S, T, ...] with sub_lengths [B, S], and int
    subsequence ids [B, K] (-1 = none). Output [B, K, T, ...] (zeros where
    none), lengths = the selections made, sub_lengths gathered along
    them."""

    type_name = "sub_nested_seq"

    def __init__(self, input: Layer, selected_indices: Layer, name: Optional[str] = None):
        super().__init__([input, selected_indices], name=name)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        nested, sel = ins
        if nested.sub_lengths is None:
            raise ValueError(f"{self.name}: sub_nested_seq needs a nested-sequence "
                             f"input (Argument.sub_lengths set)")
        idx = sel.value.long()
        valid = idx >= 0
        safe = idx.clamp(0, nested.value.shape[1] - 1)
        out = _gather_steps(nested.value, safe, 1)
        out = out * valid.reshape(valid.shape + (1,) * (out.dim() - 2)).to(out.dtype)
        sub = torch.where(valid, torch.gather(nested.sub_lengths, 1, safe), 0)
        return Argument(out, valid.sum(1).to(torch.int32), sub.to(nested.sub_lengths.dtype))
