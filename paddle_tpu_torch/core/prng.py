"""jax.random's threefry generator in torch integer ops (the counterpart of
the `jax.random` calls the JAX package makes: `PRNGKey`, `fold_in`,
`split`, `bernoulli`, `uniform`, `normal`, `randint`, `gumbel`,
`categorical`).

The bits are jax's own, bit for bit: `threefry2x32` is the Threefry-2x32
hash of `jax/_src/prng.py` (20 rounds, key schedule k1, k2, k1^k2^0x1BD11BDA),
and `random_bits` is its partitionable form (`jax_threefry_partitionable`,
on by default in the jax this repository runs): element i of a shape draws
`threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))` and keeps the xor of the two
output words. A key is a [2] tensor of uint32 words held in int64 (torch
has no full uint32 arithmetic); every sum and rotation is masked back to 32
bits, so no value ever reaches int64's sign bit.

Everything is elementwise torch on the key's device: a key that lives on
the card, and a `fold_in` of a 0-d device counter, run inside a captured
CUDA graph, and replay to fresh bits as the counter moves. Nothing here
reads a device value on the host."""

from __future__ import annotations

import math
import struct
from typing import Sequence, Union

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_F32_BITS = 0x3F800000  # float32 1.0

Data = Union[int, torch.Tensor]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """Threefry-2x32 of the counter words (x1, x2) under the key (k1, k2),
    elementwise over broadcast int64 tensors of uint32 values -> (y1, y2)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def PRNGKey(seed: int, device=None) -> torch.Tensor:  # noqa: N802 (jax's name)
    """jax.random.PRNGKey(seed) with 32-bit jax: the words (0, seed mod 2^32)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data: Data) -> torch.Tensor:
    """jax.random.fold_in: a new key from `key` and a 32-bit `data` (a Python
    int, or a 0-d integer tensor on the key's device, e.g. the samples
    counter) -> threefry2x32(key, (0, data))."""
    if isinstance(data, torch.Tensor):
        d = data.to(torch.int64) & _MASK
    else:
        d = torch.full((), int(data) & _MASK, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(key[0], key[1], torch.zeros_like(d), d)
    return torch.stack([y1, y2])


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element of `shape` (int64 holding uint32 values),
    jax's partitionable threefry stream."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    if n >= 2 ** 32:
        raise NotImplementedError(f"random_bits of {n} elements: the counters' high "
                                  "word is not implemented")
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
    return (y1 ^ y2).reshape(shape)


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """jax.random.uniform in float32: the top 23 bits as the mantissa of a
    float in [1, 2), minus 1, scaled to [minval, maxval). The bounds are
    rounded to float32 and their span taken in float32, as jax does; XLA
    computes `floats * span + minval` as one fused multiply-add, rounded
    once, so the scaling runs in float64 (exact for the product of two
    float32 values) and rounds to float32 at the end."""
    bits = random_bits(key, shape)
    floats = ((bits >> 9) | _ONE_F32_BITS).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = _f32(minval), _f32(maxval)
    if lo == 0.0 and hi == 1.0:
        return floats
    scaled = (floats.double() * _f32(hi - lo) + lo).float()
    return torch.clamp_min(scaled, lo)


def _f32(v: float) -> float:
    """v rounded to the nearest float32."""
    return struct.unpack("f", struct.pack("f", v))[0]


def bernoulli(key: torch.Tensor, p: float, shape: Sequence[int]) -> torch.Tensor:
    """jax.random.bernoulli: a bool tensor, True with probability p (f32)."""
    return uniform(key, shape) < p


# float32's successor of -1.0 toward 0 (np.nextafter(-1, 0) in f32), jax's
# lower bound for the uniform under `normal`
_NORMAL_LO = -1.0 + 2.0 ** -24


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """jax.random.normal in float32: sqrt(2) * erfinv(u), u uniform in
    [nextafter(-1, 0), 1). The uniform bits are jax's; torch's erfinv and
    XLA's agree to float32 rounding, not bit for bit."""
    return math.sqrt(2.0) * torch.erfinv(uniform(key, shape, _NORMAL_LO, 1.0))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split under the partitionable threefry: key i of the [num, 2]
    result is threefry2x32(key, (0, i)), the same words `fold_in(key, i)`
    gives."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(key[0], key[1], torch.zeros_like(i), i)
    return torch.stack([y1, y2], dim=1)


def randint(key: torch.Tensor, shape: Sequence[int], minval: int, maxval: int) -> torch.Tensor:
    """jax.random.randint for int32 (jax's default int): two 32-bit draws, one
    from each half of `split(key)`, combined as (hi mod span) * (2^32 mod
    span) + (lo mod span), all mod span, in uint32 arithmetic (each product
    wraps at 32 bits, as XLA's does) -> an int64 tensor in [minval, maxval)."""
    lo_i32, hi_i32 = -2 ** 31, 2 ** 31 - 1
    minval = min(max(int(minval), lo_i32), hi_i32)
    out_of_range = int(maxval) > hi_i32
    maxval = min(max(int(maxval), lo_i32), hi_i32)
    span = (maxval - minval) & _MASK
    if maxval <= minval:
        span = 1
    elif out_of_range:
        span = (span + 1) & _MASK
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    if span == 0:  # 2^32 wrapped: XLA's x rem 0 is x, so the offset is `lower`
        offset = lower
    else:
        multiplier = (((1 << 16) % span) ** 2 & _MASK) % span
        offset = (((higher % span) * multiplier) & _MASK) + (lower % span)
        offset = (offset & _MASK) % span
    return (minval + offset + 2 ** 31) % 2 ** 32 - 2 ** 31


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """jax.random.gumbel in float32 (its default low-range mode):
    -log(-log(u)), u uniform in [float32 tiny, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(uniform(key, shape, tiny, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """jax.random.categorical over the last axis of 1-D `logits` [C], with
    replacement: argmax(gumbel(key, (*shape, C)) + logits) -> int64 `shape`.
    The argmax is the first maximum, as jnp.argmax's."""
    shape = tuple(int(s) for s in shape)
    noise = gumbel(key, shape + (int(logits.shape[-1]),)).to(logits.device)
    return torch.argmax(noise + logits, dim=-1)
