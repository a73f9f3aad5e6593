"""Rematerialization of the training step's forward (the counterpart of the
JAX trainer's `remat=` policies: `jax.checkpoint` with `dots_saveable`,
`save_only_these_names("conv_out")`, or nothing saved).

`Network.apply(remat=)` runs the layers in segments, each ending at a conv
or fc layer, and each segment under `checkpoint` (`torch.utils.checkpoint`
with `use_reentrant=False`): what a segment takes from earlier segments
(the previous conv's or fc's output, a residual branch) stays for the
backward, and everything inside it (batch norm, activations, pooling,
dropout, the next conv's input) is recomputed in the backward right
before it is needed, one segment at a time. One region around the whole
forward would recompute everything at once and keep it, saving nothing at
the peak.

  * "full": inside a segment nothing is saved;
  * "dots": every matmul or convolution output is saved;
  * "conv_only": only the outputs of `ops/conv.conv2d` and
    `ops/linalg.matmul` are saved, the ops the JAX package tags "conv_out"
    (`name("conv_out")` marks them here).

A segment ends at its conv or fc, so most of what "dots" and "conv_only"
keep is a segment's output, kept anyway; the three differ where a segment
holds other matmuls (attention, recurrences). Recomputation replays the
same ops on the same inputs, so the updates are those of no remat.
Dropout's bits are a pure function of the step key and the context's draw
count, which `Network` rewinds for the recompute. The policies' ops are the
aten ops a dispatch mode sees below autograd; torch's own RNG state is not
saved (nothing here draws from it)."""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Iterator, Optional

import torch
from torch.utils import checkpoint as _ckpt

POLICIES = (None, "none", "dots", "conv_only", "full")

_aten = torch.ops.aten
_DOTS = frozenset({
    _aten.mm.default, _aten.addmm.default, _aten.bmm.default, _aten.baddbmm.default,
    _aten.convolution.default, _aten._convolution.default,
})

_local = threading.local()


def resolve(remat: Optional[str]) -> Optional[str]:
    """A remat argument -> the policy (None for "none"), or ValueError."""
    if remat not in POLICIES:
        raise ValueError(f"remat must be one of {POLICIES}, got {remat!r}")
    return None if remat == "none" else remat


@contextlib.contextmanager
def name(tag: str) -> Iterator[None]:
    """Tag the ops run inside (jax's `checkpoint_name` on their output)."""
    prev = getattr(_local, "tag", None)
    _local.tag = tag
    try:
        yield
    finally:
        _local.tag = prev


def _policy(kind: str):
    def decide(ctx, op, *args, **kwargs):
        if kind == "dots":
            save = op in _DOTS
        else:  # conv_only
            save = op in _DOTS and getattr(_local, "tag", None) == "conv_out"
        return (_ckpt.CheckpointPolicy.MUST_SAVE if save
                else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)
    return decide


def checkpoint(fn: Callable[[], object], kind: str):
    """fn() (a segment of layers) under the policy `kind` ("dots" |
    "conv_only" | "full")."""
    if kind == "full":
        return _ckpt.checkpoint(fn, use_reentrant=False, preserve_rng_state=False)
    context_fn = functools.partial(_ckpt.create_selective_checkpoint_contexts,
                                   _policy(kind))
    return _ckpt.checkpoint(fn, use_reentrant=False, preserve_rng_state=False,
                            context_fn=context_fn)
