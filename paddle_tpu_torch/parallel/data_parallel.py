"""Data-parallel execution of the training step (counterpart of
`paddle_tpu/parallel/data_parallel.py`).

In the JAX package the batch is a global array sharded over the mesh's
data axis and jit's partitioner inserts the gradient reduction. The port
runs one rank per process (or per thread in the tests): every rank reads
the same global batch on the host, pads it to a multiple of the data axis
(`maybe_pad_batch`: repeated last rows and a row mask) and keeps its own
rows [r*B/n, (r+1)*B/n) (`shard_batch`). The forward runs on those rows
under the mesh (`Network.apply(mesh=...)`): batch norm reduces its sums over
the mesh, the costs divide by the global real row count, random draws keep
this rank's rows of the global bits. The gradients are then summed over the
ranks by the updater (`updaters.py`): in one flat all-reduce for the
replicated updater (`reduce_grads`), in a reduce-scatter for the ZeRO ones.

Parameters resolve through the rules table (`rules.py`); on the data-only
mesh every parameter is replicated. On a mesh with a `model` (or `expert`)
axis, a parameter whose logical axes resolve to it is stored as this
rank's slice, gathered over that axis for the step's compute, and its
gradient summed over the data axis only (`updaters.py`): storage-sharded,
compute-gathered, where the JAX package's GSPMD partitions the compute
(ROADMAP.md §3 difference 26). Every collective here runs on the data
axis' group."""

from __future__ import annotations

import logging
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.nn.graph import SAMPLE_COUNT_KEY, SAMPLE_MASK_KEY, ParamAttr
from paddle_tpu_torch.parallel.mesh import Mesh
from paddle_tpu_torch.parallel.rules import ShardingRules, Spec, warn_legacy_sharding

log = logging.getLogger("paddle_tpu_torch.parallel")


class ShardedBatch(dict):
    """This rank's rows of a global batch ([b, ...] a slot, or [K, b, ...]
    stacked), tagged with the plan that cut them (`plan`) and, for a stack,
    its width `k`."""

    plan: Any = None
    k: int = 1


def _rows(v: Any) -> int:
    return int(np.shape(v)[0])


def _repeat_last(v: Any, pad: int) -> Any:
    if isinstance(v, torch.Tensor):
        return torch.cat([v, v[-1:].expand((pad,) + tuple(v.shape[1:]))])
    v = np.asarray(v)
    return np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])


class DataParallel:
    """Plugs into `SGDTrainer(parallel=...)`. `batch_axis` shards batches;
    parameter placements come from `ParamAttr.logical_axes` (or the legacy
    `sharding` tuple) resolved through the rules table."""

    def __init__(self, mesh: Mesh, batch_axis: str = "data",
                 param_attrs: Optional[Dict[str, ParamAttr]] = None,
                 rules: Optional[ShardingRules] = None):
        self.mesh = mesh
        self.batch_axis = batch_axis
        self.param_attrs = param_attrs or {}
        self.rules = rules if rules is not None else ShardingRules()

    # -- sharding rules ------------------------------------------------------
    def param_sharding(self, name: str, ndim: int) -> Spec:
        """One parameter's placement through the rules table: a mesh axis
        or None per dimension (all None: replicated)."""
        attr = self.param_attrs.get(name)
        axes = None if attr is None else attr.logical_axes
        if axes is None and attr is not None and attr.sharding is not None:
            axes = attr.sharding
            warn_legacy_sharding(name)  # once per process
        if axes is None:
            return (None,) * ndim
        return self.rules.spec_for(axes, self.mesh, ndim=ndim, param=name)

    @property
    def data_axis_size(self) -> int:
        return int(self.mesh.shape[self.batch_axis])

    @property
    def rank(self) -> int:
        """This rank's index on the data axis: whose rows it keeps."""
        return self.mesh.index(self.batch_axis)

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    # -- padding -------------------------------------------------------------
    def batch_divisible(self, batch: Mapping[str, Any]) -> bool:
        n = self.data_axis_size
        return all(_rows(v) % n == 0 for v in batch.values())

    def pad_batch(self, batch: Mapping[str, Any]) -> Tuple[Dict[str, Any], int]:
        """Pad an indivisible host batch up to the next data-axis multiple by
        repeating each slot's last row, and attach the [B_padded] 0/1 row
        mask under SAMPLE_MASK_KEY. The cost layers weigh rows by the mask
        and divide by the real row count, so the padded batch reproduces the
        unpadded batch's cost and gradients. Returns (padded, n_pad); (batch,
        0) when it divides already. As in the JAX package, batch norm's
        statistics see the repeated rows."""
        return self._pad_batch(batch)

    def maybe_pad_batch(self, batch: Mapping[str, Any],
                        where: str = "batch") -> Optional[Dict[str, Any]]:
        """The pad-or-drop gate of the trainer, its `test` and the
        prefetcher: divisible batches pass, indivisible ones pad and carry
        the mask (counted in stats.DATA_EVENTS['padded_batches']), ragged
        ones that cannot pad drop with a warning (None)."""
        if self.batch_divisible(batch):
            return dict(batch)
        padded, n_pad = self._pad_batch(batch)
        if n_pad:
            from paddle_tpu_torch.core import stats

            stats.DATA_EVENTS.incr("padded_batches")
            return padded
        log.warning("%s: dropping batch — ragged slot sizes not divisible by the mesh "
                    "data axis", where)
        return None

    def _pad_batch(self, batch: Mapping[str, Any]) -> Tuple[Dict[str, Any], int]:
        n = self.data_axis_size
        rows = {_rows(v) for v in batch.values()}
        if len(rows) != 1:
            return dict(batch), 0  # heterogeneous leading dims: cannot pad safely
        b = rows.pop()
        pad = (-b) % n
        if pad == 0:
            return dict(batch), 0
        out = {k: _repeat_last(v, pad) for k, v in batch.items() if k != SAMPLE_COUNT_KEY}
        mask = np.ones(b + pad, np.float32)
        mask[b:] = 0.0
        if SAMPLE_MASK_KEY in batch:
            # re-padding a masked batch: extend its mask with zero rows
            old = batch[SAMPLE_MASK_KEY]
            mask[:b] = (old.detach().cpu().numpy() if isinstance(old, torch.Tensor)
                        else np.asarray(old, np.float32))
        out[SAMPLE_MASK_KEY] = mask
        return out, pad

    # -- this rank's rows ----------------------------------------------------
    def _cut(self, batch: Mapping[str, Any], axis: int) -> ShardedBatch:
        n, r = self.data_axis_size, self.rank
        out = ShardedBatch()
        for k, v in batch.items():
            if k == SAMPLE_COUNT_KEY:
                continue
            b = int(np.shape(v)[axis])
            if b % n:
                raise ValueError(f"batch slot {k!r} has {b} rows, not a multiple of the "
                                 f"mesh data axis {n}: pad it first (maybe_pad_batch)")
            lo, hi = r * (b // n), (r + 1) * (b // n)
            out[k] = v[lo:hi] if axis == 0 else v[:, lo:hi]
        if SAMPLE_MASK_KEY in batch:
            # the global real row count: the costs' denominator and the
            # samples counter's step, the same on every rank
            mask = batch[SAMPLE_MASK_KEY]
            if isinstance(mask, torch.Tensor):
                count = mask.float().sum(dim=-1, keepdim=True)
            else:
                count = np.asarray(mask, np.float32).sum(axis=-1, keepdims=True)
            out[SAMPLE_COUNT_KEY] = count
        out.plan = self
        return out

    def shard_batch(self, batch: Mapping[str, Any]) -> ShardedBatch:
        """This rank's rows [r*B/n, (r+1)*B/n) of every slot of a global
        batch (B divisible by n: pad it first), with the global real row
        count beside a padded batch's mask."""
        return self._cut(batch, 0)

    def shard_batches(self, batches: Mapping[str, Any]) -> ShardedBatch:
        """shard_batch for a K-stacked group ([K, B, ...] a slot): the rows
        along axis 1."""
        out = self._cut(batches, 1)
        out.k = int(np.shape(next(iter(batches.values())))[0])
        return out

    def is_sharded_batch(self, batch: Mapping[str, Any]) -> bool:
        """True when `batch` is this plan's cut of a global batch (the
        trainer's fast path must not cut a rank's rows again)."""
        return getattr(batch, "plan", None) is self

    def replicate(self, value: Any) -> Any:
        """One value on this rank's device."""
        return value.to(self.device) if isinstance(value, torch.Tensor) else value

    def shard_state(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """A train state on this rank's device. The ZeRO updaters keep their
        flat leaves as this rank's rows already (`updaters.py`), so placing
        is a device move."""
        def place(tree):
            if isinstance(tree, dict):
                return {k: place(v) for k, v in tree.items()}
            if isinstance(tree, tuple):
                return tuple(place(v) for v in tree)
            return self.replicate(tree)
        return place(state)

    # -- the replicated path's gradient reduction ----------------------------
    def reduce_grads(self, grads: Dict[str, torch.Tensor],
                     cost: torch.Tensor) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Every rank's gradients and cost summed over the mesh in one flat
        f32 all-reduce (the cost is its last element). Each rank's cost and
        gradients already divide by the global row count, so the sums are
        the unsharded batch's."""
        names = list(grads)
        flat = torch.cat([grads[k].reshape(-1).float() for k in names]
                         + [cost.reshape(1).float()])
        self.mesh.all_reduce_(flat, self.batch_axis)
        out, off = {}, 0
        for k in names:
            g = grads[k]
            out[k] = flat[off:off + g.numel()].view(g.shape).to(g.dtype)
            off += g.numel()
        return out, flat[off]
