"""The device mesh over torch.distributed (counterpart of
`paddle_tpu/parallel/mesh.py`).

The JAX package's mesh is a `jax.sharding.Mesh`: named axes over the
devices of one process, and jit's partitioner places the collectives. The
port runs one process (or, in the tests, one thread) per rank, so its
`Mesh` is an object with named axes that holds its own process group, this
rank's index, the world size and this rank's device. Every collective of
the data-parallel path runs on that explicit group through the group's own
methods, never on the global default group: that is what lets the tests run
ranks as threads, each with its own gloo group over one store.

Only the `data` axis is ported (ROADMAP.md §1 item 8a). A mesh with
`model`, `seq` or `expert` larger than 1 raises a named error (item 8b).

Each collective call is counted by kind in `CALLS[(mesh.uid, kind)]`; a
call made while the current stream captures a CUDA graph is counted in
`CAPTURED` instead, and whoever replays the graph adds what it captured per
replay (`note_replay`), as the kernel wrappers count their launches
(`ops/rnn_kernels.py`)."""

from __future__ import annotations

import datetime
import itertools
from collections import Counter
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from paddle_tpu_torch.device import DeviceLike, resolve_device

AXES = ("data", "model", "seq", "expert")

# (mesh uid, kind) -> calls that ran; under CUDA-graph capture, CAPTURED
CALLS: Counter = Counter()
CAPTURED: Counter = Counter()
KINDS = ("all_reduce", "reduce_scatter", "all_gather", "all_to_all")

_uids = itertools.count()

_ITEM8B = ("the {axis!r} mesh axis is not ported to paddle_tpu_torch yet "
           "(ROADMAP.md §1 item 8: item 8b ports the model and seq axes, TP "
           "serving and the expert-sharded embedding); only 'data' runs")


class UncapturableGroupError(RuntimeError):
    """A process group whose collectives a CUDA graph cannot hold: gloo
    with CUDA tensors. Raised when a trainer on the card is built over it;
    nothing falls back to an eager step."""


class Mesh:
    """Named mesh axes over one process group. `shape[axis]` is the axis'
    extent; `rank` / `size` are this rank's index and the world size on
    `group`; `device` is where this rank's tensors live. `backend` is the
    group's ("nccl" or "gloo")."""

    def __init__(self, sizes: Dict[str, int], group: Any, rank: int, device: torch.device,
                 backend: str):
        self.axis_names: Tuple[str, ...] = tuple(
            [a for a in AXES if a in sizes] + [a for a in sizes if a not in AXES])
        self.shape: Dict[str, int] = {a: int(sizes[a]) for a in self.axis_names}
        self.group = group
        self.rank = int(rank)
        self.size = int(group.size())
        self.device = device
        self.backend = backend
        self.uid = next(_uids)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}/{self.size}, {self.backend}, "
                f"{self.device})")

    # -- counted collectives (the group's own methods) ------------------------
    def _count(self, kind: str) -> None:
        if self.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            CAPTURED[(self.uid, kind)] += 1
        else:
            CALLS[(self.uid, kind)] += 1

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """t <- the sum of every rank's t, in place."""
        self._count("all_reduce")
        self.group.allreduce([t]).wait()
        return t

    def reduce_scatter(self, inp: torch.Tensor) -> torch.Tensor:
        """[n, w] (contiguous) -> [1, w]: row r of the sum over ranks, on rank
        r (`reduce_scatter_tensor`)."""
        self._count("reduce_scatter")
        out = inp.new_empty((1,) + tuple(inp.shape[1:]))
        self.group._reduce_scatter_base(out, inp.contiguous()).wait()
        return out

    def all_gather(self, inp: torch.Tensor) -> torch.Tensor:
        """[1, w] -> [n, w]: row r is rank r's (`all_gather_into_tensor`)."""
        self._count("all_gather")
        out = inp.new_empty((self.size,) + tuple(inp.shape[1:]))
        self.group._allgather_base(out, inp.contiguous()).wait()
        return out

    def all_to_all(self, inp: torch.Tensor) -> torch.Tensor:
        """[n, w] -> [n, w]: row j of the result is rank j's row r, on rank r
        (`all_to_all_single`, equal splits)."""
        self._count("all_to_all")
        out = torch.empty_like(inp)
        self.group.alltoall_base(out, inp.contiguous(), [], []).wait()
        return out

    def counts(self) -> Dict[str, int]:
        """{kind: calls that ran on this mesh}, replays included."""
        return {k: CALLS[(self.uid, k)] for k in KINDS}

    def reset_counts(self) -> None:
        for k in KINDS:
            CALLS[(self.uid, k)] = 0


def note_replay(captured: Dict[Tuple[int, str], int]) -> None:
    """A CUDA graph holding `captured` ({(mesh uid, kind): calls}, the
    growth of CAPTURED over its capture) was replayed: each call ran once."""
    for key, n in captured.items():
        CALLS[key] += n


def captured_since(before: Dict[Tuple[int, str], int]) -> Dict[Tuple[int, str], int]:
    """The growth of CAPTURED since the snapshot `before`."""
    return {k: n - before.get(k, 0) for k, n in CAPTURED.items() if n != before.get(k, 0)}


def _one_rank_group(device: torch.device):
    """A one-rank group of this process's own, through a TCPStore on
    127.0.0.1 at a free port: NCCL on a card, gloo on the CPU."""
    store = dist.TCPStore("127.0.0.1", 0, 1, True, timeout=datetime.timedelta(seconds=60))
    if device.type == "cuda":
        torch.cuda.set_device(device)
        return dist.ProcessGroupNCCL(store, 0, 1), "nccl"
    return new_gloo_group(store, 0, 1), "gloo"


def new_gloo_group(store: Any, rank: int, size: int, timeout_s: float = 300.0):
    """A gloo group of `size` ranks over `store`, bound to 127.0.0.1: the
    tests' ranks (threads over one HashStore) and the CPU's trainer
    processes build their groups with it."""
    opts = dist.ProcessGroupGloo._Options()
    opts._timeout = datetime.timedelta(seconds=timeout_s)
    opts._devices = [dist.ProcessGroupGloo.create_device(hostname="127.0.0.1")]
    return dist.ProcessGroupGloo(store, rank, size, opts)


def _group_backend(group: Any) -> str:
    name = group.name() if hasattr(group, "name") else ""
    if name == "undefined" or not name:
        name = str(dist.get_backend(group)) if dist.is_initialized() else "gloo"
    return name.lower()


def make_mesh(axis_sizes: Optional[Dict[str, int]] = None, group: Any = None,
              device: DeviceLike = None) -> Mesh:
    """axis_sizes e.g. {"data": 4}; unmentioned axes have extent 1.

    group: the process group the data axis runs on (its size must equal the
    data axis). Without one, a data axis of 1 builds a one-rank group of
    its own (NCCL on `cuda`, gloo on `cpu`; what `bench.py` asks of
    `make_mesh({"data": 1})` on a one-chip host), and a larger axis takes
    the initialized default group (`parallel.distributed.initialize`).
    device: this rank's device (None means CUDA, `cuda:<local rank>` in a
    multi-rank run)."""
    sizes = dict(axis_sizes) if axis_sizes is not None else {}
    for axis, n in sizes.items():
        if axis != "data" and int(n) > 1:
            raise NotImplementedError(_ITEM8B.format(axis=axis))
    n = int(sizes.get("data", 0)) or None
    if group is None:
        if n in (None, 1) and not dist.is_initialized():
            dev = resolve_device(device)
            group, backend = _one_rank_group(dev)
            sizes["data"] = 1
            return Mesh(sizes, group, 0, dev, backend)
        if not dist.is_initialized():
            raise RuntimeError(
                f"make_mesh({sizes}) needs {n} ranks, but no process group is "
                "initialized: call paddle_tpu_torch.parallel.distributed.initialize("
                "coordinator_address, num_processes, process_id) in every rank "
                "first, or pass group=")
        from torch.distributed import distributed_c10d

        group = distributed_c10d._get_default_group()
        backend = str(dist.get_backend()).lower()
    else:
        backend = _group_backend(group)
    world = int(group.size())
    if n is None:
        n = world
    if n != world:
        raise ValueError(f"mesh data axis {n} != the process group's {world} ranks")
    sizes["data"] = n
    rank = int(group.rank())
    if device is None and backend == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = resolve_device(device)
    return Mesh(sizes, group, rank, dev, backend)


def resize_mesh(mesh: Mesh, axis: str, new_size: int, group: Any = None) -> Mesh:
    """The same mesh with `axis` re-shaped to `new_size` ranks, over
    `group` (a group of that many ranks). Re-sharding a live trainer onto
    it is ROADMAP.md §1 item 8c."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis!r} to resize (axes: {mesh.axis_names})")
    new_size = int(new_size)
    if new_size < 1:
        raise ValueError(f"resize target for axis {axis!r} must be >= 1")
    sizes = dict(mesh.shape)
    sizes[axis] = new_size
    if group is None and new_size != mesh.size:
        raise ValueError(
            f"cannot resize mesh axis {axis!r} to {new_size}: the new mesh needs a "
            f"process group of {new_size} rank(s), this one has {mesh.size}")
    return make_mesh(sizes, group=group if group is not None else mesh.group,
                     device=mesh.device)
