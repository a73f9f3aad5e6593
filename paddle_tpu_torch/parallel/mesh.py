"""The device mesh over torch.distributed (counterpart of
`paddle_tpu/parallel/mesh.py`).

The JAX package's mesh is a `jax.sharding.Mesh`: named axes over the
devices of one process, and jit's partitioner places the collectives. The
port runs one process (or, in the tests, one thread) per rank, so its
`Mesh` is an object with named axes over one process group: this rank's
index on the group, the world size, this rank's device, and one sub-group
per axis. The ranks are laid out as the JAX package reshapes its devices
(`data` outermost, then `model`, `seq`, `expert`): rank r sits at the
row-major coordinates of r in the axes' extents. An axis' sub-group holds
the ranks that differ from this one on that axis only; it is the whole
group when the axis spans the world (a one-rank world included), and none
when its extent is 1 inside a larger world. Every
collective runs on a named axis' group through the group's own methods,
never on the global default group: that is what lets the tests run ranks as
threads, each with its own gloo group over one store.

The sub-groups are built when the mesh is, one per axis and coordinate,
each over a `PrefixStore` of the store the whole group was built on (the
store `new_gloo_group` registered, or the default group's), so
every rank builds its own axes' groups and no two share a prefix.

Each collective call is counted by axis and kind in `CALLS[(mesh.uid, axis,
kind)]`; a call made while the current stream captures a CUDA graph is
counted in `CAPTURED` instead, and whoever replays the graph adds what it
captured per replay (`note_replay`), as the kernel wrappers count their
launches (`ops/rnn_kernels.py`)."""

from __future__ import annotations

import datetime
import itertools
import threading
import weakref
from collections import Counter
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from paddle_tpu_torch.device import DeviceLike, resolve_device

AXES = ("data", "model", "seq", "expert")

# (mesh uid, axis, kind) -> calls that ran; under CUDA-graph capture, CAPTURED
CALLS: Counter = Counter()
CAPTURED: Counter = Counter()
KINDS = ("all_reduce", "reduce_scatter", "all_gather", "all_to_all")
# the whole group's collectives (a barrier) count under this axis name
WORLD = "world"

_uids = itertools.count()

# group -> (the store it was built on, a counter of the meshes built over it)
_stores: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_stores_lock = threading.Lock()


class UncapturableGroupError(RuntimeError):
    """A process group whose collectives a CUDA graph cannot hold: gloo
    with CUDA tensors. Raised when a trainer on the card is built over it;
    nothing falls back to an eager step."""


class Mesh:
    """Named mesh axes over one process group. `shape[axis]` is the axis'
    extent; `rank` / `size` are this rank's index and the world size on
    `group`; `coords[axis]` is this rank's index on an axis (`index`), and
    `axis_group(axis)` the sub-group of its ranks; `device` is where this
    rank's tensors live. `backend` is the group's ("nccl" or "gloo")."""

    def __init__(self, sizes: Dict[str, int], group: Any, rank: int, device: torch.device,
                 backend: str, axis_groups: Optional[Dict[str, Any]] = None):
        self.axis_names: Tuple[str, ...] = tuple(
            [a for a in AXES if a in sizes] + [a for a in sizes if a not in AXES])
        self.shape: Dict[str, int] = {a: int(sizes[a]) for a in self.axis_names}
        self.group = group
        self.rank = int(rank)
        self.size = int(group.size())
        self.device = device
        self.backend = backend
        self.uid = next(_uids)
        extents = [self.shape[a] for a in self.axis_names]
        self.coords: Dict[str, int] = dict(zip(
            self.axis_names, (int(c) for c in np.unravel_index(self.rank, extents))))
        self._axis_groups: Dict[str, Any] = dict(axis_groups or {})
        for a in self.axis_names:
            if self.shape[a] == self.size:
                self._axis_groups[a] = group

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}/{self.size}, {self.backend}, "
                f"{self.device})")

    # -- axes ------------------------------------------------------------------
    def extent(self, axis: str) -> int:
        """The axis' extent (1 for an axis the mesh does not name)."""
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's index on `axis` (0 for an axis the mesh does not name)."""
        return self.coords.get(axis, 0)

    def axis_group(self, axis: Optional[str]):
        """The process group of `axis` (None: the whole group). An axis of
        extent 1 inside a larger world has none; on a one-rank world every
        named axis is the whole group, so its collectives still run."""
        if axis is None:
            return self.group
        return self._axis_groups.get(axis)

    def axis_ranks(self, axis: str) -> List[int]:
        """The world ranks on this rank's line along `axis`, by index."""
        extents = [self.shape[a] for a in self.axis_names]
        out = []
        for i in range(self.extent(axis)):
            c = dict(self.coords)
            c[axis] = i
            out.append(int(np.ravel_multi_index([c[a] for a in self.axis_names], extents)))
        return out

    # -- counted collectives (the axis group's own methods) --------------------
    def _count(self, axis: Optional[str], kind: str) -> None:
        key = (self.uid, axis or WORLD, kind)
        if self.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            CAPTURED[key] += 1
        else:
            CALLS[key] += 1

    def all_reduce_(self, t: torch.Tensor, axis: Optional[str] = "data") -> torch.Tensor:
        """t <- the sum over `axis` of every rank's t, in place (axis None:
        over the whole group)."""
        self._count(axis, "all_reduce")
        g = self.axis_group(axis)
        if g is not None:
            g.allreduce([t]).wait()
        return t

    def reduce_scatter(self, inp: torch.Tensor, axis: str = "data") -> torch.Tensor:
        """[n, w] (contiguous) -> [1, w]: row r of the sum over the axis'
        ranks, on the rank of index r (`reduce_scatter_tensor`)."""
        self._count(axis, "reduce_scatter")
        g = self.axis_group(axis)
        if g is None:
            return inp.contiguous().clone()
        out = inp.new_empty((1,) + tuple(inp.shape[1:]))
        g._reduce_scatter_base(out, inp.contiguous()).wait()
        return out

    def all_gather(self, inp: torch.Tensor, axis: str = "data") -> torch.Tensor:
        """[1, w] -> [n, w]: row r is the axis' rank r's
        (`all_gather_into_tensor`)."""
        self._count(axis, "all_gather")
        g = self.axis_group(axis)
        if g is None:
            return inp.contiguous().clone()
        out = inp.new_empty((self.extent(axis),) + tuple(inp.shape[1:]))
        g._allgather_base(out, inp.contiguous()).wait()
        return out

    def all_to_all(self, inp: torch.Tensor, axis: str = "data") -> torch.Tensor:
        """[n, w] -> [n, w]: row j of the result is the axis' rank j's row
        r, on the rank of index r (`all_to_all_single`, equal splits)."""
        self._count(axis, "all_to_all")
        g = self.axis_group(axis)
        if g is None:
            return inp.contiguous().clone()
        out = torch.empty_like(inp)
        g.alltoall_base(out, inp.contiguous(), [], []).wait()
        return out

    def shift(self, sends: List[torch.Tensor], axis: str, step: int) -> List[torch.Tensor]:
        """Each tensor of `sends` goes to the axis' rank (index + step) mod
        n, and the one from (index - step) mod n comes back in its place:
        one send/recv pair a tensor, issued together (`batch_isend_irecv`'s
        pattern on the axis group)."""
        n = self.extent(axis)
        if n == 1 or step % n == 0:
            return [s.clone() for s in sends]
        if self.backend == "gloo" and any(s.is_cuda for s in sends):
            # gloo's send/recv write from the tensor's pointer as host memory:
            # on a CUDA tensor the process aborts (torch 2.11)
            raise ValueError("a gloo group sends and receives CPU tensors only: "
                             "build the mesh over NCCL for CUDA tensors")
        g = self.axis_group(axis)
        me = self.index(axis)
        dst, src = (me + step) % n, (me - step) % n
        recvs = [torch.empty_like(s) for s in sends]
        works = []
        for i, (s, r) in enumerate(zip(sends, recvs)):
            self._count(axis, "send_recv")
            works.append(g.send([s.contiguous()], dst, i))
            works.append(g.recv([r], src, i))
        for w in works:
            w.wait()
        return recvs

    def broadcast_(self, t: torch.Tensor, axis: Optional[str], root: int = 0) -> torch.Tensor:
        """t <- the axis' rank `root`'s t, in place. Not counted: the
        serving lead's headers ride here, beside the model's collectives."""
        g = self.axis_group(axis)
        if g is not None:
            opts = dist.BroadcastOptions()
            opts.rootRank = root
            g.broadcast([t], opts).wait()
        return t

    def counts(self, axis: Optional[str] = None) -> Dict[str, int]:
        """{kind: calls that ran on this mesh}, replays included: on `axis`,
        or summed over every axis (None). Every kind of KINDS is a key; a
        send/recv pair (`shift`) is one too once one ran."""
        out = {k: 0 for k in KINDS}
        for (uid, a, kind), n in CALLS.items():
            if uid == self.uid and (axis is None or a == axis) and (n or kind in KINDS):
                out[kind] = out.get(kind, 0) + n
        return out

    def reset_counts(self) -> None:
        for key in [k for k in CALLS if k[0] == self.uid]:
            CALLS[key] = 0


def note_replay(captured: Dict[Tuple, int]) -> None:
    """A CUDA graph holding `captured` ({(mesh uid, axis, kind): calls}, the
    growth of CAPTURED over its capture) was replayed: each call ran once."""
    for key, n in captured.items():
        CALLS[key] += n


def captured_since(before: Dict[Tuple, int]) -> Dict[Tuple, int]:
    """The growth of CAPTURED since the snapshot `before`."""
    return {k: n - before.get(k, 0) for k, n in CAPTURED.items() if n != before.get(k, 0)}


def _register(group: Any, store: Any, replace: bool = True) -> None:
    with _stores_lock:
        if replace or group not in _stores:
            _stores[group] = (store, itertools.count())


def _one_rank_group(device: torch.device):
    """A one-rank group of this process's own, through a TCPStore on
    127.0.0.1 at a free port: NCCL on a card, gloo on the CPU."""
    store = dist.TCPStore("127.0.0.1", 0, 1, True, timeout=datetime.timedelta(seconds=60))
    if device.type == "cuda":
        torch.cuda.set_device(device)
        group = dist.ProcessGroupNCCL(store, 0, 1)
        _register(group, store)
        return group, "nccl"
    return new_gloo_group(store, 0, 1), "gloo"


def new_gloo_group(store: Any, rank: int, size: int, timeout_s: float = 300.0):
    """A gloo group of `size` ranks over `store`, bound to 127.0.0.1: the
    tests' ranks (threads over one HashStore) and the CPU's trainer
    processes build their groups with it. The store is remembered, so a
    mesh over the group can build its axes' sub-groups on it."""
    opts = dist.ProcessGroupGloo._Options()
    opts._timeout = datetime.timedelta(seconds=timeout_s)
    opts._devices = [dist.ProcessGroupGloo.create_device(hostname="127.0.0.1")]
    group = dist.ProcessGroupGloo(store, rank, size, opts)
    _register(group, store)
    return group


def _group_backend(group: Any) -> str:
    name = group.name() if hasattr(group, "name") else ""
    if name == "undefined" or not name:
        name = str(dist.get_backend(group)) if dist.is_initialized() else "gloo"
    return name.lower()


def _sub_group(backend: str, store: Any, prefix: str, rank: int, size: int):
    sub = dist.PrefixStore(prefix, store)
    if backend == "nccl":
        group = dist.ProcessGroupNCCL(sub, rank, size)
        _register(group, sub)
        return group
    return new_gloo_group(sub, rank, size)


def _axis_groups(sizes: Dict[str, int], names: Tuple[str, ...], group: Any, rank: int,
                 backend: str) -> Dict[str, Any]:
    """This rank's sub-group of every axis whose extent lies strictly
    between 1 and the world size, each over its own prefix of the group's store."""
    world = int(group.size())
    need = [a for a in names if 1 < sizes[a] < world]
    if not need:
        return {}
    with _stores_lock:
        entry = _stores.get(group)
    if entry is None:
        from paddle_tpu_torch.parallel import distributed

        if distributed._store is None:
            raise ValueError(
                f"make_mesh({sizes}) builds a sub-group per axis over the store the "
                "process group was built on; this group's is unknown: build it with "
                "parallel.mesh.new_gloo_group or parallel.distributed.initialize")
        _register(group, distributed._store, replace=False)
        with _stores_lock:
            entry = _stores[group]
    store, seq = entry
    # every rank builds its meshes over a group in the same order
    mesh_no = next(seq)
    extents = [sizes[a] for a in names]
    coords = dict(zip(names, (int(c) for c in np.unravel_index(rank, extents))))
    out = {}
    for a in need:
        # the line along `a` through this rank, named by its other coordinates
        key = ".".join(f"{b}{coords[b]}" for b in names if b != a)
        out[a] = _sub_group(backend, store, f"mesh{mesh_no}/{a}/{key}", coords[a], sizes[a])
    return out


def make_mesh(axis_sizes: Optional[Dict[str, int]] = None, group: Any = None,
              device: DeviceLike = None) -> Mesh:
    """axis_sizes e.g. {"data": 4, "model": 2}; unmentioned axes have extent
    1, and an unmentioned data axis takes what the others leave of the
    group's ranks.

    group: the process group the mesh spans (its size must equal the
    product of the extents). Without one, a one-rank mesh builds a group
    of its own (NCCL on `cuda`, gloo on `cpu`; what `bench.py` asks of
    `make_mesh({"data": 1})` on a one-chip host), and a larger one takes the
    initialized default group (`parallel.distributed.initialize`).
    device: this rank's device (None means CUDA, `cuda:<local rank>` in a
    multi-rank run). A mesh with an axis strictly between 1 and the world
    size builds that axis' sub-groups over the store the group was built on,
    so such a group comes from `new_gloo_group` or
    `distributed.initialize`."""
    sizes = {a: int(n) for a, n in (axis_sizes or {}).items()}
    for a, n in sizes.items():
        if n < 1:
            raise ValueError(f"mesh axis {a!r} must have extent >= 1, got {n}")
    others = int(np.prod([n for a, n in sizes.items() if a != "data"])) if sizes else 1
    n = sizes.get("data")
    if group is None:
        total = (n or 1) * others
        if total == 1 and not dist.is_initialized():
            dev = resolve_device(device)
            group, backend = _one_rank_group(dev)
            sizes["data"] = 1
            return Mesh(sizes, group, 0, dev, backend)
        if not dist.is_initialized():
            raise RuntimeError(
                f"make_mesh({sizes}) needs {total if n else 'several'} ranks, but no "
                "process group is initialized: call paddle_tpu_torch.parallel."
                "distributed.initialize(coordinator_address, num_processes, "
                "process_id) in every rank first, or pass group=")
        from torch.distributed import distributed_c10d

        group = distributed_c10d._get_default_group()
        backend = str(dist.get_backend()).lower()
    else:
        backend = _group_backend(group)
    world = int(group.size())
    if n is None:
        if world % others:
            raise ValueError(f"mesh {sizes} does not divide the process group's "
                             f"{world} ranks")
        n = world // others
    sizes["data"] = n
    if n * others != world:
        if others == 1:
            raise ValueError(f"mesh data axis {n} != the process group's {world} ranks")
        raise ValueError(f"mesh {sizes} spans {n * others} ranks, the process group "
                         f"has {world}")
    rank = int(group.rank())
    if device is None and backend == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = resolve_device(device)
    names = tuple([a for a in AXES if a in sizes] + [a for a in sizes if a not in AXES])
    subs = _axis_groups(sizes, names, group, rank, backend)
    return Mesh(sizes, group, rank, dev, backend, subs)


def resize_mesh(mesh: Mesh, axis: str, new_size: int, group: Any = None) -> Mesh:
    """The same mesh with `axis` re-shaped to `new_size`, over `group` (a
    group of the new world size). Re-sharding a live trainer onto it is
    ROADMAP.md §1 item 8c."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis!r} to resize (axes: {mesh.axis_names})")
    new_size = int(new_size)
    if new_size < 1:
        raise ValueError(f"resize target for axis {axis!r} must be >= 1")
    sizes = dict(mesh.shape)
    sizes[axis] = new_size
    world = int(np.prod(list(sizes.values())))
    if group is None and world != mesh.size:
        raise ValueError(
            f"cannot resize mesh axis {axis!r} to {new_size}: the new mesh needs a "
            f"process group of {world} rank(s), this one has {mesh.size}")
    return make_mesh(sizes, group=group if group is not None else mesh.group,
                     device=mesh.device)
