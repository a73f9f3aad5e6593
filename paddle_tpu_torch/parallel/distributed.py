"""Multi-process initialization and host-level barriers (counterpart of
`paddle_tpu/parallel/distributed.py`).

The JAX package brings up `jax.distributed` and one global mesh. The port
runs one process per rank: `initialize(coordinator_address, num_processes,
process_id)` is `torch.distributed.init_process_group` over a `TCPStore`
that process 0 hosts at the coordinator address (NCCL where the process has
a card, gloo otherwise), and `make_mesh({"data": n})` then runs on that
default group. `barrier` is the store's: each rank writes an arrival key and
waits for the others' with a timeout, and `BarrierTimeout` names the ranks
that never arrived, as the JAX package's coordinator barrier does. The CLI's
launcher hosts the store itself and its ranks join it as clients
(`initialize(..., host_store=False)`).

Elastic resize (`SGDTrainer.resize_to`): the JAX package re-meshes the
devices of one process; here a resize is ranks leaving and joining a new
group over the job's store. Rank 0 names each attempt (`ElasticPlan`: the
new mesh's extents, the old and new rank counts, the interrupted pass and
batch) under `elastic/<attempt>/` and announces it in `elastic/latest`,
where a launcher watches for the joiners to start. `rendezvous` brings the
new world together: each member of it counts itself in, rank 0 waits for
all of them (or gives up after the timeout, or refuses a world larger
than the visible cards on CUDA) and writes the verdict every old rank and
joiner reads, so all agree to build the group or to keep the old one
(`ValueError`). The group is built over `elastic/<attempt>/pg/`; a rank
outside the new world gets None and leaves. `join` is a joiner's side of
it. `destroy_group` shuts a group down once its successor exists."""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import itertools
import json
import logging
import threading
import os
import time
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

log = logging.getLogger("paddle_tpu_torch.distributed")

_store: Optional[Any] = None
# one barrier counter per (store, rank): ranks that share a process (the
# tests' threads) keep their own sequence
_barrier_seqs: Dict[Tuple[int, int], Any] = {}
_seq_lock = threading.Lock()


class BarrierTimeout(RuntimeError):
    """A host-level barrier expired; the message names the ranks that never
    arrived."""


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None,
               timeout_s: float = 300.0, host_store: bool = True) -> None:
    """Join the `num_processes`-rank group as rank `process_id`, through the
    store at `coordinator_address` ("host:port"; process 0 listens there,
    or, with host_store=False, whoever started the ranks does). A no-op for
    one process, and when a group is already up. `backend`: "nccl" or
    "gloo" (default: nccl when CUDA is available)."""
    global _store
    if dist.is_initialized():
        return
    if num_processes is None or int(num_processes) <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("initialize needs coordinator_address and process_id for "
                         f"{num_processes} processes")
    host, port = coordinator_address.rsplit(":", 1)
    rank, world = int(process_id), int(num_processes)
    timeout = datetime.timedelta(seconds=timeout_s)
    _store = dist.TCPStore(host, int(port), world, host_store and rank == 0,
                           timeout=timeout)
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, store=_store, rank=rank, world_size=world,
                            timeout=timeout)
    if backend == "gloo":
        # a gloo group left to the interpreter's own teardown can abort the
        # process at exit ("terminate called without an active exception");
        # an NCCL group is not shut down here: a live CUDA graph may hold it
        atexit.register(_destroy_default_group)
    log.info("distributed init: rank %d/%d over %s", rank, world, backend)


def _destroy_default_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier(name: str = "barrier", timeout_s: Optional[float] = None,
            _store_override: Optional[Any] = None, _rank: Optional[int] = None,
            _world: Optional[int] = None) -> None:
    """Host-level sync point (ParameterServer2::synchronize parity). Every
    rank calls barriers in the same order, so a shared counter gives them
    matching ids. Each rank records its arrival in the store, then waits
    for every rank's key; after `timeout_s` (default
    $PADDLE_TPU_BARRIER_TIMEOUT_S or 300) it raises BarrierTimeout naming
    the ranks that never arrived. One process: nothing to wait on."""
    if timeout_s is None:
        timeout_s = float(os.environ.get("PADDLE_TPU_BARRIER_TIMEOUT_S", "300"))
    store = _store_override if _store_override is not None else _store
    n = _world if _world is not None else process_count()
    if store is None or n <= 1:
        return
    me = _rank if _rank is not None else process_index()
    with _seq_lock:
        seq = next(_barrier_seqs.setdefault((id(store), me), itertools.count()))
    bid = f"paddle_tpu/{name}/{seq}"
    store.set(f"{bid}/arrived/{me}", str(time.time()))
    keys = [f"{bid}/arrived/{r}" for r in range(n)]
    deadline = time.monotonic() + timeout_s
    while True:
        arrived = [r for r, k in enumerate(keys) if store.check([k])]
        if len(arrived) == n:
            return
        if time.monotonic() >= deadline:
            missing = sorted(set(range(n)) - set(arrived))
            raise BarrierTimeout(
                f"barrier {name!r} (#{seq}) timed out after {timeout_s:.0f}s on "
                f"process {me}: waiting for process(es) {missing}; arrived "
                f"{sorted(arrived)} of {n}")
        time.sleep(0.01)


# -- elastic resize ----------------------------------------------------------

RENDEZVOUS_TIMEOUT_ENV = "PADDLE_TPU_RESIZE_RENDEZVOUS_S"
LATEST_KEY = "elastic/latest"


def rendezvous_timeout_s() -> float:
    """How long rank 0 waits for a new world to arrive
    ($PADDLE_TPU_RESIZE_RENDEZVOUS_S, default 120)."""
    return float(os.environ.get(RENDEZVOUS_TIMEOUT_ENV, "120"))


@dataclasses.dataclass
class ElasticPlan:
    """One resize attempt of a job: the new mesh's extents (`axes`), its
    rank count (`world`) and the old one, the backend, and where the
    interrupted pass stands (`pass_id`, `batch`: the batches applied; -1
    for a resize outside `train`). `store` is the job's store (not
    serialized)."""

    attempt: int
    axes: Dict[str, int]
    world: int
    old_world: int
    backend: str
    pass_id: int = -1
    batch: int = -1
    store: Any = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def prefix(self) -> str:
        return f"elastic/{self.attempt}/"

    def to_json(self) -> str:
        return json.dumps({f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                           if f.name != "store"})

    @classmethod
    def read(cls, store: Any, attempt: int) -> "ElasticPlan":
        plan = cls(**json.loads(store.get(f"elastic/{int(attempt)}/plan").decode()))
        plan.store = store
        return plan


def announce(plan: ElasticPlan) -> None:
    """Rank 0 writes the attempt's plan, then points `elastic/latest` at it
    (a launcher starts the joiners from there)."""
    plan.store.set(plan.prefix + "plan", plan.to_json())
    plan.store.set(LATEST_KEY, str(plan.attempt))


def latest_plan(store: Any) -> Optional[ElasticPlan]:
    """The newest announced attempt in the job's store, or None."""
    if not store.check([LATEST_KEY]):
        return None
    return ElasticPlan.read(store, int(store.get(LATEST_KEY).decode()))


def rendezvous(plan: ElasticPlan, lead: bool, new_rank: Optional[int],
               device: torch.device, timeout_s: Optional[float] = None):
    """Bring the plan's world together. Every old rank and every joiner
    calls it; `new_rank` is the caller's rank in the new world (None: it
    leaves), `lead` marks rank 0, which decides. Returns the new group
    (None for a leaver). Raises ValueError on every caller when the world
    cannot be built (a joiner missing after `timeout_s`, or on CUDA more
    ranks than visible cards); the old group is untouched then."""
    store, pfx = plan.store, plan.prefix
    timeout_s = rendezvous_timeout_s() if timeout_s is None else float(timeout_s)
    if new_rank is not None:
        store.add(pfx + "arrived", 1)
    if lead:
        reason = None
        if device.type == "cuda" and plan.world > torch.cuda.device_count():
            reason = (f"{plan.world} ranks need {plan.world} GPUs, one a rank, but "
                      f"{torch.cuda.device_count()} are visible")
        else:
            deadline = time.monotonic() + timeout_s
            while store.add(pfx + "arrived", 0) < plan.world:
                if time.monotonic() > deadline:
                    reason = (f"{store.add(pfx + 'arrived', 0)} of {plan.world} ranks "
                              f"arrived within {timeout_s:g}s")
                    break
                time.sleep(0.005)
        store.set(pfx + "verdict", "ok" if reason is None else reason)
    else:
        store.wait([pfx + "verdict"], datetime.timedelta(seconds=timeout_s + 60.0))
    verdict = store.get(pfx + "verdict").decode()
    if verdict != "ok":
        raise ValueError(f"resize attempt {plan.attempt} to {plan.world} rank(s) "
                         f"rejected: {verdict}")
    if new_rank is None:
        return None
    from paddle_tpu_torch.parallel import mesh as mesh_mod

    if plan.backend == "nccl":
        torch.cuda.set_device(device)
    return mesh_mod._sub_group(plan.backend, store, pfx + "pg/", new_rank, plan.world)


def join(store: Any, attempt: int, rank: int, device: torch.device,
         timeout_s: Optional[float] = None):
    """A joiner's side of `rendezvous`: read the attempt's plan from the
    job's store, count in as `rank` and wait for the verdict -> (the new
    group, the plan). Raises ValueError when the attempt was rejected."""
    store.wait([f"elastic/{int(attempt)}/plan"],
               datetime.timedelta(seconds=rendezvous_timeout_s() + 60.0))
    plan = ElasticPlan.read(store, attempt)
    return rendezvous(plan, False, rank, device, timeout_s), plan


def connect(coordinator_address: str, timeout_s: float = 300.0):
    """A client of the job's store at "host:port" (a joiner process's way
    in; the launcher hosts it)."""
    host, port = coordinator_address.rsplit(":", 1)
    return dist.TCPStore(host, int(port), None, False,
                         timeout=datetime.timedelta(seconds=timeout_s))


def destroy_group(group: Any) -> None:
    """Shut a process group down (its successor already exists): the
    default group through `destroy_process_group`, any other through its
    own `shutdown`."""
    from paddle_tpu_torch.parallel import mesh as mesh_mod

    mesh_mod._unregister(group)
    if dist.is_initialized():
        from torch.distributed import distributed_c10d

        if group is distributed_c10d._get_default_group():
            dist.destroy_process_group()
            return
    group.shutdown()
