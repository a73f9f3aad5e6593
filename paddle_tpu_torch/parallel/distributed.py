"""Multi-process initialization and host-level barriers (counterpart of
`paddle_tpu/parallel/distributed.py`).

The JAX package brings up `jax.distributed` and one global mesh. The port
runs one process per rank: `initialize(coordinator_address, num_processes,
process_id)` is `torch.distributed.init_process_group` over a `TCPStore`
that process 0 hosts at the coordinator address (NCCL where the process has
a card, gloo otherwise), and `make_mesh({"data": n})` then runs on that
default group. `barrier` is the store's: each rank writes an arrival key and
waits for the others' with a timeout, and `BarrierTimeout` names the ranks
that never arrived, as the JAX package's coordinator barrier does."""

from __future__ import annotations

import datetime
import itertools
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
               timeout_s: float = 300.0) -> None:
    """Join the `num_processes`-rank group as rank `process_id`, through the
    store at `coordinator_address` ("host:port"; process 0 listens there).
    A no-op for one process, and when a group is already up. `backend`:
    "nccl" or "gloo" (default: nccl when CUDA is available)."""
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
    _store = dist.TCPStore(host, int(port), world, rank == 0, timeout=timeout)
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, store=_store, rank=rank, world_size=world,
                            timeout=timeout)
    log.info("distributed init: rank %d/%d over %s", rank, world, backend)


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
