"""Deterministic multi-host data sharding (SURVEY §5 "deterministic data
sharding by step" — the non-elastic half of the Go master's role; the elastic
half is the JAX package's runtime.master.cluster_reader; this is the port's
copy of `paddle_tpu/data/sharded_reader.py`).

Every host runs the same reader and keeps samples where
`index % num_shards == shard_id` — no coordination, deterministic under
restart, and exactly the v2 cluster_files_reader / recordio-dispatch
semantics when pointed at the same file list."""

from __future__ import annotations

from typing import Any, Callable, Iterator, Optional, Sequence, Tuple


def _topology(num_shards: Optional[int], shard_id: Optional[int]) -> Tuple[int, int]:
    """(n, i), defaulting to the torch.distributed world: its size and this
    process's rank when a process group is initialised, else 1 and 0."""
    import torch.distributed as dist

    up = dist.is_available() and dist.is_initialized()
    n = num_shards if num_shards is not None else (dist.get_world_size() if up else 1)
    i = shard_id if shard_id is not None else (dist.get_rank() if up else 0)
    if not 0 <= i < n:
        raise ValueError(f"shard_id {i} out of range for {n} shards")
    return n, i


def shard_reader(
    reader: Callable[[], Iterator[Any]],
    num_shards: Optional[int] = None,
    shard_id: Optional[int] = None,
) -> Callable[[], Iterator[Any]]:
    """Round-robin sample sharding. Defaults to the torch.distributed world."""
    n, i = _topology(num_shards, shard_id)

    def sharded() -> Iterator[Any]:
        for idx, sample in enumerate(reader()):
            if idx % n == i:
                yield sample

    return sharded


def shard_file_list(
    files: Sequence[str],
    num_shards: Optional[int] = None,
    shard_id: Optional[int] = None,
) -> list:
    """File-granular sharding (cluster_files_reader parity,
    python/paddle/v2/dataset/common.py): host i takes files i, i+n, ..."""
    n, i = _topology(num_shards, shard_id)
    return [f for idx, f in enumerate(files) if idx % n == i]
