"""Host memory pool over the native buddy allocator (counterpart of
`paddle_tpu/runtime/allocator.py`; paddle/memory parity, memory.cc:61,
detail/buddy_allocator.h:33).

Serves numpy staging buffers for the feed path: `pool.ndarray(shape,
dtype)` is an array over pool memory, so batch after batch reuses the same
arena instead of the Python heap. `torch.from_numpy` of such an array
shares its memory, and a `.to(device)` copies from it.

`release(arr)` only marks a block releasable: the native free happens when
the last numpy view over the block is collected (a weakref finalizer on
the base array), so a block is never handed out again while a view can
still read it. `close()` refuses while any view is alive."""

from __future__ import annotations

import ctypes as C
import weakref
from typing import Dict, Sequence

import numpy as np

from paddle_tpu_torch.runtime import native


class HostPool:
    def __init__(self, total_bytes: int = 256 << 20, min_block: int = 256):
        self._lib = native.lib()
        self._pool = self._lib.pt_pool_create(min_block, total_bytes)
        if not self._pool:
            raise MemoryError(f"cannot create {total_bytes}-byte host pool")
        self._live: Dict[int, int] = {}  # addr -> nbytes
        self._viewed: Dict[int, weakref.finalize] = {}  # ndarray() blocks
        self._releasable: set = set()  # released, waiting for their views to die

    def alloc(self, nbytes: int) -> int:
        addr = self._lib.pt_pool_alloc(self._pool, nbytes)
        if not addr:
            raise MemoryError(f"host pool exhausted allocating {nbytes} bytes")
        self._live[addr] = nbytes
        return addr

    def free(self, addr: int) -> None:
        if addr in self._viewed:
            raise ValueError(f"block {addr:#x} is backing a numpy view; use release(arr)")
        if self._lib.pt_pool_free(self._pool, addr) != 0:
            raise ValueError(f"invalid free of {addr:#x}")
        self._live.pop(addr, None)
        self._releasable.discard(addr)

    def ndarray(self, shape: Sequence[int], dtype=np.float32) -> np.ndarray:
        """A numpy array over pool memory; `release(arr)` when done."""
        dt = np.dtype(dtype)
        nbytes = int(np.prod(shape)) * dt.itemsize
        addr = self.alloc(max(nbytes, 1))
        base = np.frombuffer((C.c_char * nbytes).from_address(addr), dtype=dt)
        base.flags.writeable = True
        # every derived view keeps `base` alive through its .base chain, so
        # this fires only when no view remains
        self._viewed[addr] = weakref.finalize(base, self._on_views_dead, addr)
        return base.reshape(shape)

    def _on_views_dead(self, addr: int) -> None:
        self._viewed.pop(addr, None)
        if addr in self._releasable:
            self._releasable.discard(addr)
            if self._pool:
                self._lib.pt_pool_free(self._pool, addr)
            self._live.pop(addr, None)

    def release(self, arr: np.ndarray) -> None:
        """Return the block behind `arr` to the pool once every view of it
        has been collected."""
        addr = arr.__array_interface__["data"][0]
        if addr not in self._live:
            raise ValueError("array was not allocated from this pool")
        if addr not in self._viewed:
            raise ValueError(f"block {addr:#x} was not created by ndarray(); use free(addr)")
        if addr in self._releasable:
            raise ValueError(f"double release of block {addr:#x}")
        self._releasable.add(addr)

    def stats(self) -> Dict[str, int]:
        out = (C.c_uint64 * 5)()
        self._lib.pt_pool_stats(self._pool, out)
        return {"arena_bytes": out[0], "in_use": out[1], "peak": out[2],
                "n_allocs": out[3], "n_frees": out[4]}

    def close(self) -> None:
        if self._pool:
            if self._viewed:
                raise RuntimeError(f"cannot close host pool: {len(self._viewed)} numpy "
                                   "view(s) still alive over pool memory")
            self._lib.pt_pool_destroy(self._pool)
            self._pool = None

    def __del__(self):
        # never unmap under live views, even at interpreter exit: leaking the
        # arena then beats a crash
        if getattr(self, "_pool", None) and not getattr(self, "_viewed", None):
            self.close()
