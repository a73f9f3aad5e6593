"""Paged KV cache: one physical page pool + per-slot block tables.

The port's counterpart of `paddle_tpu/serving/kv_cache.py`: the host-side
free list, refcounts, block tables and prefix index are the JAX package's,
unchanged; `make_pools` allocates the zeroed f32 pools as torch tensors on
the session's device. Under tensor parallelism each rank's pools hold its
heads' kv_dim / tp columns (`ServableLM.kv_dim`), while the block tables,
the allocator and the prefix index stay one host copy on the leading rank
that drives every rank.

The device layout follows the paged-attention kernel convention ("Ragged
Paged Attention", PAPERS.md): every sequence shares ONE pool

    k_pages, v_pages : [n_layers, num_pages, page_size, kv_dim]

and each decode slot owns a row of the block table
[max_slots, max_pages_per_seq] mapping logical page j -> physical page id.
Page 0 is reserved as the dump page: inactive slots write their (discarded)
step KV there and unused block-table entries point there, so the compiled
decode program always runs at one fixed shape — which slots are live and how
long each sequence is are pure *data*, never *shape*. That is what lets a
mixed-age, mixed-length batch share a single executable with zero recompiles
(asserted via stats.RecompileStats in the serving session).

Allocation is a host-side free list over REFCOUNTED pages. A
request reserves ceil((prompt_len + max_new_tokens) / page_size) pages at
admission — worst case up front, so a running sequence can never hit page
exhaustion mid-flight (admission control is the only place that says no).
Without the prefix cache every page has refcount 1 and the arithmetic is
bitwise the old free-list's.

With `prefix_cache=True` the shared-prefix index (prefix_cache.py) rides on
top: reserve() first walks the tenant's chain and ALIASES every matching
committed full page into the new slot's block table read-only (+1 ref each
— a handful of host ints; the compiled executables never know), then pops
fresh pages only for the uncached suffix. Committed prompt pages register
into the index (the index holds its own +1 ref), so they outlive their
request and serve later ones; a page only returns to the free list when its
LAST reference drops — a slot releasing, a trim, or an LRU eviction of an
unreferenced cached page under pool pressure. Copy-on-write falls out of
page granularity: only FULL immutable prompt pages are ever shared, and the
first divergent page is a fresh private page the request's own chunked
prefill writes. Retirement/cancel recycling is counted in PHYSICAL frees
(a shared page decrefs without freeing), so the leak-watch counters stay
exact under aliasing."""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.obs import metrics as obs_metrics
from paddle_tpu_torch.serving.prefix_cache import PrefixIndex


class PagedKVCache:
    """Host-side page allocator + device-resident page pool.

    The device tensors are *owned by the serving session* once handed out:
    the decode/commit steps update them in place, so this class only tracks
    the host-side free list, refcounts, block tables and (optionally) the
    prefix index."""

    def __init__(
        self,
        n_layers: int,
        kv_dim: int,
        num_pages: int,
        page_size: int,
        max_slots: int,
        max_pages_per_seq: int,
        prefix_cache: bool = False,
        prefix_cache_pages: Optional[int] = None,
    ):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is the dump page)")
        self.n_layers = n_layers
        self.kv_dim = kv_dim
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_slots = max_slots
        self.max_pages_per_seq = max_pages_per_seq
        # pop() hands out ascending ids; page 0 is never allocatable
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._slot_pages: List[List[int]] = [[] for _ in range(max_slots)]
        # the block table rides to the device as step *data* each decode —
        # same shape every step, so it never perturbs the executable cache
        self._table = np.zeros((max_slots, max_pages_per_seq), np.int32)
        # refcounts: slots + the prefix index each hold one
        # reference; a page recycles only at zero. Prefix off => every page
        # is refcount<=1 and the accounting is bitwise the old free list's.
        self._refcount: List[int] = [0] * num_pages
        # shared-prefix index (None = disabled). The _prefix_lock guards the
        # index STRUCTURE against the one cross-thread access — a submit
        # thread's admission-pricing peek racing the engine thread's
        # insert/evict; free-list/refcount mutations stay engine-thread-only
        # (under the scheduler lock), exactly as before.
        self.prefix: Optional[PrefixIndex] = (
            PrefixIndex(page_size) if prefix_cache else None
        )
        self.prefix_cache_pages = (
            None if prefix_cache_pages is None else int(prefix_cache_pages)
        )
        self._prefix_lock = threading.Lock()
        # per-slot prefix state: hit tokens aliased at reserve, prompt pages
        # registered so far, and the chain node registration continues from
        self._slot_hit: List[int] = [0] * max_slots
        self._slot_reg: List[int] = [0] * max_slots
        self._slot_node: List[int] = [0] * max_slots

    # -- device pool --------------------------------------------------------
    def make_pools(self, device):
        """Fresh zeroed f32 (k_pages, v_pages) tensors
        [n_layers, num_pages, page_size, kv_dim] on `device`."""
        shape = (self.n_layers, self.num_pages, self.page_size, self.kv_dim)
        return (
            torch.zeros(shape, dtype=torch.float32, device=device),
            torch.zeros(shape, dtype=torch.float32, device=device),
        )

    # -- accounting ---------------------------------------------------------
    def pages_needed(self, total_len: int) -> int:
        return -(-int(total_len) // self.page_size)  # ceil div

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def _decref(self, page: int) -> bool:
        """Drop one reference; True when the page physically recycled."""
        rc = self._refcount[page] - 1
        self._refcount[page] = rc
        if rc == 0:
            self._free.append(page)
            return True
        return False

    def can_reserve(self, total_len: int) -> bool:
        n = self.pages_needed(total_len)
        avail = len(self._free)
        if self.prefix is not None:
            # unreferenced cached pages are reclaimable on demand (reserve
            # evicts LRU under pressure), so admission counts them as free
            with self._prefix_lock:
                avail += self.prefix.evictable(self._refcount)
        return n <= self.max_pages_per_seq and n <= avail

    # -- reserve / release --------------------------------------------------
    def reserve(
        self,
        slot: int,
        total_len: int,
        tenant: str = "default",
        prompt: Optional[Sequence[int]] = None,
    ) -> List[int]:
        """Reserve pages covering `total_len` tokens for `slot`; returns the
        physical page ids. Raises if the slot is occupied or pages are short —
        callers gate on can_reserve (admission control).

        With the prefix cache enabled and `prompt` given, the leading pages
        come ALIASED from the tenant's chain (read-only, +1 ref each) and
        only the uncached suffix pops fresh pages — `hit_tokens(slot)` then
        reports how many prompt tokens the slot skipped prefilling. Under
        pool pressure, unreferenced cached pages are LRU-evicted to make
        room before giving up."""
        if self._slot_pages[slot]:
            raise RuntimeError(f"slot {slot} already holds pages")
        n = self.pages_needed(total_len)
        if n > self.max_pages_per_seq:
            raise ValueError(
                f"sequence of {total_len} tokens needs {n} pages > "
                f"max_pages_per_seq={self.max_pages_per_seq}"
            )
        matched: List[int] = []
        node = 0
        if self.prefix is not None and prompt is not None:
            with self._prefix_lock:
                cow0 = self.prefix.cow_events
                matched, node = self.prefix.match(tenant, prompt)
                cow = self.prefix.cow_events - cow0
            # alias the cached prefix BEFORE any eviction below: ref >= 2
            # makes these pages invisible to evict_lru
            for p in matched:
                self._refcount[p] += 1
            if matched:
                obs_metrics.observe_prefix_hit(len(matched))
            if cow:
                obs_metrics.observe_prefix_cow(cow)
        need_fresh = n - len(matched)
        if need_fresh > len(self._free) and self.prefix is not None:
            evicted = 0
            with self._prefix_lock:
                while need_fresh > len(self._free):
                    page = self.prefix.evict_lru(self._refcount)
                    if page is None:
                        break
                    self._decref(page)  # the index's own reference
                    evicted += 1
            if evicted:
                obs_metrics.observe_prefix_evictions(evicted)
        if need_fresh > len(self._free):
            for p in matched:  # roll the aliases back — nothing reserved
                self._decref(p)
            raise RuntimeError(
                f"KV pool exhausted: need {need_fresh} pages, "
                f"{len(self._free)} free"
            )
        fresh = [self._free.pop() for _ in range(need_fresh)]
        for p in fresh:
            self._refcount[p] = 1
        pages = matched + fresh
        self._slot_pages[slot] = pages
        self._slot_hit[slot] = len(matched) * self.page_size
        self._slot_reg[slot] = len(matched)
        self._slot_node[slot] = node
        self._table[slot, :] = 0
        self._table[slot, : len(pages)] = pages
        return pages

    def hit_tokens(self, slot: int) -> int:
        """Prompt tokens slot `slot` aliased from the prefix cache at its
        reservation — the chunked prefill starts at exactly this offset."""
        return self._slot_hit[slot]

    def peek_hit_tokens(self, tenant: str, prompt: Sequence[int]) -> int:
        """Admission-pricing probe (Scheduler.submit): leading prompt tokens
        cached right now. Read-only — no recency bump, no counters — so the
        load estimate never perturbs eviction order. 0 when disabled."""
        if self.prefix is None:
            return 0
        with self._prefix_lock:
            return self.prefix.peek_hit_tokens(tenant, prompt)

    def commit_prefix(self, slot: int, tenant: str,
                      prompt: Sequence[int], committed_len: int) -> int:
        """Register slot `slot`'s prompt pages fully covered by
        `committed_len` committed tokens into the tenant's chain (the index
        takes one reference per NEWLY registered page, which is what lets
        the pages outlive the request). Incremental: called after the
        whole-prompt commit and after every prefill chunk, it only walks the
        pages added since the last call. Returns pages newly registered."""
        if self.prefix is None:
            return 0
        upto = min(int(committed_len), len(prompt)) // self.page_size
        frm = self._slot_reg[slot]
        if upto <= frm:
            return 0
        pages = self._slot_pages[slot]
        with self._prefix_lock:
            node, registered = self.prefix.extend(
                tenant, self._slot_node[slot], prompt, frm, upto, pages
            )
            for p in registered:
                self._refcount[p] += 1  # the index's reference
            self._slot_node[slot] = node
            self._slot_reg[slot] = upto
            evicted = self._enforce_cap_locked()
        if evicted:
            obs_metrics.observe_prefix_evictions(evicted)
        return len(registered)

    def _enforce_cap_locked(self) -> int:
        """Best-effort `prefix_cache_pages` cap (caller holds _prefix_lock):
        LRU-evict unreferenced entries until the index fits. Entries still
        aliased by live slots pin — the cap re-checks when those slots
        release. Returns pages evicted."""
        if self.prefix_cache_pages is None:
            return 0
        evicted = 0
        while len(self.prefix) > self.prefix_cache_pages:
            page = self.prefix.evict_lru(self._refcount)
            if page is None:
                break
            self._decref(page)
            evicted += 1
        return evicted

    def trim(self, slot: int, total_len: int) -> int:
        """Release the slot's surplus tail pages beyond what `total_len`
        tokens need (speculative-decode rollback): admission reserves
        `speculate_k` tokens of headroom so a verify chunk can always
        scatter its K+1 positions, and once the request's remaining budget
        can no longer use that headroom the surplus recycles here instead of
        riding to retirement. Tail pages are always private (aliased prefix
        pages sit at the FRONT and registration never reaches past the
        prompt), so the decref frees them physically. Returns how many
        pages were freed; idempotent."""
        pages = self._slot_pages[slot]
        keep = self.pages_needed(total_len)
        if not pages or keep >= len(pages):
            return 0
        surplus = pages[keep:]
        self._slot_pages[slot] = pages[:keep]
        freed = sum(1 for p in surplus if self._decref(p))
        self._table[slot, keep:] = 0
        return freed

    def release(self, slot: int) -> int:
        """Drop the slot's references (KV recycling); returns how many pages
        PHYSICALLY returned to the free list — a page another slot still
        aliases, or one the prefix index caches, only decrefs (satellite 2:
        cancel/retire accounting counts each physical free exactly once).
        Idempotent for an empty slot."""
        pages = self._slot_pages[slot]
        self._slot_pages[slot] = []
        freed = sum(1 for p in pages if self._decref(p))
        self._table[slot, :] = 0
        self._slot_hit[slot] = 0
        self._slot_reg[slot] = 0
        self._slot_node[slot] = 0
        if self.prefix is not None and self.prefix_cache_pages is not None:
            # this release may have unpinned cached entries past the cap
            with self._prefix_lock:
                evicted = self._enforce_cap_locked()
            if evicted:
                obs_metrics.observe_prefix_evictions(evicted)
        return freed

    def flush_prefix(self) -> int:
        """Drop every prefix-index entry and release the index's references;
        pages no slot holds return to the free list (the rest recycle when
        their slots release). Benches/tests use this for the zero-leak gate;
        live slots keep decoding untouched — their aliased pages stay
        referenced, only un-cacheable from now on."""
        if self.prefix is None:
            return 0
        with self._prefix_lock:
            pages = self.prefix.drop_all()
        freed = sum(1 for p in pages if self._decref(p))
        # chain continuation points are gone: let still-prefilling slots
        # re-register from the root on their next commit
        self._slot_reg = [0] * self.max_slots
        self._slot_node = [0] * self.max_slots
        return freed

    def slot_pages(self, slot: int) -> List[int]:
        return list(self._slot_pages[slot])

    def page_refcount(self, page: int) -> int:
        return self._refcount[page]

    def prefix_stats(self) -> dict:
        """The prefix-cache telemetry block session.stats() embeds — stable
        keys whether or not the cache is enabled."""
        if self.prefix is None:
            return {
                "prefix_cache_enabled": False,
                "prefix_hit_rate": 0.0,
                "prefix_pages_shared": 0,
                "prefix_pages_cached": 0,
                "prefix_pages_cow": 0,
                "prefix_evictions": 0,
                "prefix_hit_rate_by_tenant": {},
            }
        with self._prefix_lock:
            d = self.prefix.stats()
            d["prefix_pages_unreferenced"] = self.prefix.evictable(
                self._refcount
            )
        d["prefix_cache_enabled"] = True
        d["prefix_cache_pages_cap"] = self.prefix_cache_pages
        return d

    def reset(self) -> None:
        """Rebuild the allocator to its just-constructed state (engine crash
        recovery): every page free, every slot empty, table zeroed — and the
        prefix index INVALIDATED, because replayed requests re-commit their
        K/V into the re-initialised pools. The device pools are not touched
        here: the session re-initialises them in place (`zero_()`), so the
        captured decode graph's pointers stay valid."""
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._refcount = [0] * self.num_pages
        self._slot_pages = [[] for _ in range(self.max_slots)]
        self._slot_hit = [0] * self.max_slots
        self._slot_reg = [0] * self.max_slots
        self._slot_node = [0] * self.max_slots
        self._table[:] = 0
        if self.prefix is not None:
            with self._prefix_lock:
                self.prefix.drop_all()

    def block_table(self) -> np.ndarray:
        """The [max_slots, max_pages_per_seq] int32 table (live view — the
        session copies it to the device each step). The CUDA decode kernel
        (ops/paged_attention.py) reads its rows to find each slot's pages."""
        return self._table

    def slot_row(self, slot: int) -> np.ndarray:
        """One slot's [1, max_pages_per_seq] block-table row — the shape the
        per-slot prefill/commit/chunk steps take (live view)."""
        return self._table[slot : slot + 1]
