"""Shared-prefix index: per-tenant chains over committed full KV pages.

The port's copy of `paddle_tpu/serving/prefix_cache.py` (pure host code).

Real traffic is a handful of system prompts × millions of user
turns, so the dominant wasted prefill FLOPs are re-computing KV for tokens
some earlier request already committed. The paged KV design makes reuse a
pure block-table aliasing trick — and this module is the *host-side lookup
structure only*: it never touches a device array, a socket or a clock
(the JAX package lints its copy for all three), and it never owns a page.
Refcounts and the free list stay in PagedKVCache; the index merely says
"these physical pages already hold the KV for this token prefix".

Structure: a radix-style chain of nodes, one node per FULL page of prompt
tokens. A node's identity is ``(parent_node_id, tuple(page_tokens))`` — an
exact-match dict key, so "hashing" is Python's tuple hash with equality
collision resolution: two different token chunks can never alias the same
node, and the chain id encodes the ENTIRE prefix up to that page. Chains
are rooted per tenant (the root node id namespaces every key), so two
tenants submitting identical text walk disjoint chains and can never see
each other's pages.

Copy-on-write is implicit in the page-granularity design: only full,
immutable prompt pages enter the index, a matching request aliases the
matched prefix READ-ONLY and allocates a private page at the first
divergent page (its own chunked prefill recomputes any partial overlap
there — identical math, no device-side page copy). The `cow_events`
counter records lookups that stopped at a genuine divergence (the parent
node had cached continuations, just not ours).

Recency is a LOGICAL tick (a counter bumped per lookup/insert), not a wall
clock: eviction order only needs relative recency, and the admission path
must not grow a second clock source (the clock-ok lint discipline)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["PrefixIndex"]


class _Node:
    """One cached full page of some tenant's prompt stream."""

    __slots__ = ("node_id", "parent_id", "chunk", "page", "children", "tick")

    def __init__(self, node_id: int, parent_id: int,
                 chunk: Tuple[int, ...], page: int, tick: int):
        self.node_id = node_id
        self.parent_id = parent_id
        self.chunk = chunk
        self.page = page
        self.children = 0
        self.tick = tick


class PrefixIndex:
    """Per-tenant chain index mapping page-aligned token prefixes to the
    physical pages that already hold their committed KV.

    Pure host bookkeeping: the caller (PagedKVCache) owns refcounts and
    takes one reference per node registered here, released when the node is
    evicted — the index itself only stores ids and counters."""

    def __init__(self, page_size: int):
        self.page_size = int(page_size)
        # node id 0 is never used; per-tenant roots are synthetic nodes that
        # exist only as parent ids (no page, never evicted)
        self._next_id = 1
        self._roots: Dict[str, int] = {}
        # (parent_node_id, page_tokens_tuple) -> _Node; the dict IS the hash
        # index — exact-match keys, so distinct prefixes can never collide
        self._nodes: Dict[Tuple[int, Tuple[int, ...]], _Node] = {}
        self._by_id: Dict[int, _Node] = {}
        self._tick = 0
        # telemetry (cumulative across resets — reset drops the INDEX, not
        # the counters, so a crash-recovered engine keeps its history)
        self.hits = 0              # lookups that matched >= 1 page
        self.lookups = 0
        self.hit_tokens = 0        # prompt tokens served from cached pages
        self.lookup_tokens = 0     # prompt tokens examined across lookups
        self.pages_shared = 0      # aliases handed out (page x request)
        self.pages_inserted = 0
        self.evictions = 0
        self.cow_events = 0        # lookups that stopped at a divergent page
        self.hit_tokens_by_tenant: Dict[str, int] = {}
        self.lookup_tokens_by_tenant: Dict[str, int] = {}

    # -- views ---------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._nodes)

    def pages(self) -> List[int]:
        """Every physical page the index holds a reference on."""
        return [n.page for n in self._nodes.values()]

    def holds(self, page: int) -> bool:
        return any(n.page == page for n in self._nodes.values())

    def _root_for(self, tenant: str, create: bool) -> Optional[int]:
        root = self._roots.get(tenant)
        if root is None and create:
            root = self._next_id
            self._next_id += 1
            self._roots[tenant] = root
        return root

    @staticmethod
    def max_match_pages(prompt_len: int, page_size: int) -> int:
        """How many leading pages of a prompt a request may ALIAS: full
        pages only, and never the whole prompt — the last prompt token is
        always recomputed so the final prefill chunk has >= 1 token to
        forward (its logits sample the request's first token)."""
        return max(0, (int(prompt_len) - 1) // int(page_size))

    # -- lookup --------------------------------------------------------------
    def match(self, tenant: str, prompt: Sequence[int],
              peek: bool = False) -> Tuple[List[int], int]:
        """Walk the tenant's chain along `prompt` and return
        ``(matched_pages, last_node_id)`` — the physical pages whose KV this
        prompt can alias read-only, capped at `max_match_pages`, and the
        node id registration should continue from. `peek=True` is the
        admission-pricing probe: it bumps no recency ticks and no counters
        (Scheduler.submit estimates the uncached suffix without perturbing
        eviction order)."""
        ps = self.page_size
        limit = self.max_match_pages(len(prompt), ps)
        root = self._root_for(tenant, create=not peek)
        if not peek:
            self._tick += 1
            self.lookups += 1
            self.lookup_tokens += len(prompt)
            self.lookup_tokens_by_tenant[tenant] = (
                self.lookup_tokens_by_tenant.get(tenant, 0) + len(prompt)
            )
        if root is None:
            return [], 0
        pages: List[int] = []
        parent = root
        for i in range(limit):
            chunk = tuple(int(t) for t in prompt[i * ps:(i + 1) * ps])
            node = self._nodes.get((parent, chunk))
            if node is None:
                # the COW boundary: cached continuations exist under this
                # parent but none matches OUR tokens — the caller allocates
                # a private page here and recomputes from this position
                if not peek:
                    pnode = self._by_id.get(parent)
                    siblings = (pnode.children if pnode is not None
                                else self._root_children(parent))
                    if siblings > 0:
                        self.cow_events += 1
                break
            if not peek:
                node.tick = self._tick
            pages.append(node.page)
            parent = node.node_id
        if not peek and pages:
            self.hits += 1
            self.hit_tokens += len(pages) * ps
            self.hit_tokens_by_tenant[tenant] = (
                self.hit_tokens_by_tenant.get(tenant, 0) + len(pages) * ps
            )
            self.pages_shared += len(pages)
        return pages, parent

    def _root_children(self, root: int) -> int:
        return sum(1 for (pid, _), _n in self._nodes.items() if pid == root)

    def peek_hit_tokens(self, tenant: str, prompt: Sequence[int]) -> int:
        """Admission-pricing probe: how many leading prompt tokens are
        cached RIGHT NOW (no recency bump, no counters)."""
        pages, _ = self.match(tenant, prompt, peek=True)
        return len(pages) * self.page_size

    # -- registration --------------------------------------------------------
    def extend(self, tenant: str, parent: int, prompt: Sequence[int],
               from_page: int, upto_page: int,
               slot_pages: Sequence[int]) -> Tuple[int, List[int]]:
        """Register pages ``[from_page, upto_page)`` of `prompt` (committed
        by the slot that owns `slot_pages`) as cached, continuing the chain
        from node `parent`. Returns ``(new_parent, registered_pages)`` —
        only pages for which a NEW node was created (the caller takes one
        index reference each). A level whose node already exists (another
        slot registered the same prefix first) keeps the existing node and
        page: chains may interleave physical pages from different
        originators, which is sound because a page's KV content is a pure
        function of its token prefix."""
        ps = self.page_size
        if parent == 0:
            parent = self._root_for(tenant, create=True)
        self._tick += 1
        registered: List[int] = []
        for i in range(from_page, upto_page):
            chunk = tuple(int(t) for t in prompt[i * ps:(i + 1) * ps])
            key = (parent, chunk)
            node = self._nodes.get(key)
            if node is None:
                node = _Node(self._next_id, parent, chunk,
                             int(slot_pages[i]), self._tick)
                self._next_id += 1
                self._nodes[key] = node
                self._by_id[node.node_id] = node
                pnode = self._by_id.get(parent)
                if pnode is not None:
                    pnode.children += 1
                registered.append(node.page)
                self.pages_inserted += 1
            else:
                node.tick = self._tick
            parent = node.node_id
        return parent, registered

    # -- eviction ------------------------------------------------------------
    def evictable(self, refcount: Sequence[int]) -> int:
        """Pages reclaimable under pool pressure: index-held pages no slot
        references (refcount 1 = the index's own reference). Every such
        page is reachable by cascading leaf evictions — a slot aliasing a
        DEEPER node would hold references on every ancestor too."""
        return sum(1 for n in self._nodes.values() if refcount[n.page] == 1)

    def evict_lru(self, refcount: Sequence[int]) -> Optional[int]:
        """Drop the least-recently-used LEAF node whose page only the index
        references; returns the freed page id (caller releases the index's
        reference) or None when nothing is evictable."""
        victim_key = None
        victim = None
        for key, n in self._nodes.items():
            if n.children == 0 and refcount[n.page] == 1:
                if victim is None or n.tick < victim.tick:
                    victim_key, victim = key, n
        if victim is None:
            return None
        del self._nodes[victim_key]
        del self._by_id[victim.node_id]
        pnode = self._by_id.get(victim.parent_id)
        if pnode is not None:
            pnode.children -= 1
        self.evictions += 1
        return victim.page

    def drop_all(self) -> List[int]:
        """Empty the index (flush / crash invalidation), returning every
        page it held a reference on so the caller can release them. Unlike
        evict_lru this drops nodes regardless of slot references — a page a
        slot still uses simply loses its INDEX reference and recycles when
        the slot releases it."""
        pages = [n.page for n in self._nodes.values()]
        self._nodes.clear()
        self._by_id.clear()
        self._roots.clear()
        return pages

    # -- telemetry -----------------------------------------------------------
    def stats(self) -> Dict:
        rate = (self.hit_tokens / self.lookup_tokens
                if self.lookup_tokens else 0.0)
        by_tenant = {
            t: round(self.hit_tokens_by_tenant.get(t, 0) / lt, 4)
            for t, lt in self.lookup_tokens_by_tenant.items() if lt
        }
        return {
            "prefix_hit_rate": round(rate, 4),
            "prefix_lookups": self.lookups,
            "prefix_hits": self.hits,
            "prefix_hit_tokens": self.hit_tokens,
            "prefix_lookup_tokens": self.lookup_tokens,
            "prefix_pages_shared": self.pages_shared,
            "prefix_pages_inserted": self.pages_inserted,
            "prefix_pages_cached": len(self._nodes),
            "prefix_pages_cow": self.cow_events,
            "prefix_evictions": self.evictions,
            "prefix_hit_rate_by_tenant": by_tenant,
            "prefix_hit_tokens_by_tenant": dict(self.hit_tokens_by_tenant),
        }
