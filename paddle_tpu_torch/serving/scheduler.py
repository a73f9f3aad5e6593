"""Continuous-batching scheduler: requests, slots, and step-boundary joins.

The host-side half of the serving runtime. A request's life:

    submit -> admission control (queue bound + load-aware shed + tenant
    quota) -> waiting -> [step boundary] slot + KV pages reserved, prefill
    -> decoding -> EOS / token budget -> retired (pages recycled, handle
    completed)

and every exit from that pipeline is *named*: a request that
cannot make its deadline is shed at the front door (`overload`, with a
`retry_after_ms` hint), expires in the queue or at a decode-step boundary
(`deadline`), is cancelled by its abandoning client (`client_timeout`), or
is failed by a dead engine (`engine_error`) — never silently dropped, and
its KV pages are recycled the moment it leaves.

The defining property of continuous batching is that admissions and
retirements happen at *decode step boundaries*, never inside one: a new
request joins the very next step after a slot frees up, and a finished
sequence stops occupying its slot immediately — the batch never stalls
waiting for its longest member (the per-request RPC round-trip model this
replaces is the fleet-size cap named in "RPC Considered Harmful", PAPERS.md).
Deadline checks obey the same discipline: ONE wall-clock read per engine
step (taken by the session) feeds expiry for every queued and running
request (the JAX package lints its copy in tests/test_lint_hotloop.py).

This module is pure host bookkeeping (deterministic, unit-testable); the
device work lives in session.ServingSession."""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from paddle_tpu_torch.obs import metrics as obs_metrics
from paddle_tpu_torch.serving.kv_cache import PagedKVCache
from paddle_tpu_torch.serving.quota import QuotaExceeded, TenantQuotas

# end-to-end request latency (submit → done), observed at retirement —
# unconditional telemetry, exported via the `metrics` RPC / obs export CLI
REQUEST_HISTOGRAM = obs_metrics.REGISTRY.histogram(
    "paddle_tpu_serving_request_seconds",
    "submit → completion, per retired request",
)


class FinishReason:
    EOS = "eos"
    LENGTH = "length"
    CANCELLED = "cancelled"
    DEADLINE = "deadline"          # total-latency deadline expired
    CLIENT_TIMEOUT = "client_timeout"  # result(timeout=) abandoned the work
    ENGINE_ERROR = "engine_error"  # engine died past its restart budget


class RequestHandle:
    """Caller-facing future for one generation request.

    `result()` blocks until the request finishes and returns the generated
    token ids; a cancelled request raises. By default a `result(timeout=)`
    expiry also CANCELS the request server-side — the older behavior
    (client times out, request keeps decoding and holding KV pages) leaked
    work nobody would collect. Timing fields feed the latency bench
    (t_submit/t_first_token/t_done, all time.monotonic); t_deadline /
    t_ttft_deadline are absolute monotonic deadlines (None = none)."""

    QUEUED = "queued"
    RUNNING = "running"
    DONE = "done"
    CANCELLED = "cancelled"

    def __init__(self, request_id: int, tenant: str, prompt_len: int,
                 max_new_tokens: int,
                 deadline_s: Optional[float] = None,
                 ttft_deadline_s: Optional[float] = None,
                 seed: Optional[int] = None,
                 temperature: float = 0.0,
                 top_k: int = 0):
        self.request_id = request_id
        self.tenant = tenant
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        # sampling identity: the per-request seed is part of the
        # REQUEST, not the engine — a crash-replayed request reuses it (with
        # the token's step index) so restart recovery regenerates bitwise-
        # identical tokens even at temperature > 0. Default: the request id,
        # stable across replay and across same-order submission streams.
        self.seed = int(request_id if seed is None else seed) & 0xFFFFFFFF
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.status = self.QUEUED
        self.tokens: List[int] = []
        self.finish_reason: Optional[str] = None
        self.t_submit = time.monotonic()
        self.t_first_token: Optional[float] = None
        self.t_done: Optional[float] = None
        self.t_deadline = (
            None if deadline_s is None else self.t_submit + float(deadline_s)
        )
        self.t_ttft_deadline = (
            None if ttft_deadline_s is None
            else self.t_submit + float(ttft_deadline_s)
        )
        # trace context ({"t": trace_id, "s": span_id}) captured at submit
        # time (ServingSession.submit) so engine-thread spans — queue-wait,
        # prefill, ttft — stitch under the submitting RPC's trace id
        self.trace_ctx: Optional[dict] = None
        # back-reference for cancel(); set by Scheduler.submit
        self._scheduler: Optional["Scheduler"] = None
        # TTFT histogram/miss-counter latch: a crash-replayed request gets a
        # fresh t_first_token but must be OBSERVED exactly once (session._admit)
        self.ttft_observed = False
        # prefix-cache admission-pricing hint: leading prompt
        # tokens the cache held at SUBMIT time (read-only peek). Load
        # estimates price this request's prefill by its uncached suffix;
        # the authoritative hit is re-measured at reservation (ActiveSeq
        # .prefix_hit) — the cache may have warmed or evicted meanwhile.
        self.prefix_hint = 0
        self._event = threading.Event()

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def cancel(self, reason: str = FinishReason.CANCELLED) -> bool:
        """Cancel this request: a queued request completes CANCELLED
        immediately; a running one is retired (pages recycled) at the next
        decode-step boundary. False when already finished."""
        if self._scheduler is None or self.done:
            return False
        return self._scheduler.cancel(self.request_id, reason)

    def result(self, timeout: Optional[float] = None,
               cancel_on_timeout: bool = True) -> List[int]:
        if not self._event.wait(timeout):
            if cancel_on_timeout:
                # the fix for the classic leak: an abandoning client must not
                # leave its request decoding into the void while holding KV
                # pages — cancel it so the slot + pages recycle at the next
                # step boundary (serving/scheduler.py reap)
                self.cancel(FinishReason.CLIENT_TIMEOUT)
            raise TimeoutError(
                f"request {self.request_id} not done after {timeout}s"
                + ("; cancelled server-side" if cancel_on_timeout else "")
            )
        if self.status == self.CANCELLED:
            raise RuntimeError(
                f"request {self.request_id} cancelled ({self.finish_reason})"
            )
        return self.tokens

    def _complete(self, status: str, reason: str) -> None:
        self.status = status
        self.finish_reason = reason
        self.t_done = time.monotonic()
        self._event.set()


class _Waiting:
    __slots__ = ("handle", "prompt")

    def __init__(self, handle: RequestHandle, prompt: List[int]):
        self.handle = handle
        self.prompt = prompt


class ActiveSeq:
    """One occupied decode slot: the sequence's last token + position ride
    into every decode step; everything else is retained host-side.

    Chunked prefill: `prefill_pos` counts the prompt tokens whose
    K/V is committed so far. The session's chunked path admits long prompts
    with prefill_pos=0 and advances one chunk per engine step; a slot is
    `prefilling` until the whole prompt is committed and joins decode steps
    only after — so a long prompt never steals a decode step from the
    already-decoding slots."""

    __slots__ = ("handle", "prompt", "last_token", "next_pos", "generated",
                 "t_started", "prefill_pos", "engine_steps", "prefix_hit")

    def __init__(self, handle: RequestHandle, prompt: List[int]):
        self.handle = handle
        self.prompt = prompt
        self.last_token: int = -1  # set by prefill
        self.next_pos: int = len(prompt)  # position the last token occupies
        self.generated: int = 0
        self.t_started: Optional[float] = None  # set at admission
        self.prefill_pos: int = len(prompt)  # chunked path resets to 0
        # prompt tokens aliased from the prefix cache at reservation:
        # the session starts this slot's chunked prefill HERE —
        # the aliased pages' KV is already committed — and the retire-time
        # EWMA prices the prefill by the remaining suffix only
        self.prefix_hit: int = 0
        # engine steps this sequence actually consumed (one per decode step
        # it rode, one per verify round): with speculative decoding emitting
        # >1 token per step, `generated` stops being a step count — the
        # retire-time EWMA prices steps off THIS when speculation is on
        self.engine_steps: int = 0

    @property
    def prefilling(self) -> bool:
        return self.prefill_pos < len(self.prompt)

    def append(self, token: int) -> None:
        self.handle.tokens.append(int(token))
        self.generated += 1
        if self.generated == 1:
            # clock-ok: once per REQUEST (not per token) — the TTFT stamp
            self.handle.t_first_token = time.monotonic()
        else:
            self.next_pos += 1
        self.last_token = int(token)

    def finished(self, eos_id: int) -> Optional[str]:
        if self.generated and self.last_token == eos_id:
            return FinishReason.EOS
        if self.generated >= self.handle.max_new_tokens:
            return FinishReason.LENGTH
        return None


class Scheduler:
    """Slot + queue management; thread-safe against concurrent submits."""

    # EWMA smoothing for the observed per-request service time that feeds
    # the queue-wait estimate (load-aware shedding)
    SERVICE_EWMA_ALPHA = 0.3

    def __init__(
        self,
        cache: PagedKVCache,
        max_queue: int = 256,
        quotas: Optional[TenantQuotas] = None,
        prefill_chunk: Optional[int] = None,
        largest_bucket: Optional[int] = None,
        speculate_k: int = 0,
    ):
        self.cache = cache
        self.max_queue = max_queue
        self.quotas = quotas
        # chunked-prefill geometry (None = whole-prompt prefill): the load
        # estimator charges each chunk one engine step, so a flood of long
        # prompts raises the wait estimate the way it raises real TTFT;
        # largest_bucket mirrors the session's routing (a prompt beyond
        # every bucket chunks even when it fits one chunk)
        self.prefill_chunk = prefill_chunk
        self.largest_bucket = largest_bucket
        # speculative decoding: admission reserves K extra tokens of page
        # headroom per request so a verify chunk's K+1 scatter always has
        # pages behind it; the session trims the surplus back to the free
        # list once a request's remaining budget can no longer use it
        # (kv_cache.trim). 0 = the exact reservation.
        self.speculate_k = max(0, int(speculate_k))
        self.lock = threading.Lock()
        self.waiting: Deque[_Waiting] = collections.deque()
        self.slots: List[Optional[ActiveSeq]] = [None] * cache.max_slots
        self._ids = itertools.count()
        # cancellations requested for RUNNING sequences; honored at the next
        # decode-step boundary (reap) so they never interrupt a step
        self._cancel_req: Dict[int, str] = {}
        # EWMA of admission→done wall time, the basis of estimate_wait_s,
        # plus an EWMA of per-ENGINE-STEP time (service / steps observed at
        # retirement) that prices prefill chunks into the estimates
        self._ewma_service_s: Optional[float] = None
        self._ewma_step_s: Optional[float] = None
        # counters surfaced through session.stats()
        self.completed = 0
        self.rejected = 0
        self.cancelled = 0
        self.shed = 0
        self.deadline_misses = 0
        self.pages_recycled_on_cancel = 0

    # -- intake -------------------------------------------------------------
    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: int,
        tenant: str,
        trace_ctx: Optional[dict] = None,
        deadline_s: Optional[float] = None,
        ttft_deadline_s: Optional[float] = None,
        seed: Optional[int] = None,
        temperature: float = 0.0,
        top_k: int = 0,
    ) -> RequestHandle:
        """Admission control happens HERE, synchronously: the caller learns
        'no' at the front door, not by timing out in a silent queue. Three
        gates, in order: the queue bound, the load-aware deadline check (a
        request whose estimated queue wait already exceeds its deadline
        budget is doomed — admitting it would burn a slot on work nobody can
        use; shed it with `retry_after_ms` instead), then the tenant quota.
        trace_ctx must ride in (not be set on the returned handle after):
        the engine thread can pop the request the instant it is queued, so
        the context has to be on the handle BEFORE it becomes visible."""
        prompt = [int(t) for t in prompt]
        total = len(prompt) + max_new_tokens
        # prefix-cache pricing peek: how much of this prompt's
        # prefill is already cached RIGHT NOW. Read-only (no recency bump) —
        # the ONE sanctioned admission-path hash computation (lint-pinned);
        # 0 with the cache off, so estimates are bitwise the old ones.
        cached = self.cache.peek_hit_tokens(tenant, prompt)
        with self.lock:
            if len(self.waiting) >= self.max_queue:
                self.rejected += 1
                self.shed += 1
                obs_metrics.observe_shed("queue")
                raise QuotaExceeded(
                    f"request queue full ({self.max_queue})", "queue",
                    retry_after_ms=self._retry_hint_ms(total, len(prompt)),
                )
            if deadline_s is not None:
                if deadline_s <= 0:
                    self.rejected += 1
                    self.shed += 1
                    obs_metrics.observe_shed("deadline")
                    raise QuotaExceeded(
                        f"deadline of {deadline_s}s already expired at "
                        f"admission", "deadline",
                        retry_after_ms=self._retry_hint_ms(total, len(prompt)),
                    )
                est = self._estimate_wait_s(total, len(prompt), cached)
                if est > deadline_s:
                    self.rejected += 1
                    self.shed += 1
                    obs_metrics.observe_shed("overload")
                    raise QuotaExceeded(
                        f"overloaded: estimated completion {est:.2f}s exceeds "
                        f"the request's {deadline_s:.2f}s deadline budget",
                        "overload",
                        retry_after_ms=self._retry_hint_ms(total, len(prompt)),
                    )
            # the TTFT budget is compared against the QUEUE-WAIT estimate,
            # never the completion estimate: a TTFT deadline shorter than one
            # service time must not shed requests on an idle server (TTFT ≈
            # queue wait + prefill, and the contract is "counted, not fatal"
            # — an already-expired TTFT budget just counts a miss later)
            if ttft_deadline_s is not None and ttft_deadline_s > 0:
                est_ttft = self._estimate_ttft_wait_s(total, len(prompt),
                                                      cached)
                if est_ttft > ttft_deadline_s:
                    self.rejected += 1
                    self.shed += 1
                    obs_metrics.observe_shed("overload")
                    raise QuotaExceeded(
                        f"overloaded: estimated queue wait {est_ttft:.2f}s "
                        f"exceeds the request's {ttft_deadline_s:.2f}s TTFT "
                        f"budget", "overload",
                        retry_after_ms=self._retry_hint_ms(total, len(prompt)),
                    )
            if self.quotas is not None:
                try:
                    self.quotas.admit(tenant, total)
                except QuotaExceeded:
                    self.rejected += 1
                    raise
            handle = RequestHandle(
                next(self._ids), tenant, len(prompt), max_new_tokens,
                deadline_s=deadline_s, ttft_deadline_s=ttft_deadline_s,
                seed=seed, temperature=temperature, top_k=top_k,
            )
            handle.trace_ctx = trace_ctx
            handle._scheduler = self
            handle.prefix_hint = cached
            self.waiting.append(_Waiting(handle, prompt))
            return handle

    # -- load estimate ------------------------------------------------------
    def _chunk_steps(self, prompt_len: int, cached: int = 0) -> int:
        """Chunk-budget engine steps a prompt's prefill costs: ceil(len/C)
        when it routes to the chunked path (longer than one chunk, or longer
        than every bucket — ServingSession._chunked_prompt's rule), else 0
        (whole-prompt prefill rides its admission boundary). The SAME count
        prices a queued prompt and, via remaining-token ceil, one already
        mid-prefill — so the estimate never jumps across admission.

        `cached` is the prompt's prefix-cache hit: a hit routes
        through the chunked path starting at the first un-cached token, so
        the request is priced by its SUFFIX — ceil((len - cached)/C) — which
        is exactly the engine steps its prefill will actually occupy. The
        floor of one step keeps a fully-page-matched prompt priced at its
        final (always recomputed) chunk."""
        c = self.prefill_chunk
        if c is None:
            return 0
        cached = min(max(0, int(cached)), max(0, prompt_len - 1))
        routed_chunked = cached > 0 or prompt_len > c or (
            self.largest_bucket is not None and prompt_len > self.largest_bucket
        )
        if not routed_chunked:
            return 0
        return -(-int(prompt_len - cached) // c)

    def _estimate_wait_s(self, total_len: int, prompt_len: int = 0,
                         cached: int = 0) -> float:
        """Expected time for a request of `total_len` tokens to COMPLETE
        (queue wait + its own service), under self.lock — what a deadline
        budget must cover. The queue drains in waves of up to max_slots
        requests, each taking ~one EWMA service time; the request's own
        decode is one more wave, and free-page pressure (pool cannot host it
        right now) adds another. Chunked prefill is priced per chunk: every
        extra chunk — the queue's and this request's own — occupies one
        whole engine step (per-step EWMA observed at retirement), which is
        exactly how long prompts actually delay everyone's wall clock.
        Optimistic (0) until the first retirement seeds the EWMA — cold
        starts admit."""
        svc = self._ewma_service_s
        if svc is None:
            return 0.0
        free_slot = any(a is None for a in self.slots)
        fits_now = free_slot and self.cache.can_reserve(
            total_len + self.speculate_k
        )
        depth = len(self.waiting)
        step_s = self._ewma_step_s or 0.0
        c = self.prefill_chunk
        # chunks still to commit for prompts ALREADY mid-prefill in slots:
        # each one is a whole engine step everybody waits behind, same as
        # the queued and own chunks below
        in_flight_chunks = 0 if c is None else sum(
            -(-(len(a.prompt) - a.prefill_pos) // c)
            for a in self.slots if a is not None and a.prefilling
        )
        # queued prompts price by their uncached suffix (the submit-time
        # peek on the handle); mid-prefill slots auto-correct below — a
        # prefix hit started prefill_pos at the hit, so the remaining-token
        # ceil already charges only the suffix
        chunk_cost = step_s * (
            self._chunk_steps(prompt_len, cached)
            + sum(
                self._chunk_steps(w.handle.prompt_len, w.handle.prefix_hint)
                for w in self.waiting
            )
            + in_flight_chunks
        )
        if depth == 0 and fits_now:
            return svc + chunk_cost  # empty queue: its own decode + chunks
        waves = depth / max(1, self.cache.max_slots) + 1.0
        if not fits_now:
            waves += 1.0
        return waves * svc + chunk_cost

    def _estimate_ttft_wait_s(self, total_len: int, prompt_len: int = 0,
                              cached: int = 0) -> float:
        """Expected wait until the FIRST token (under self.lock): the
        completion estimate minus the request's own decode wave — the
        queue-drain time ahead of it plus its OWN prefill chunks (a chunked
        long prompt's first token only lands after its last chunk). 0 on an
        idle server with room."""
        svc = self._ewma_service_s
        if svc is None:
            return 0.0
        return max(
            0.0, self._estimate_wait_s(total_len, prompt_len, cached) - svc
        )

    def _retry_hint_ms(self, total_len: int, prompt_len: int = 0) -> int:
        # under self.lock; the hint is "when could this plausibly fit":
        # the estimated wait, floored at one service time (or 10ms cold)
        est = self._estimate_wait_s(total_len, prompt_len)
        floor = self._ewma_service_s or 0.01
        return max(1, int(1000 * max(est, floor)))

    def estimate_wait_s(self, total_len: int = 0, prompt_len: int = 0) -> float:
        with self.lock:
            return self._estimate_wait_s(total_len, prompt_len)

    def reset_load_estimate(self) -> None:
        """Forget the observed service-time EWMAs. Benches and warmup paths
        need this: a compile-heavy first round observes second-scale
        'service times' that would make the load-aware admission check shed
        everything against a millisecond-scale deadline budget until enough
        steady-state retirements wash the EWMA out."""
        with self.lock:
            self._ewma_service_s = None
            self._ewma_step_s = None

    # -- cancellation + deadline reaping ------------------------------------
    def _finalize(self, handle: RequestHandle, reason: str,
                  refund_tokens: int, freed_pages: int) -> None:
        """The ONE completion path for every cancellation exit (queued
        cancel, reap expiry, doomed-at-admission, crash requeue): refund the
        tenant quota, emit the page-recycle / deadline-miss metrics, wake
        the caller. Must run OUTSIDE self.lock (quota has its own lock and
        _complete wakes waiters)."""
        if self.quotas is not None:
            self.quotas.release(handle.tenant, refund_tokens)
        if freed_pages:
            obs_metrics.observe_pages_recycled(freed_pages)
        if reason == FinishReason.DEADLINE:
            obs_metrics.observe_deadline_miss("total")
        handle._complete(RequestHandle.CANCELLED, reason)

    def cancel(self, request_id: int,
               reason: str = FinishReason.CANCELLED) -> bool:
        """Cancel one request by id. Queued → completed CANCELLED now (quota
        refunded, nothing was reserved); running → marked, retired with its
        pages recycled at the next decode-step boundary (reap). False when
        unknown or already finished."""
        victim: Optional[_Waiting] = None
        with self.lock:
            for w in self.waiting:
                if w.handle.request_id == request_id:
                    victim = w
                    break
            if victim is not None:
                self.waiting.remove(victim)
                self.cancelled += 1
            else:
                for act in self.slots:
                    if act is not None and act.handle.request_id == request_id:
                        self._cancel_req[request_id] = reason
                        return True
                return False
        h = victim.handle
        self._finalize(h, reason, h.prompt_len + h.max_new_tokens, 0)
        return True

    def reap(self, now: Optional[float] = None) -> int:
        """Step-boundary sweep, called once per engine step with that step's
        single timestamp: expire queued + running requests past their total
        deadline and honor pending cancellations, recycling KV pages
        immediately. Returns how many requests were removed."""
        # clock-ok: fallback for direct (test) calls — the engine passes its
        # single per-step timestamp, so expiry never reads per request
        now = time.monotonic() if now is None else now
        removed: List[Tuple[RequestHandle, str, int, int]] = []
        with self.lock:
            if self.waiting and any(
                w.handle.t_deadline is not None for w in self.waiting
            ):
                keep: Deque[_Waiting] = collections.deque()
                for w in self.waiting:
                    h = w.handle
                    if h.t_deadline is not None and now >= h.t_deadline:
                        self.cancelled += 1
                        self.deadline_misses += 1
                        removed.append(
                            (h, FinishReason.DEADLINE,
                             h.prompt_len + h.max_new_tokens, 0)
                        )
                    else:
                        keep.append(w)
                self.waiting = keep
            for slot, act in enumerate(self.slots):
                if act is None:
                    continue
                h = act.handle
                reason = self._cancel_req.pop(h.request_id, None)
                if (reason is None and h.t_deadline is not None
                        and now >= h.t_deadline):
                    reason = FinishReason.DEADLINE
                if reason is None:
                    continue
                self.slots[slot] = None
                freed = self.cache.release(slot)
                self.pages_recycled_on_cancel += freed
                self.cancelled += 1
                if reason == FinishReason.DEADLINE:
                    self.deadline_misses += 1
                removed.append(
                    (h, reason,
                     max(0, h.max_new_tokens - act.generated), freed)
                )
        for h, reason, refund, freed in removed:
            self._finalize(h, reason, refund, freed)
        return len(removed)

    # -- step-boundary transitions ------------------------------------------
    def pop_admissions(
        self, now: Optional[float] = None
    ) -> List[Tuple[int, ActiveSeq]]:
        """Move waiting requests into free slots while KV pages allow —
        called once per engine step, so joins land exactly at step
        boundaries. A queued request whose remaining deadline budget no
        longer covers one service time is DOOMED: it is failed here
        ('deadline') instead of being handed a slot it would die holding —
        under overload that one check is most of what keeps goodput flat
        (slot time only goes to requests that can still finish). Returns
        [(slot, ActiveSeq)] needing prefill."""
        # clock-ok: fallback for direct (test) calls — the engine passes its
        # single per-step timestamp
        now = time.monotonic() if now is None else now
        admitted: List[Tuple[int, ActiveSeq]] = []
        doomed: List[RequestHandle] = []
        with self.lock:
            svc = self._ewma_service_s
            for slot in range(len(self.slots)):
                while self.waiting:
                    w = self.waiting[0]
                    h = w.handle
                    if (h.t_deadline is not None and svc is not None
                            and h.t_deadline - now < svc):
                        self.waiting.popleft()
                        self.cancelled += 1
                        self.deadline_misses += 1
                        doomed.append(h)
                        continue
                    break
                if not self.waiting:
                    break
                if self.slots[slot] is not None:
                    continue
                w = self.waiting[0]
                # +K speculative headroom (0 when speculation is off)
                total = (w.handle.prompt_len + w.handle.max_new_tokens
                         + self.speculate_k)
                if not self.cache.can_reserve(total):
                    break  # FIFO: do not starve the head by skipping it
                self.waiting.popleft()
                # tenant+prompt let the cache alias this prompt's cached
                # prefix pages into the slot (no-op with the cache off);
                # the AUTHORITATIVE hit lands on the ActiveSeq — the session
                # starts chunked prefill at exactly this offset
                self.cache.reserve(
                    slot, total, tenant=w.handle.tenant, prompt=w.prompt
                )
                act = ActiveSeq(w.handle, w.prompt)
                act.prefix_hit = self.cache.hit_tokens(slot)
                act.t_started = now
                act.handle.status = RequestHandle.RUNNING
                self.slots[slot] = act
                admitted.append((slot, act))
        for h in doomed:
            self._finalize(h, FinishReason.DEADLINE,
                           h.prompt_len + h.max_new_tokens, 0)
        return admitted

    def retire(self, slot: int, reason: str) -> None:
        act = self.slots[slot]
        assert act is not None
        with self.lock:
            self.slots[slot] = None
            self.cache.release(slot)
            self.completed += 1
            self._cancel_req.pop(act.handle.request_id, None)
        if self.quotas is not None:
            unused = act.handle.max_new_tokens - act.generated
            self.quotas.release(act.handle.tenant, max(0, unused))
        act.handle._complete(RequestHandle.DONE, reason)
        REQUEST_HISTOGRAM.observe(act.handle.t_done - act.handle.t_submit)
        svc = act.handle.t_done - (act.t_started or act.handle.t_submit)
        # engine steps this request actually occupied: its decode steps plus
        # the prefill chunks it ACTUALLY ran (a prefix hit skipped the cached
        # pages) — prices one chunk for the load estimate. With speculation
        # on, `generated` over-counts steps (a verify round commits several
        # tokens in ONE step), so the EWMA prices off the real step count
        # (+1 for the prefill step that emitted the first token)
        occupied = act.engine_steps + 1 if self.speculate_k else act.generated
        steps = max(1, occupied + self._chunk_steps(act.handle.prompt_len,
                                                    act.prefix_hit))
        with self.lock:
            a = self.SERVICE_EWMA_ALPHA
            self._ewma_service_s = (
                svc if self._ewma_service_s is None
                else (1 - a) * self._ewma_service_s + a * svc
            )
            per_step = svc / steps
            self._ewma_step_s = (
                per_step if self._ewma_step_s is None
                else (1 - a) * self._ewma_step_s + a * per_step
            )

    def cancel_tenant(self, tenant: str) -> int:
        """Drop a (evicted/deregistered) tenant's QUEUED requests; running
        sequences finish — their pages are already committed and retiring
        them early would waste the work. Returns how many were cancelled."""
        n = 0
        with self.lock:
            keep: Deque[_Waiting] = collections.deque()
            for w in self.waiting:
                if w.handle.tenant == tenant:
                    n += 1
                    if self.quotas is not None:
                        self.quotas.release(
                            tenant,
                            w.handle.prompt_len + w.handle.max_new_tokens,
                        )
                    w.handle._complete(
                        RequestHandle.CANCELLED, FinishReason.CANCELLED
                    )
                else:
                    keep.append(w)
            self.waiting = keep
            self.cancelled += n
        return n

    # -- engine crash recovery ----------------------------------------------
    def requeue_active(self, now: Optional[float] = None) -> Tuple[int, int]:
        """Engine recovery: push every RUNNING sequence back to the FRONT of
        the queue in original submit order with its progress reset. Decode
        is deterministic (greedy trivially; sampled requests replay through
        the same per-request seed and token indices), so the replay
        regenerates bitwise-identical tokens and the restart is
        result-transparent. Requests already past their total deadline fail
        now with the named reason. Slots are emptied but the page free list
        is NOT touched: the caller resets the whole allocator
        (cache.reset()) and re-initialises the pools. Returns
        (requeued, expired)."""
        now = time.monotonic() if now is None else now
        requeued = 0
        expired: List[Tuple[RequestHandle, str, int]] = []
        with self.lock:
            active = [(i, a) for i, a in enumerate(self.slots)
                      if a is not None]
            for i, _ in active:
                self.slots[i] = None
            # appendleft in descending id order -> queue head ends up in
            # ascending (original) order, ahead of not-yet-admitted work
            for _, act in sorted(
                active, key=lambda t: t[1].handle.request_id, reverse=True,
            ):
                h = act.handle
                reason = self._cancel_req.pop(h.request_id, None)
                if reason is None and h.t_deadline is not None \
                        and now >= h.t_deadline:
                    reason = FinishReason.DEADLINE
                if reason is not None:
                    self.cancelled += 1
                    if reason == FinishReason.DEADLINE:
                        self.deadline_misses += 1
                    expired.append(
                        (h, reason, max(0, h.max_new_tokens - act.generated))
                    )
                    continue
                h.tokens = []
                h.t_first_token = None
                h.status = RequestHandle.QUEUED
                self.waiting.appendleft(_Waiting(h, act.prompt))
                requeued += 1
        for h, reason, refund in expired:
            self._finalize(h, reason, refund, 0)
        return requeued, len(expired)

    # -- views --------------------------------------------------------------
    def active_slots(self) -> List[Tuple[int, ActiveSeq]]:
        return [(i, a) for i, a in enumerate(self.slots) if a is not None]

    def has_work(self) -> bool:
        with self.lock:
            return bool(self.waiting) or any(
                a is not None for a in self.slots
            )

    def queue_depth(self) -> int:
        with self.lock:
            return len(self.waiting)
