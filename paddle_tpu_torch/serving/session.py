"""ServingSession: a long-lived serving engine that owns device state.

The port's counterpart of `paddle_tpu/serving/session.py`. `submit` queues
requests; the engine runs on the calling thread (`step` /
`run_until_idle`) or on its own supervised thread (`serve_forever`), and
each request's handle completes with its tokens. Each engine step does what
the JAX engine's does:

  * reap expired / cancelled requests and admit waiting ones at the step
    boundary — a prompt that fits a bucket prefills whole (`prefill` at the
    bucket's padded length, then `commit_prefill` into its pages);
  * advance ONE chunked-prefill slot by one [1, prefill_chunk] chunk
    (`prefill_chunk`), round-robin across long prompts;
  * with `speculate_k > 0`, one prompt-lookup draft/verify round for every
    slot whose own tokens yield a draft (`verify_chunk`, one [1, K+1]
    chunk-shaped call each; `verify_shape_signatures()` stays 1);
  * run ONE fixed-shape [max_slots] decode step for every other fully
    prefilled slot. On the card the step's forward is a CUDA graph
    (`decode_graph.DecodeGraph`), the counterpart of the JAX engine's one
    jitted decode executable: an engine's first decode step runs eagerly as
    the capture's warm-up, the graph is captured right after it, and every
    later step replays it. On the CPU, which has no graphs, every step runs
    eagerly. Either way `decode_shape_signatures()` stays 1.

The JAX engine's donated page pools become pools the model updates in
place. The hot loop keeps the JAX engine's discipline: one device-to-host
fetch per decode step (the sampled token ids) and one wall-clock read per
engine step.

Resilience: under `serve_forever` a supervisor thread watches the engine
thread. When the engine faults (seeded sites `decode_raise` /
`page_exhaust`) or stalls between steps past `engine_stall_timeout_s`
(seeded site `engine_stall`), the supervisor supersedes it, resets the page
allocator, re-initialises the pools in place (the decode graph holds their
pointers) and replays every in-flight request from its prompt — decode is
deterministic, so the replay is result-transparent; the new engine
re-captures the decode graph. Past `engine_restart_max` restarts every
outstanding request fails `engine_error`. Push streaming: the engine bumps a
step sequence (`stream_wait`) that the server's pusher threads wait on.

Tensor parallelism (`make_demo_session(tp=N, group=...)`, or a
`ServableLM(mesh=)` split over a model axis): the session runs on the model
axis' rank 0 and leads; each device call of an engine step sends its header
first, and the other ranks repeat it (`serving/tp.py`). Over a gloo group
holding CUDA tensors the decode step runs eagerly (`stats()["decode_graph"]`)."""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core import faults as _faults
from paddle_tpu_torch.core import stats
from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.obs import metrics as obs_metrics
from paddle_tpu_torch.obs import trace
from paddle_tpu_torch.ops import paged_attention as _paged_attention
from paddle_tpu_torch.serving.decode_graph import DecodeGraph
from paddle_tpu_torch.serving.kv_cache import PagedKVCache
from paddle_tpu_torch.serving.model import LMConfig, ServableLM
from paddle_tpu_torch.serving.quota import TenantQuotas
from paddle_tpu_torch.serving.scheduler import RequestHandle, Scheduler
from paddle_tpu_torch.serving.speculation import PromptLookupDrafter, next_draft_k
from paddle_tpu_torch.serving.tp import DeviceHalf, HeaderChannel, TPWorker, decode_mode

# serving-side counters: admissions, retirements, decode steps — the
# "serving" name registers the group with the metrics exporter
SERVING_EVENTS = stats.EventCounter("serving")

TTFT_HISTOGRAM = obs_metrics.REGISTRY.histogram(
    "paddle_tpu_serving_ttft_seconds",
    "submit → first sampled token, per request",
)


def _bucket_for(buckets: Sequence[int], n: int) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt of {n} tokens exceeds largest bucket {buckets[-1]}")


class ServingSession(DeviceHalf):
    def __init__(
        self,
        model: ServableLM,
        *,
        device: DeviceLike = None,
        max_slots: int = 8,
        page_size: int = 16,
        num_pages: Optional[int] = None,
        prefill_buckets: Sequence[int] = (16, 32, 64),
        max_new_limit: int = 64,
        max_queue: int = 256,
        quotas: Optional[TenantQuotas] = None,
        default_deadline_s: Optional[float] = None,
        default_ttft_deadline_s: Optional[float] = None,
        engine_restart_max: int = 3,
        engine_stall_timeout_s: float = 10.0,
        prefill_chunk: Optional[int] = None,
        default_temperature: float = 0.0,
        default_top_k: int = 0,
        speculate_k: int = 0,
        prefix_cache: bool = False,
        prefix_cache_pages: Optional[int] = None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = model.cfg
        self.buckets = tuple(sorted(set(int(b) for b in prefill_buckets)))
        self.max_new_limit = int(max_new_limit)
        max_ctx = self.buckets[-1] + self.max_new_limit
        if max_ctx > self.cfg.max_len:
            raise ValueError(
                f"largest bucket + max_new_limit = {max_ctx} exceeds the "
                f"model's max_len {self.cfg.max_len}"
            )
        # chunked prefill lifts the bucket cap on prompt length: any prompt
        # up to max_len - 1 is admissible, so the pages cover max_len
        self.prefill_chunk = None if not prefill_chunk else int(prefill_chunk)
        if self.prefill_chunk is not None:
            max_ctx = self.cfg.max_len
        self.default_temperature = float(default_temperature)
        self.default_top_k = int(default_top_k)
        # speculative decoding: K drafted tokens verified per round through
        # ONE [1, K+1] chunk-shaped call; 0 takes the plain decode path only
        self.speculate_k = max(0, int(speculate_k))
        # shared-prefix cache: cached prompt pages alias into new slots
        # read-only and the chunked prefill starts at the first un-cached
        # token — which is why it REQUIRES chunked prefill
        self.prefix_cache = bool(prefix_cache)
        if self.prefix_cache and self.prefill_chunk is None:
            raise ValueError(
                "prefix_cache requires prefill_chunk: cache hits resume "
                "prefill mid-prompt, which only the chunked path can do"
            )
        # per-seq page budget covers the verify chunk's K-token overshoot
        pages_per_seq = -(-(max_ctx + self.speculate_k) // page_size)
        if num_pages is None:
            # worst case every slot at full context, plus the dump page
            num_pages = max_slots * pages_per_seq + 1
        self.cache = PagedKVCache(
            n_layers=self.cfg.n_layers,
            kv_dim=model.kv_dim,
            num_pages=num_pages,
            page_size=page_size,
            max_slots=max_slots,
            max_pages_per_seq=pages_per_seq,
            prefix_cache=self.prefix_cache,
            prefix_cache_pages=prefix_cache_pages,
        )
        self.scheduler = Scheduler(
            self.cache, max_queue=max_queue, quotas=quotas,
            prefill_chunk=self.prefill_chunk, largest_bucket=self.buckets[-1],
            speculate_k=self.speculate_k,
        )
        self.k_pages, self.v_pages = self.cache.make_pools(self.device)
        # what this rank holds (its shards under TP); the pools are reset in
        # place, never re-allocated, so the sizes are fixed
        self._param_bytes = stats.tensor_bytes(self.model.parameters())
        self._pool_bytes = stats.tensor_bytes([self.k_pages, self.v_pages])
        self.max_slots = self.cache.max_slots
        self.pages_per_seq = self.cache.max_pages_per_seq
        self.mesh = model.mesh
        self.tp = model.tp_size
        self.decode_mode = decode_mode(self.device, self.mesh)
        self._lead_closed = False
        if self.mesh is not None:
            if self.mesh.index("model") != 0:
                raise ValueError("a tensor-parallel session runs on the model axis' "
                                 "rank 0; the other ranks run serving.tp.TPWorker")
            self._lead = HeaderChannel(self.mesh)
            self._device_lock = threading.Lock()
            self._send("init", self.cfg.n_layers, self.cache.num_pages, page_size,
                       self.max_slots, self.pages_per_seq)
        if self.device.type == "cuda":
            # build + load the decode kernel now, so the first engine step
            # (and the load estimator's first service time) carries no nvcc
            _paged_attention.load_kernel()

        # the decode step's CUDA graph, captured after the engine's first
        # (eager) decode step on the card; None on the CPU and until then
        self._decode_graph: Optional[DecodeGraph] = None
        self.decode_graph_captures = 0
        # a capture is a one-off cost like the JAX engine's compiles: the
        # step that captured retires requests with inflated service times,
        # so the first clean step after it resets the load estimate
        self._load_est_dirty = False

        self.recompiles = stats.RecompileStats(warn_threshold=2)
        # the verify chunk's own one-signature gate ([1, K+1] fixed shape:
        # drafts, starts and sampling identity are data, never shape)
        self.verify_recompiles = stats.RecompileStats(warn_threshold=2)
        self.decode_steps = 0
        self.tokens_generated = 0
        self.prefill_chunks_committed = 0
        self._chunk_rr_slot = -1  # round-robin cursor over prefilling slots
        # speculative-decode telemetry (acceptance rate = accepted / drafted)
        self.spec_rounds = 0
        self.spec_tokens_drafted = 0
        self.spec_tokens_accepted = 0
        self.spec_pages_trimmed = 0
        # sum of the draft length actually used per round:
        # spec_effective_k = sum / rounds
        self.spec_k_eff_sum = 0
        # per-slot prompt-lookup drafters, keyed slot -> (request_id,
        # drafter, adaptive-K cell); dropped at retirement / recovery
        self._drafters: Dict[int, tuple] = {}
        # push-streaming seam: the engine bumps a sequence number once per
        # step and wakes pusher threads; ALL socket writes happen on those
        # threads (server.py), so frame emission never blocks a step
        self._stream_cv = threading.Condition()
        self._stream_seq = 0
        self.default_deadline_s = default_deadline_s
        self.default_ttft_deadline_s = default_ttft_deadline_s
        # supervisor state (server mode): restart budget, stall watchdog,
        # and the engine GENERATION — a superseded (stalled) engine thread
        # re-checks the generation when it wakes and exits without touching
        # session state, so recovery never races a zombie
        self.engine_restart_max = int(engine_restart_max)
        self.engine_stall_timeout_s = float(engine_stall_timeout_s)
        self.engine_restarts = 0
        self.engine_error: Optional[BaseException] = None
        self._engine_gen = 0
        # serializes the supersede handshake: the engine flips
        # _engine_in_step only after re-checking its generation UNDER this
        # lock, and the stall recovery bumps the generation under the same
        # lock only while the engine is BETWEEN steps
        self._gen_lock = threading.Lock()
        self._engine_fault: Optional[BaseException] = None
        self._engine_in_step = False
        # set by recovery: the next engine thread re-initialises the pools
        # in place and drops the decode graph before its first step, so
        # every CUDA call stays on the engine thread
        self._device_reset_pending = False
        self._last_progress = time.monotonic()
        self._stop = threading.Event()
        self._work = threading.Condition()
        self._thread: Optional[threading.Thread] = None

    # -- intake -------------------------------------------------------------
    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: Optional[int] = None,
        tenant: str = "default",
        deadline_s: Optional[float] = None,
        ttft_deadline_s: Optional[float] = None,
        temperature: Optional[float] = None,
        top_k: Optional[int] = None,
        seed: Optional[int] = None,
    ) -> RequestHandle:
        """Queue one generation request; raises QuotaExceeded at the front
        door when admission control says no. Deadlines resolve explicit arg
        → tenant quota default → session default; sampling knobs resolve
        explicit arg → session default (temperature 0 = greedy, top_k 0 =
        off); `seed` defaults to the request id. Thread-safe."""
        if self.engine_error is not None:
            raise RuntimeError(
                "serving engine died; no new requests accepted"
            ) from self.engine_error
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        bad = [t for t in prompt if not 0 <= t < self.cfg.vocab]
        if bad:
            # XLA would clamp an out-of-range id into the embedding table
            # silently; on the card it is a device-side assert. Reject here.
            raise ValueError(
                f"token ids must lie in [0, {self.cfg.vocab}); got {bad[:4]}"
            )
        max_new = min(
            self.max_new_limit,
            self.max_new_limit if max_new_tokens is None else int(max_new_tokens),
        )
        if max_new <= 0:
            raise ValueError("max_new_tokens must be positive")
        if len(prompt) + max_new > self.cfg.max_len:
            raise ValueError(
                f"max_len exceeded: prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new}) = {len(prompt) + max_new} tokens > the model's "
                f"max_len {self.cfg.max_len}"
            )
        if not self._chunked_prompt(prompt):
            # whole-prompt (bucketed) prefill path: prompt must fit a bucket
            _bucket_for(self.buckets, len(prompt))
        need = self.cache.pages_needed(
            len(prompt) + max_new + self.speculate_k
        )
        if need > min(self.cache.max_pages_per_seq, self.cache.num_pages - 1):
            # an undersized pool must reject at the front door, not leave the
            # queue head unadmittable forever
            raise ValueError(
                f"request needs {need} KV pages; pool allows "
                f"{min(self.cache.max_pages_per_seq, self.cache.num_pages - 1)}"
            )
        if deadline_s is None or ttft_deadline_s is None:
            qd = qtd = None
            if self.scheduler.quotas is not None:
                qd, qtd = self.scheduler.quotas.deadlines_for(tenant)
            if deadline_s is None:
                deadline_s = qd if qd is not None else self.default_deadline_s
            if ttft_deadline_s is None:
                ttft_deadline_s = (
                    qtd if qtd is not None else self.default_ttft_deadline_s
                )
        # the submitter's trace context rides in BEFORE the request becomes
        # visible, so the engine's queue-wait/prefill/ttft spans stitch under it
        handle = self.scheduler.submit(
            prompt, max_new, tenant, trace_ctx=trace.wire_context(),
            deadline_s=deadline_s, ttft_deadline_s=ttft_deadline_s,
            seed=seed,
            temperature=(
                self.default_temperature if temperature is None
                else float(temperature)
            ),
            top_k=self.default_top_k if top_k is None else int(top_k),
        )
        # the full prompt rides the handle: a router's takeover sweep reads
        # it back (the `outstanding` RPC), so a request whose replica also
        # dies can be re-submitted to a survivor token-identically
        handle.prompt_tokens = prompt
        SERVING_EVENTS.incr("serving_submitted")
        with self._work:
            self._work.notify()
        return handle

    # -- engine steps -------------------------------------------------------
    def _chunked_prompt(self, prompt) -> bool:
        """True when this prompt prefills chunk by chunk: longer than the
        per-step chunk budget, OR longer than every bucket."""
        return self.prefill_chunk is not None and (
            len(prompt) > self.prefill_chunk or len(prompt) > self.buckets[-1]
        )

    def _sampling_row(self, h) -> tuple:
        """(seeds, temps, top_ks) [1]-shaped host data for one request's
        prefill — its first token is draw 0 of its seed."""
        return (
            np.array([h.seed], np.uint32),
            np.array([h.temperature], np.float32),
            np.array([h.top_k], np.int32),
        )

    def _observe_ttft(self, h, ctx) -> None:
        """Time-to-first-token bookkeeping, shared by the whole-prompt and
        chunked prefill paths; latched once per request."""
        if not h.ttft_observed:
            h.ttft_observed = True
            ttft_s = (h.t_first_token or h.t_submit) - h.t_submit
            TTFT_HISTOGRAM.observe(ttft_s)
            if (h.t_ttft_deadline is not None
                    and h.t_first_token is not None
                    and h.t_first_token > h.t_ttft_deadline):
                # counted (the client-hedging signal), not fatal
                obs_metrics.observe_deadline_miss("ttft")
                SERVING_EVENTS.incr("serving_ttft_deadline_missed")
        trace.span_from_monotonic(
            "serving.ttft", h.t_submit,
            trace_id=ctx and ctx.get("t"), parent_id=ctx and ctx.get("s"),
            attrs={"request_id": h.request_id},
        )

    def _admit(self, now: Optional[float] = None) -> None:
        """Run prefill for every request joining at this step boundary.
        Chunked prompts (and prefix-cache hits) only MARK the slot as
        prefilling here; `_prefill_chunks` commits them a chunk per step."""
        if _faults.get().active and self.scheduler.queue_depth():
            # chaos site: the page pool fails at admission
            _faults.get().maybe_raise("page_exhaust")
        for slot, act in self.scheduler.pop_admissions(now):
            h = act.handle
            ctx = h.trace_ctx
            trace.span_from_monotonic(
                "serving.queue_wait", h.t_submit,
                trace_id=ctx and ctx.get("t"), parent_id=ctx and ctx.get("s"),
                attrs={"request_id": h.request_id},
            )
            if act.prefix_hit or self._chunked_prompt(act.prompt):
                # resume at the first un-cached token (0 without a hit)
                act.prefill_pos = act.prefix_hit
                continue
            bucket = _bucket_for(self.buckets, len(act.prompt))
            seeds, temps, top_ks = self._sampling_row(h)
            with trace.activate(ctx):
                with trace.span(
                    "serving.prefill", request_id=h.request_id, bucket=bucket
                ):
                    toks = np.zeros((1, bucket), np.int32)
                    toks[0, : len(act.prompt)] = act.prompt
                    first_tok = self._dev_prefill(
                        toks, np.array([len(act.prompt)], np.int32),
                        self.cache.slot_row(slot), seeds, temps, top_ks,
                    )
                    # one tiny host fetch per ADMISSION: the first token
                    act.append(int(first_tok[0]))
            # register the committed prompt pages (no-op with the cache off)
            self.cache.commit_prefix(slot, h.tenant, act.prompt,
                                     len(act.prompt))
            self._observe_ttft(h, ctx)
            SERVING_EVENTS.incr("serving_prefills")
            reason = act.finished(self.cfg.eos_id)
            if reason is not None:
                self.scheduler.retire(slot, reason)

    def _prefill_chunks(self) -> None:
        """Advance ONE prefilling slot by exactly one [1, C] chunk. The chunk
        size is the per-step prefill budget; decode still runs for every
        fully prefilled slot in the same engine step, so a long prompt never
        stalls the running streams. The final chunk emits the request's
        first token (one host fetch per request, there)."""
        prefilling = [
            (slot, act) for slot, act in self.scheduler.active_slots()
            if act.prefilling
        ]
        if not prefilling:
            return
        # round-robin: resume after the last slot serviced
        prefilling.sort(
            key=lambda sa: (sa[0] <= self._chunk_rr_slot, sa[0])
        )
        slot, act = prefilling[0]
        self._chunk_rr_slot = slot
        h = act.handle
        c = self.prefill_chunk
        start = act.prefill_pos
        piece = act.prompt[start : start + c]
        toks = np.zeros((1, c), np.int32)
        toks[0, : len(piece)] = piece
        seeds, temps, top_ks = self._sampling_row(h)
        # span-ok: ring-buffer write only, constant name, int attrs
        with trace.activate(h.trace_ctx):
            with trace.span(
                "serving.prefill_chunk", request_id=h.request_id, start=start,
            ):
                tok = self._dev_prefill_chunk(
                    toks, np.array([start], np.int32),
                    np.array([len(act.prompt)], np.int32),
                    self.cache.slot_row(slot), seeds, temps, top_ks,
                )
        act.prefill_pos = min(start + c, len(act.prompt))
        # incremental registration of the pages this chunk completed
        self.cache.commit_prefix(slot, h.tenant, act.prompt, act.prefill_pos)
        self.prefill_chunks_committed += 1
        SERVING_EVENTS.incr("serving_prefill_chunks")
        if not act.prefilling:
            # sync-ok: one host fetch per REQUEST — the final chunk's token
            act.append(int(tok[0]))
            self._observe_ttft(h, h.trace_ctx)
            SERVING_EVENTS.incr("serving_prefills")
            reason = act.finished(self.cfg.eos_id)
            if reason is not None:
                self.scheduler.retire(slot, reason)

    def _drafter_for(self, slot: int, act):
        """This slot's (drafter, adaptive-K cell), rebuilt when the slot was
        recycled to a different request. The K cell is derived state like
        the drafter: a replay regrows the same acceptance history, hence the
        same K at every round — which keeps crash recovery bitwise."""
        rid = act.handle.request_id
        ent = self._drafters.get(slot)
        if ent is None or ent[0] != rid:
            ent = (rid, PromptLookupDrafter(), [self.speculate_k])
            self._drafters[slot] = ent
        return ent[1], ent[2]

    def _speculate(self) -> set:
        """One prompt-lookup draft/verify round for EVERY eligible slot: the
        slot's drafter proposes up to K continuation tokens from the
        request's own committed n-grams, one [1, K+1] `verify_chunk` call
        scores them all against the paged cache, and the matched prefix
        commits — the first divergent token comes free from the verify
        logits, so a round always advances the slot by >= 1 token. Slots
        with no draft fall through to `_decode_once`.

        Eligibility is a pure function of the REQUEST's own state (its
        committed tokens decide whether a draft exists), never of batch
        composition or engine scheduling — that is what keeps crash replay
        bitwise at temperature > 0. Returns the slots advanced this round
        (skipped by `_decode_once`)."""
        advanced: set = set()
        if not self.speculate_k:
            return advanced
        candidates = [
            (slot, act) for slot, act in self.scheduler.active_slots()
            if not act.prefilling
        ]
        if candidates and _faults.get().active:
            # chaos site: the engine faults mid-speculation — recovery must
            # replay the in-flight drafts bitwise
            _faults.get().maybe_raise("decode_raise")
        k = self.speculate_k
        for slot, act in candidates:
            h = act.handle
            remaining = h.max_new_tokens - act.generated
            if remaining <= 1:
                # the +K page headroom is no longer reachable (every future
                # write lands inside the base reservation): recycle it now
                self.spec_pages_trimmed += self.cache.trim(
                    slot, h.prompt_len + h.max_new_tokens
                )
                continue
            drafter, kcell = self._drafter_for(slot, act)
            drafter.sync(act.prompt, h.tokens)
            # adaptive K: draft up to this request's CURRENT effective K while
            # the verify call stays [1, K_max+1] (short drafts zero-pad)
            draft = drafter.draft(min(k, kcell[0]))
            if not draft:
                continue
            toks = np.zeros((1, k + 1), np.int32)
            toks[0, 0] = act.last_token
            toks[0, 1:1 + len(draft)] = draft
            starts = np.array([act.next_pos], np.int32)
            steps0 = np.array([act.generated], np.int32)
            seeds, temps, top_ks = self._sampling_row(h)
            rows = self.cache.slot_row(slot)
            self.verify_recompiles.record(
                stats.batch_signature(
                    {"tokens": toks, "starts": starts, "block_rows": rows,
                     "seeds": seeds, "steps0": steps0, "temps": temps,
                     "top_ks": top_ks}
                )
            )
            # span-ok: ring-buffer write only, constant name, int attrs
            with trace.span(
                "serving.verify_chunk", request_id=h.request_id,
                drafted=len(draft),
            ):
                sampled = self._dev_verify(
                    toks, starts, rows, seeds, steps0, temps, top_ks,
                )
                # sync-ok: ONE fetch per verify round — the K+1 sampled
                # tokens the host needs to run acceptance
                out = sampled.cpu().numpy()
            act.engine_steps += 1
            limit = min(len(draft), remaining - 1)
            n_match = 0
            while n_match < limit and int(out[n_match]) == draft[n_match]:
                n_match += 1
            emit = [int(out[i]) for i in range(n_match + 1)]
            # never commit past EOS: a drafted continuation that crosses the
            # stop token truncates there
            for j, t in enumerate(emit):
                if t == self.cfg.eos_id:
                    emit = emit[: j + 1]
                    break
            for t in emit:
                act.append(t)
            accepted = max(0, len(emit) - 1)
            self.tokens_generated += len(emit)
            self.spec_rounds += 1
            self.spec_tokens_drafted += len(draft)
            self.spec_tokens_accepted += accepted
            self.spec_k_eff_sum += len(draft)
            kcell[0] = next_draft_k(kcell[0], k, len(draft), accepted)
            SERVING_EVENTS.incr("serving_spec_rounds")
            SERVING_EVENTS.incr("serving_spec_accepted", accepted)
            advanced.add(slot)
            reason = act.finished(self.cfg.eos_id)
            if reason is not None:
                self._drafters.pop(slot, None)
                self.scheduler.retire(slot, reason)
        return advanced

    def _decode_once(self, skip: frozenset = frozenset()) -> None:
        """One continuous-batching decode step: every active, fully
        prefilled slot advances by one token in the fixed-shape step (slots
        mid-chunked-prefill ride along as inactive lanes; slots in `skip`
        already advanced through a speculative verify round this step)."""
        active = [
            (slot, act) for slot, act in self.scheduler.active_slots()
            if not act.prefilling and slot not in skip
        ]
        if not active:
            return
        if _faults.get().active:
            # chaos site: the engine faults mid-decode
            _faults.get().maybe_raise("decode_raise")
        s = self.cache.max_slots
        tokens = np.zeros(s, np.int32)
        positions = np.zeros(s, np.int32)
        act_mask = np.zeros(s, bool)
        seeds = np.zeros(s, np.uint32)
        steps = np.zeros(s, np.int32)
        temps = np.zeros(s, np.float32)
        top_ks = np.zeros(s, np.int32)
        for slot, act in active:
            tokens[slot] = act.last_token
            positions[slot] = act.next_pos
            act_mask[slot] = True
            # sampling identity rides as data: this step's token for the
            # slot is draw `generated` of request `seed`
            seeds[slot] = act.handle.seed
            steps[slot] = act.generated
            temps[slot] = act.handle.temperature
            top_ks[slot] = act.handle.top_k
        bt = self.cache.block_table()
        # fixed-shape assertion data: one decode signature for any mix
        self.recompiles.record(
            stats.batch_signature(
                {"tokens": tokens, "positions": positions, "active": act_mask,
                 "block_table": bt, "seeds": seeds, "steps": steps,
                 "temps": temps, "top_ks": top_ks}
            )
        )
        # span-ok: ring-buffer write only, constant name, int attr
        with trace.span("serving.decode_step", active=len(active)):
            next_tok = self._decode_forward(
                tokens, positions, act_mask, bt, seeds, steps, temps, top_ks,
            )
            # sync-ok: the ONE fetch in the decode hot loop — the sampled
            # token ids the host needs for EOS/budget checks
            toks = next_tok.cpu().numpy()
        self.decode_steps += 1
        SERVING_EVENTS.incr("serving_decode_steps")
        for slot, act in active:
            act.append(toks[slot])
            act.engine_steps += 1
            self.tokens_generated += 1
            reason = act.finished(self.cfg.eos_id)
            if reason is not None:
                self._drafters.pop(slot, None)
                self.scheduler.retire(slot, reason)

    def step(self, now: Optional[float] = None) -> bool:
        """One engine iteration: reap expired/cancelled requests, retire and
        admit at the boundary, one prefill chunk, one speculation round,
        then one decode step for the slots it did not advance. Returns True
        when any work was done."""
        if self._device_lock is None:
            return self._step(now)
        with self._device_lock:
            if self._lead_closed:
                raise RuntimeError("this tensor-parallel session was stopped")
            return self._step(now)

    def _step(self, now: Optional[float]) -> bool:
        if now is None:
            # clock-ok: the ONE wall-clock read per engine step
            now = time.monotonic()
        self._last_progress = now  # supervisor stall-watchdog heartbeat
        captures_before = self.decode_graph_captures
        self.scheduler.reap(now)
        self._admit(now)
        self._prefill_chunks()
        before = self.decode_steps
        spec_before = self.spec_rounds
        advanced = self._speculate()
        self._decode_once(advanced)
        self._notify_streams()
        # the first clean step after a capture forgets the load estimate the
        # capturing step inflated; steady-state retirements re-seed it
        if self.decode_graph_captures != captures_before:
            self._load_est_dirty = True
        elif self._load_est_dirty:
            self._load_est_dirty = False
            self.scheduler.reset_load_estimate()
        return (
            self.decode_steps != before
            or self.spec_rounds != spec_before
            or bool(self.scheduler.active_slots())
        )

    # -- push-streaming seam --------------------------------------------------
    def _notify_streams(self) -> None:
        """Wake frame pushers at this step boundary: a sequence-number bump
        and nothing else — pusher threads (server.py) diff token lists and
        write frames on their own time, so a slow or dead client can never
        block an engine step."""
        with self._stream_cv:
            self._stream_seq += 1
            self._stream_cv.notify_all()

    def stream_wait(self, seq: int, timeout: float = 0.1) -> int:
        """Block (pusher-thread side) until the engine advances past step
        sequence `seq` or `timeout` elapses; returns the current sequence.
        The timeout doubles as the liveness tick (cancellations complete
        without a step)."""
        with self._stream_cv:
            if self._stream_seq == seq:
                self._stream_cv.wait(timeout)
            return self._stream_seq

    def run_until_idle(self) -> None:
        """Drive the engine on the calling thread until queue + slots drain."""
        while self.scheduler.has_work():
            self.step()

    # -- supervised engine thread (server mode) -------------------------------
    def serve_forever(self) -> "ServingSession":
        """Start the SUPERVISED engine: a supervisor thread spawns the engine
        thread and watches it — a fault or stall triggers recovery (pool
        re-init + in-flight replay) up to `engine_restart_max` times, after
        which every outstanding request fails `engine_error`. Only the
        engine thread touches the device. Idempotent."""
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._supervise, name="serving-supervisor", daemon=True
        )
        self._thread.start()
        return self

    def _reset_device_state(self) -> None:
        """Recovery's device half, on the new engine thread: the pools are
        zeroed in place — the decode graph holds their pointers, and the
        allocator behind them was reset — and the graph is dropped, so this
        engine's first decode step warms up and re-captures it."""
        self._device_reset_pending = False
        self._dev_reset()

    def _engine_loop(self, gen: int) -> None:
        """The engine proper, pinned to generation `gen`: superseded threads
        notice at the loop guard and exit WITHOUT touching session state."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._stop.is_set() and self._engine_gen == gen:
            if not self.scheduler.has_work():
                with self._work:
                    self._work.wait(timeout=0.05)
                continue
            if _faults.maybe_stall("engine_stall"):
                continue  # woke superseded: the loop guard re-checks gen
            # _engine_in_step gates the stall watchdog: a slow step (the
            # first one builds and captures) never reads as a stall; the gen
            # re-check and the flag flip are atomic under _gen_lock
            with self._gen_lock:
                if self._stop.is_set() or self._engine_gen != gen:
                    return
                self._engine_in_step = True
            try:
                if self._device_reset_pending:
                    self._reset_device_state()
                self.step()
            except Exception as e:  # noqa: BLE001 — hand the fault to the
                # supervisor (recovery or give-up happens there)
                self._engine_fault = e
                return
            finally:
                self._engine_in_step = False

    def _supervise(self) -> None:
        log = logging.getLogger("paddle_tpu_torch.serving")
        poll_s = max(0.02, min(0.25, self.engine_stall_timeout_s / 4.0))
        while not self._stop.is_set():
            gen = self._engine_gen
            self._engine_fault = None
            # clock-ok: once per engine (re)start — the watchdog anchor
            self._last_progress = time.monotonic()
            eng = threading.Thread(
                target=self._engine_loop, args=(gen,),
                name="serving-engine", daemon=True,
            )
            eng.start()
            cause: Optional[str] = None
            busy_since: Optional[float] = None
            stale_polls = 0
            while not self._stop.is_set():
                eng.join(timeout=poll_s)
                if not eng.is_alive():
                    if self._engine_fault is None:
                        return  # clean stop
                    cause = "fault"
                    break
                # stall watchdog: only while work is pending AND the engine
                # sits between steps; anchored at the LATER of last step
                # start / when the queue last became non-empty; two
                # consecutive stale samples required
                now = time.monotonic()  # clock-ok: watchdog poll (4-16 Hz)
                if not self.scheduler.has_work():
                    busy_since = None
                    stale_polls = 0
                    continue
                if busy_since is None:
                    busy_since = now
                if (not self._engine_in_step
                        and now - max(self._last_progress, busy_since)
                        > self.engine_stall_timeout_s):
                    stale_polls += 1
                    if stale_polls >= 2:
                        # atomic supersede: bump the generation under the
                        # lock the engine takes to enter a step, only while
                        # it is still BETWEEN steps
                        with self._gen_lock:
                            if not self._engine_in_step:
                                self._engine_gen += 1
                                cause = "stall"
                        if cause is not None:
                            break
                        stale_polls = 0
                else:
                    stale_polls = 0
            if self._stop.is_set():
                return
            if cause == "fault":
                with self._gen_lock:
                    self._engine_gen += 1
            err = self._engine_fault
            if self.engine_restarts >= self.engine_restart_max:
                self.engine_error = err or RuntimeError(
                    f"serving engine stalled >"
                    f"{self.engine_stall_timeout_s}s and the restart budget "
                    f"({self.engine_restart_max}) is exhausted"
                )
                log.error(
                    "serving engine %s and restart budget (%d) exhausted; "
                    "failing %d outstanding request(s) and stopping",
                    cause, self.engine_restart_max,
                    len(self.scheduler.active_slots())
                    + self.scheduler.queue_depth(),
                )
                self._fail_outstanding()
                self._stop.set()
                return
            self._recover(cause, err, log)

    def _recover(self, cause: str, err: Optional[BaseException],
                 log: logging.Logger) -> None:
        """Engine restart: in-flight requests go back to the queue head to
        replay from their prompts (result-transparent), past-deadline ones
        fail with the named reason, the allocator is reset, and the next
        engine thread re-initialises the pools in place and re-captures the
        decode graph (`_reset_device_state`)."""
        t0 = time.monotonic()  # clock-ok: once per engine restart
        self.engine_restarts += 1
        SERVING_EVENTS.incr("serving_engine_restarts")
        obs_metrics.observe_engine_restart(cause)
        requeued, expired = self.scheduler.requeue_active(t0)
        self.cache.reset()
        self._device_reset_pending = True
        # drafters are derived state: replayed requests regrow them
        self._drafters.clear()
        SERVING_EVENTS.incr("serving_requests_replayed", requeued)
        trace.span_from_monotonic(
            "serving.engine_restart", t0,
            attrs={"cause": cause, "requeued": requeued, "expired": expired},
        )
        log.warning(
            "serving engine %s (%r); restart %d/%d: page pools re-initialised, "
            "%d in-flight request(s) replayed, %d failed past-deadline",
            cause, err, self.engine_restarts, self.engine_restart_max,
            requeued, expired,
        )

    def _fail_outstanding(self) -> None:
        """Complete every waiting + running handle as
        CANCELLED('engine_error') so result() raises instead of timing out;
        pages are released for accounting hygiene."""
        sch = self.scheduler
        with sch.lock:
            waiting = list(sch.waiting)
            sch.waiting.clear()
            running = [(i, a) for i, a in enumerate(sch.slots) if a is not None]
            for slot, _ in running:
                sch.slots[slot] = None
                self.cache.release(slot)
        for w in waiting:
            if sch.quotas is not None:
                sch.quotas.release(w.handle.tenant)
            w.handle._complete(RequestHandle.CANCELLED, "engine_error")
        for _, act in running:
            if sch.quotas is not None:
                sch.quotas.release(act.handle.tenant)
            act.handle._complete(RequestHandle.CANCELLED, "engine_error")

    def stop(self) -> None:
        self._stop.set()
        with self._gen_lock:
            self._engine_gen += 1  # supersede any wedged engine thread
        with self._work:
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        if self._device_lock is not None:
            # the workers leave their loops once no step is in flight
            with self._device_lock:
                if not self._lead_closed:
                    self._lead_closed = True
                    self._send("stop")

    def cancel_tenant(self, tenant: str) -> int:
        return self.scheduler.cancel_tenant(tenant)

    # -- telemetry ----------------------------------------------------------
    def progress_marker(self) -> tuple:
        """A tuple that changes whenever the engine makes ANY observable
        progress (decode steps, prefill chunks, retirements, cancellations,
        restarts, verify rounds)."""
        sch = self.scheduler
        return (
            self.decode_steps,
            self.prefill_chunks_committed,
            sch.completed,
            sch.cancelled,
            self.engine_restarts,
            self.spec_rounds,
        )

    def decode_shape_signatures(self) -> int:
        """Distinct decode-step input signatures seen — 1 means the whole
        serving lifetime ran one fixed-shape decode step."""
        return self.recompiles.total_signatures()

    def verify_shape_signatures(self) -> int:
        """Distinct verify_chunk input signatures seen — 1 means every
        speculative round ran one [1, K+1] shape (0 when speculation never
        ran)."""
        return self.verify_recompiles.total_signatures()

    def stats(self) -> Dict:
        sch = self.scheduler
        return {
            "device": str(self.device),
            "decode_steps": self.decode_steps,
            "decode_graph_captures": self.decode_graph_captures,
            "decode_graph": self.decode_mode,
            "param_bytes": self._param_bytes,
            "pool_bytes": self._pool_bytes,
            "tp": self.tp,
            "param_bytes_per_chip": self._param_bytes,
            "pool_bytes_per_chip": self._pool_bytes,
            "tokens_generated": self.tokens_generated,
            "decode_shape_signatures": self.decode_shape_signatures(),
            "queue_depth": sch.queue_depth(),
            "active_slots": len(sch.active_slots()),
            "max_slots": self.cache.max_slots,
            "free_pages": self.cache.free_pages,
            "pages_in_use": self.cache.pages_in_use,
            "completed": sch.completed,
            "rejected": sch.rejected,
            "cancelled": sch.cancelled,
            "shed": sch.shed,
            "deadline_misses": sch.deadline_misses,
            "pages_recycled_on_cancel": sch.pages_recycled_on_cancel,
            "engine_restarts": self.engine_restarts,
            "estimated_queue_wait_s": round(sch.estimate_wait_s(), 4),
            "prefill_buckets": list(self.buckets),
            "prefill_chunk": self.prefill_chunk,
            "prefill_chunks_committed": self.prefill_chunks_committed,
            "default_temperature": self.default_temperature,
            "default_top_k": self.default_top_k,
            "speculate_k": self.speculate_k,
            "spec_rounds": self.spec_rounds,
            "spec_tokens_drafted": self.spec_tokens_drafted,
            "spec_tokens_accepted": self.spec_tokens_accepted,
            "spec_acceptance_rate": round(
                self.spec_tokens_accepted / self.spec_tokens_drafted, 4
            ) if self.spec_tokens_drafted else 0.0,
            "spec_pages_trimmed": self.spec_pages_trimmed,
            "spec_effective_k": round(
                self.spec_k_eff_sum / self.spec_rounds, 4
            ) if self.spec_rounds else 0.0,
            "verify_shape_signatures": self.verify_shape_signatures(),
            **self.cache.prefix_stats(),
        }


def tp_mesh(tp: int, group=None, device: DeviceLike = None):
    """The {"data": 1, "model": tp} mesh of a tensor-parallel serving
    engine over `group` (tp ranks), or over the initialized default group.
    Without either it raises, saying how to launch the ranks."""
    import torch.distributed as dist

    from paddle_tpu_torch.parallel.rules import make_tp_mesh

    if group is None and not (dist.is_initialized() and dist.get_world_size() == tp):
        raise RuntimeError(
            f"tensor-parallel serving over {tp} ranks runs one process (or thread) per "
            "rank, each holding its shards: call make_demo_session(tp=N, group=...) in "
            f"every rank of a {tp}-rank process group (parallel.mesh.new_gloo_group "
            "over one store, or parallel.distributed.initialize(coordinator_address, "
            f"{tp}, rank) first), or start `python -m paddle_tpu_torch serve --tp {tp}`, "
            "which launches the ranks itself")
    return make_tp_mesh(tp, group=group, device=device)


def make_demo_session(
    vocab: int = 128,
    n_layers: int = 2,
    d_model: int = 32,
    n_heads: int = 2,
    seed: int = 0,
    tp: int = 0,
    device: DeviceLike = None,
    group=None,
    **session_kw,
):
    """A seeded random model + session (chip_smoke.py, tests). The weights
    come from a CPU generator seeded `seed`, so they are the same on every
    device and layout (and differ from the JAX package's for the same
    seed). `device` None means CUDA and raises without it.

    tp > 1 serves tensor-parallel over a {"data": 1, "model": tp} mesh of
    `group`'s tp ranks (or the initialized default group): call it on every
    rank. Rank 0 gets the ServingSession; every other rank gets a
    `serving.tp.TPWorker`, whose `run()` serves until the session stops."""
    dev = resolve_device(device)
    mesh = None
    if tp and int(tp) > 1:
        mesh = tp_mesh(int(tp), group, dev)
    buckets = session_kw.pop("prefill_buckets", (16, 32, 64))
    max_new = session_kw.pop("max_new_limit", 64)
    # chunked prefill serves prompts beyond the largest bucket, so callers
    # exercising it can ask for more position room than the bucket default
    max_len = session_kw.pop("max_len", None) or max(buckets) + max_new
    model = ServableLM(LMConfig(
        vocab=vocab, n_layers=n_layers, d_model=d_model, n_heads=n_heads,
        max_len=max_len,
    ), device=dev, mesh=mesh).init_params(torch.Generator().manual_seed(seed))
    if mesh is not None and mesh.index("model") != 0:
        return TPWorker(model)
    return ServingSession(
        model, device=dev, prefill_buckets=buckets, max_new_limit=max_new,
        **session_kw,
    )
