"""ServingSession: a long-lived serving engine that owns device state.

The port's counterpart of `paddle_tpu/serving/session.py`, driven in
process: `submit` queues requests, `step` / `run_until_idle` run the engine
on the calling thread, and each request's handle completes with its tokens.
Each engine step does what the JAX engine's does:

  * reap expired / cancelled requests and admit waiting ones at the step
    boundary — a prompt that fits a bucket prefills whole (`prefill` at the
    bucket's padded length, then `commit_prefill` into its pages);
  * advance ONE chunked-prefill slot by one [1, prefill_chunk] chunk
    (`prefill_chunk`), round-robin across long prompts;
  * run ONE fixed-shape [max_slots] decode step for every fully prefilled
    slot (`decode_step`, whose attention is the CUDA ragged paged-attention
    kernel on the card).

The JAX engine's `jax.jit` executables become plain method calls and its
donated page pools become pools the model updates in place. The decode
step's input signature is still recorded (`decode_shape_signatures()` must
stay 1): the fixed shape is what lets a later slice capture the step as one
CUDA graph. The hot loop keeps the JAX engine's discipline: one
device-to-host fetch per decode step (the sampled token ids) and one
wall-clock read per engine step.

Not ported yet (ROADMAP.md): speculative decoding (`speculate_k > 0`), the
supervised engine thread (`serve_forever`, crash replay, stall watchdog),
push streaming, tensor parallelism."""

from __future__ import annotations

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
from paddle_tpu_torch.serving.kv_cache import PagedKVCache
from paddle_tpu_torch.serving.model import LMConfig, ServableLM
from paddle_tpu_torch.serving.quota import TenantQuotas
from paddle_tpu_torch.serving.scheduler import RequestHandle, Scheduler

# serving-side counters: admissions, retirements, decode steps — the
# "serving" name registers the group with the metrics exporter
SERVING_EVENTS = stats.EventCounter("serving")

TTFT_HISTOGRAM = obs_metrics.REGISTRY.histogram(
    "paddle_tpu_serving_ttft_seconds",
    "submit → first sampled token, per request",
)

_NOT_PORTED = (
    "{what} is not ported to paddle_tpu_torch yet (ROADMAP.md, queue 1: "
    "{item})"
)


def _bucket_for(buckets: Sequence[int], n: int) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt of {n} tokens exceeds largest bucket {buckets[-1]}")


class ServingSession:
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
        prefill_chunk: Optional[int] = None,
        default_temperature: float = 0.0,
        default_top_k: int = 0,
        speculate_k: int = 0,
        prefix_cache: bool = False,
        prefix_cache_pages: Optional[int] = None,
    ):
        if speculate_k:
            raise NotImplementedError(_NOT_PORTED.format(
                what="speculative decoding (speculate_k > 0)",
                item="the RPC server, CLI serve, supervisor and speculation",
            ))
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
        # shared-prefix cache: cached prompt pages alias into new slots
        # read-only and the chunked prefill starts at the first un-cached
        # token — which is why it REQUIRES chunked prefill
        self.prefix_cache = bool(prefix_cache)
        if self.prefix_cache and self.prefill_chunk is None:
            raise ValueError(
                "prefix_cache requires prefill_chunk: cache hits resume "
                "prefill mid-prompt, which only the chunked path can do"
            )
        pages_per_seq = -(-max_ctx // page_size)
        if num_pages is None:
            # worst case every slot at full context, plus the dump page
            num_pages = max_slots * pages_per_seq + 1
        self.cache = PagedKVCache(
            n_layers=self.cfg.n_layers,
            kv_dim=self.cfg.d_model,
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
        )
        self.k_pages, self.v_pages = self.cache.make_pools(self.device)
        if self.device.type == "cuda":
            # build + load the decode kernel now, so the first engine step
            # (and the load estimator's first service time) carries no nvcc
            _paged_attention.load_kernel()

        self.recompiles = stats.RecompileStats(warn_threshold=2)
        self.decode_steps = 0
        self.tokens_generated = 0
        self.prefill_chunks_committed = 0
        self._chunk_rr_slot = -1  # round-robin cursor over prefilling slots
        self.default_deadline_s = default_deadline_s
        self.default_ttft_deadline_s = default_ttft_deadline_s

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        # a copy: block-table rows are live host views the engine mutates
        return torch.tensor(a, device=self.device)

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
        need = self.cache.pages_needed(len(prompt) + max_new)
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
        SERVING_EVENTS.incr("serving_submitted")
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
                    lengths = self._to_device(
                        np.array([len(act.prompt)], np.int32)
                    )
                    first_tok, kc, vc = self.model.prefill(
                        self._to_device(toks), lengths, seeds, temps, top_ks
                    )
                    self.model.commit_prefill(
                        self.k_pages, self.v_pages, kc, vc, lengths,
                        self._to_device(self.cache.slot_row(slot)),
                        self._to_device(np.zeros(1, np.int32)),
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
                tok = self.model.prefill_chunk(
                    self.k_pages, self.v_pages, self._to_device(toks),
                    self._to_device(np.array([start], np.int32)),
                    self._to_device(np.array([len(act.prompt)], np.int32)),
                    self._to_device(self.cache.slot_row(slot)),
                    seeds, temps, top_ks,
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

    def _decode_once(self) -> None:
        """One continuous-batching decode step: every active, fully
        prefilled slot advances by one token in the fixed-shape step (slots
        mid-chunked-prefill ride along as inactive lanes)."""
        active = [
            (slot, act) for slot, act in self.scheduler.active_slots()
            if not act.prefilling
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
            next_tok = self.model.decode_step(
                self.k_pages, self.v_pages, self._to_device(tokens),
                self._to_device(positions), self._to_device(act_mask),
                self._to_device(bt), seeds, steps, temps, top_ks,
            )
            # sync-ok: the ONE fetch in the decode hot loop — the sampled
            # token ids the host needs for EOS/budget checks
            toks = next_tok.cpu().numpy()
        self.decode_steps += 1
        SERVING_EVENTS.incr("serving_decode_steps")
        for slot, act in active:
            act.append(toks[slot])
            self.tokens_generated += 1
            reason = act.finished(self.cfg.eos_id)
            if reason is not None:
                self.scheduler.retire(slot, reason)

    def step(self, now: Optional[float] = None) -> bool:
        """One engine iteration: reap expired/cancelled requests, retire and
        admit at the boundary, one prefill chunk, then one decode step.
        Returns True when any work was done."""
        if now is None:
            # clock-ok: the ONE wall-clock read per engine step
            now = time.monotonic()
        self.scheduler.reap(now)
        self._admit(now)
        self._prefill_chunks()
        before = self.decode_steps
        self._decode_once()
        return (
            self.decode_steps != before
            or bool(self.scheduler.active_slots())
        )

    def run_until_idle(self) -> None:
        """Drive the engine on the calling thread until queue + slots drain."""
        while self.scheduler.has_work():
            self.step()

    def serve_forever(self) -> "ServingSession":
        raise NotImplementedError(_NOT_PORTED.format(
            what="the supervised engine thread (serve_forever)",
            item="the RPC server, CLI serve, supervisor and speculation",
        ))

    def cancel_tenant(self, tenant: str) -> int:
        return self.scheduler.cancel_tenant(tenant)

    # -- telemetry ----------------------------------------------------------
    def decode_shape_signatures(self) -> int:
        """Distinct decode-step input signatures seen — 1 means the whole
        serving lifetime ran one fixed-shape decode step."""
        return self.recompiles.total_signatures()

    def stats(self) -> Dict:
        sch = self.scheduler
        return {
            "device": str(self.device),
            "decode_steps": self.decode_steps,
            "param_bytes": stats.tensor_bytes(self.model.parameters()),
            "pool_bytes": stats.tensor_bytes([self.k_pages, self.v_pages]),
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
            "estimated_queue_wait_s": round(sch.estimate_wait_s(), 4),
            "prefill_buckets": list(self.buckets),
            "prefill_chunk": self.prefill_chunk,
            "prefill_chunks_committed": self.prefill_chunks_committed,
            "default_temperature": self.default_temperature,
            "default_top_k": self.default_top_k,
            **self.cache.prefix_stats(),
        }


def make_demo_session(
    vocab: int = 128,
    n_layers: int = 2,
    d_model: int = 32,
    n_heads: int = 2,
    seed: int = 0,
    tp: int = 0,
    device: DeviceLike = None,
    **session_kw,
) -> ServingSession:
    """A seeded random model + session (chip_smoke.py, tests). The weights
    come from a CPU generator seeded `seed`, so they are the same on every
    device (and differ from the JAX package's for the same seed). `device`
    None means CUDA and raises without it."""
    if tp and int(tp) > 1:
        raise NotImplementedError(_NOT_PORTED.format(
            what="tensor-parallel serving (tp > 1)", item="TP serving",
        ))
    dev = resolve_device(device)
    buckets = session_kw.pop("prefill_buckets", (16, 32, 64))
    max_new = session_kw.pop("max_new_limit", 64)
    # chunked prefill serves prompts beyond the largest bucket, so callers
    # exercising it can ask for more position room than the bucket default
    max_len = session_kw.pop("max_len", None) or max(buckets) + max_new
    model = ServableLM(LMConfig(
        vocab=vocab, n_layers=n_layers, d_model=d_model, n_heads=n_heads,
        max_len=max_len,
    ), device=dev).init_params(torch.Generator().manual_seed(seed))
    return ServingSession(
        model, device=dev, prefill_buckets=buckets, max_new_limit=max_new,
        **session_kw,
    )
