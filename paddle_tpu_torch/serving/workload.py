"""Serving workloads: closed-loop streams, the open loop, prompt sets.

The port's copy of `paddle_tpu/serving/workload.py` (numpy only): the
mixed-length, repetitive, shared-prefix and chunked-prefill (mixed) prompt
generators, the in-process closed loop, `run_closed_loop_rpc` (the same
closed loop driven through a server by `ServingClient` push streams, one
client thread a stream, which also times each request's first token as the
client sees it), and the open loop (`run_open_loop` over `expand_schedule`'s
arrivals), the offered-load driver a benchmark's overload legs use.

A "stream" models one user connection: it keeps exactly one request in
flight, submitting its next request the moment the previous one completes —
so `concurrency=N` holds N requests live and continuous batching gets to
fill up to N slots per decode step. `concurrency=1` IS the sequential
per-request baseline (same executables, same platform, same shapes): the
measured speedup isolates dynamic batching, not kernel differences."""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


def make_prompts(
    n: int,
    lengths: Sequence[int],
    vocab: int,
    bos_id: int,
    seed: int = 0,
) -> List[List[int]]:
    """Deterministic mixed-length prompts (BOS + random ids; never EOS so
    lengths are workload-controlled, not sampling-controlled)."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        ln = int(lengths[i % len(lengths)])
        body = rs.randint(3, vocab, size=ln - 1)
        out.append([bos_id] + [int(t) for t in body])
    return out


def make_repetitive_prompts(
    n: int,
    motif_len: int,
    repeats: int,
    vocab: int,
    bos_id: int,
    seed: int = 0,
) -> List[List[int]]:
    """High-overlap prompts for the speculative-decoding legs:
    each prompt is BOS + a short random motif repeated, so the prompt-lookup
    drafter has dense n-gram matches from the first generated token. A
    per-prompt motif keeps the workload shape-diverse across requests while
    every individual request stays self-similar — the regime prompt-lookup
    speculation is built for (extraction, code edits, templated text)."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        motif = [int(t) for t in rs.randint(3, vocab, size=motif_len)]
        out.append([bos_id] + motif * repeats)
    return out


def make_shared_prefix_prompts(
    n: int,
    n_prefixes: int,
    prefix_len: int,
    suffix_len: int,
    vocab: int,
    bos_id: int,
    seed: int = 0,
) -> List[List[int]]:
    """The prefix-cache workload: `n_prefixes` distinct system prompts,
    each shared by user turns that differ only in a short random suffix.
    Prompts cycle round-robin over the prefixes, so consecutive requests hit
    different chains; every suffix is unique, so past the shared pages each
    request still pays its own prefill."""
    rs = np.random.RandomState(seed)
    prefixes = [
        [bos_id] + [int(t) for t in rs.randint(3, vocab, size=prefix_len - 1)]
        for _ in range(n_prefixes)
    ]
    out = []
    for i in range(n):
        suffix = [int(t) for t in rs.randint(3, vocab, size=suffix_len)]
        out.append(prefixes[i % n_prefixes] + suffix)
    return out


def make_mixed_prompts(
    n: int,
    short_lengths: Sequence[int],
    long_len: int,
    long_every: int,
    vocab: int,
    bos_id: int,
    seed: int = 0,
    burst: int = 3,
) -> List[List[int]]:
    """The chunked-prefill workload: a steady short-prompt stream with a
    burst of `burst` long prompts joining every `long_every` requests
    mid-stream, the arrival pattern whole-prompt prefill stalls on."""
    base = make_prompts(n, lengths=short_lengths, vocab=vocab, bos_id=bos_id,
                        seed=seed)
    rs = np.random.RandomState(seed + 1)
    for i in range(long_every // 2, n, long_every):
        for j in range(i, min(i + burst, n)):
            body = rs.randint(3, vocab, size=long_len - 1)
            base[j] = [bos_id] + [int(t) for t in body]
    return base


def run_closed_loop(
    session,
    prompts: List[List[int]],
    max_new_tokens,  # int, or a per-prompt list (staggers retirements)
    concurrency: int,
    tenant: str = "default",
    deadline_s: Optional[float] = None,
    ttft_deadline_s: Optional[float] = None,
) -> Dict:
    """Drive `session` single-threaded: keep up to `concurrency` requests in
    flight, stepping the engine until all prompts complete. Returns
    tokens/sec plus p50/p99/p999 request latency, the INTER-TOKEN latency
    percentiles (gap between consecutive tokens of one stream, observed at
    engine-step boundaries — the number a whole-prompt prefill stall shows
    up in and chunked prefill must keep flat), and (when deadlines
    are armed) the deadline-miss and shed columns — present either way, so
    bench rounds stay comparable. Throughput and the percentiles count only
    requests that COMPLETED: a deadline-cancelled request's partial tokens
    and truncated latency would otherwise flatter the overloaded run
    (higher tok/s, lower p99) exactly when it is failing."""
    from paddle_tpu_torch.serving.quota import QuotaExceeded

    budgets = (
        list(max_new_tokens) if isinstance(max_new_tokens, (list, tuple))
        else [max_new_tokens] * len(prompts)
    )
    pending = list(enumerate(prompts))
    in_flight = {}  # request_id -> (index, handle)
    latencies_ms: List[float] = []
    itl_ms: List[float] = []  # inter-token gaps across ALL streams
    token_seen = {}  # request_id -> (token_count, t_last_token)
    tokens_out = 0
    shed = 0
    deadline_missed = 0
    results: List[Optional[List[int]]] = [None] * len(prompts)

    t0 = time.monotonic()
    while pending or in_flight:
        while pending and len(in_flight) < concurrency:
            idx, prompt = pending.pop(0)
            try:
                h = session.submit(
                    prompt, budgets[idx], tenant=tenant,
                    deadline_s=deadline_s, ttft_deadline_s=ttft_deadline_s,
                )
            except QuotaExceeded:
                shed += 1
                continue
            in_flight[h.request_id] = (idx, h)
            token_seen[h.request_id] = (0, None)
        session.step()
        now = time.monotonic()
        # inter-token latency: a stream's gap between consecutive tokens,
        # measured at this loop's step boundary (first token = TTFT,
        # excluded — ITL isolates the steady-stream stall a co-scheduled
        # prefill causes). A step may deliver SEVERAL tokens to one stream
        # (a speculative verify round): the gap amortizes over
        # them and each delivered token contributes ONE sample, so the
        # percentiles stay per-token — a multi-token step must pull p50
        # down in proportion to the tokens it delivered, not count once
        # alongside the single-token steps
        for rid, (_, h) in in_flight.items():
            n_prev, t_prev = token_seen[rid]
            n_now = len(h.tokens)
            if n_now > n_prev:
                if t_prev is not None:
                    gap = (now - t_prev) * 1e3 / (n_now - n_prev)
                    itl_ms.extend([gap] * (n_now - n_prev))
                token_seen[rid] = (n_now, now)
        done = [rid for rid, (_, h) in in_flight.items() if h.done]
        for rid in done:
            idx, h = in_flight.pop(rid)
            token_seen.pop(rid, None)
            if h.status == h.DONE:
                results[idx] = h.tokens
                tokens_out += len(h.tokens)
                latencies_ms.append((h.t_done - h.t_submit) * 1e3)
            elif h.finish_reason == "deadline":
                deadline_missed += 1
    dt = time.monotonic() - t0

    lat = np.asarray(latencies_ms) if latencies_ms else np.asarray([0.0])
    itl = np.asarray(itl_ms) if itl_ms else np.asarray([0.0])
    accepted = len(latencies_ms) + deadline_missed
    return {
        "concurrency": concurrency,
        "requests": len(prompts),
        "tokens": tokens_out,
        "wall_s": round(dt, 4),
        "tokens_per_sec": round(tokens_out / dt, 1) if dt > 0 else 0.0,
        "p50_latency_ms": round(float(np.percentile(lat, 50)), 2),
        "p99_latency_ms": round(float(np.percentile(lat, 99)), 2),
        "p999_latency_ms": round(float(np.percentile(lat, 99.9)), 2),
        "p50_inter_token_ms": round(float(np.percentile(itl, 50)), 3),
        "p99_inter_token_ms": round(float(np.percentile(itl, 99)), 3),
        "shed": shed,
        "deadline_misses": deadline_missed,
        "deadline_miss_ratio": round(deadline_missed / accepted, 4)
        if accepted else 0.0,
        "results": results,
    }


def run_closed_loop_rpc(
    make_client: Callable[[], object],
    prompts: List[List[int]],
    max_new_tokens: int,
    concurrency: int,
) -> Dict:
    """The closed loop through a server: `concurrency` client threads, each
    with its own client from `make_client()` (a `ServingClient`), each
    keeping one request in flight — it `stream`s the next prompt the moment
    the previous one finished. Every pushed frame is stamped on arrival, so
    the report holds the client's view: tokens/s over the wall, TTFT (submit
    to first token frame) p50/p99, request latency p50/p99 and the
    inter-token gap p50/p99 (a frame of n tokens gives n samples of its gap
    over n). Greedy requests; `results` are the tokens in prompt order."""
    queue = list(enumerate(prompts))
    lock = threading.Lock()
    results: List[Optional[List[int]]] = [None] * len(prompts)
    ttft_ms: List[float] = []
    latencies_ms: List[float] = []
    itl_ms: List[float] = []
    errors: List[BaseException] = []

    def worker():
        client = make_client()
        try:
            while True:
                with lock:
                    if not queue or errors:
                        return
                    idx, prompt = queue.pop(0)
                t_submit = time.monotonic()
                t_prev = None
                toks: List[int] = []
                for frame in client.stream(prompt, max_new_tokens):
                    now = time.monotonic()
                    new = frame.get("tokens") or []
                    if new:
                        if t_prev is None:
                            with lock:
                                ttft_ms.append((now - t_submit) * 1e3)
                        else:
                            gap = (now - t_prev) * 1e3 / len(new)
                            with lock:
                                itl_ms.extend([gap] * len(new))
                        t_prev = now
                        toks.extend(new)
                with lock:
                    results[idx] = toks
                    latencies_ms.append((time.monotonic() - t_submit) * 1e3)
        except BaseException as e:  # noqa: BLE001 — reported to the caller
            with lock:
                errors.append(e)
        finally:
            client.close()

    t0 = time.monotonic()
    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(max(1, int(concurrency)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.monotonic() - t0
    if errors:
        raise RuntimeError(f"closed-loop stream failed: {errors[0]!r}") from errors[0]
    n_tok = sum(len(r) for r in results if r)

    def pct(xs, q):
        return float(np.percentile(np.asarray(xs), q)) if xs else 0.0

    return {
        "concurrency": concurrency,
        "requests": len(prompts),
        "tokens": n_tok,
        "wall_s": dt,
        "tokens_per_sec": n_tok / dt if dt > 0 else 0.0,
        "ttft_p50_ms": pct(ttft_ms, 50),
        "ttft_p99_ms": pct(ttft_ms, 99),
        "p50_latency_ms": pct(latencies_ms, 50),
        "p99_latency_ms": pct(latencies_ms, 99),
        "p50_inter_token_ms": pct(itl_ms, 50),
        "p99_inter_token_ms": pct(itl_ms, 99),
        "results": results,
    }


def expand_schedule(
    n: int,
    schedule: Sequence,  # [(duration_s, rate_rps), ...]
) -> List:
    """Flatten a time-varying load schedule into absolute arrival offsets:
    each `(duration_s, rate_rps)` phase contributes evenly spaced arrivals
    for its duration (rate 0: an idle phase). Returns `[(offset_s,
    phase_idx), ...]`, at most `n` entries."""
    arrivals = []
    t = 0.0
    for p, (dur, rate) in enumerate(schedule):
        dur = float(dur)
        rate = float(rate)
        if rate > 0:
            interval = 1.0 / rate
            k = 0
            while k * interval < dur and len(arrivals) < n:
                arrivals.append((t + k * interval, p))
                k += 1
        t += dur
    return arrivals


def run_open_loop(
    session,
    prompts: List[List[int]],
    max_new_tokens: int,
    rate_rps: Optional[float] = None,
    tenants: Sequence[str] = ("default",),
    deadline_s: Optional[float] = None,
    ttft_deadline_s: Optional[float] = None,
    schedule: Optional[Sequence] = None,
) -> Dict:
    """Open-loop (offered-load) driver: arrivals land on a fixed schedule
    whatever the completions, so offered load above capacity builds a queue
    (and sheds) instead of throttling itself. The engine runs inline on
    this thread, one step an iteration. Offered load is a constant
    `rate_rps` or a `schedule` of `(duration_s, rate_rps)` phases; with a
    schedule the report gains per-phase `phases`. Goodput = requests that
    completed within their deadline per second of wall clock."""
    from paddle_tpu_torch.serving.quota import QuotaExceeded

    n = len(prompts)
    if schedule is not None:
        arrivals = expand_schedule(n, schedule)
        phase_specs = [(float(d), float(r)) for d, r in schedule]
    else:
        if rate_rps is None:
            raise ValueError("run_open_loop needs rate_rps or schedule")
        interval = 1.0 / float(rate_rps)
        arrivals = [(i * interval, 0) for i in range(n)]
        phase_specs = None
    handles = []
    handle_phase = []  # parallel to handles: arrival phase index
    shed = 0
    shed_by_phase: Dict[int, int] = {}
    offered_by_phase: Dict[int, int] = {}
    i = 0
    t0 = time.monotonic()
    while i < len(arrivals) or session.scheduler.has_work():
        now = time.monotonic()
        while i < len(arrivals) and t0 + arrivals[i][0] <= now:
            phase = arrivals[i][1]
            offered_by_phase[phase] = offered_by_phase.get(phase, 0) + 1
            try:
                handles.append(session.submit(
                    prompts[i], max_new_tokens,
                    tenant=tenants[i % len(tenants)],
                    deadline_s=deadline_s, ttft_deadline_s=ttft_deadline_s,
                ))
                handle_phase.append(phase)
            except QuotaExceeded:
                shed += 1
                shed_by_phase[phase] = shed_by_phase.get(phase, 0) + 1
            i += 1
        if session.scheduler.has_work():
            session.step(now)
        elif i < len(arrivals):
            time.sleep(max(0.0, min(0.002, t0 + arrivals[i][0] - now)))
    dt = time.monotonic() - t0

    completed_ok = sum(1 for h in handles if h.status == h.DONE)
    missed = sum(1 for h in handles if h.finish_reason == "deadline")
    offered_rps = (
        rate_rps if schedule is None
        else n / sum(d for d, _ in phase_specs)
        if phase_specs and sum(d for d, _ in phase_specs) > 0 else 0.0
    )
    report = {
        "offered_rps": round(float(offered_rps), 2),
        "requests_offered": len(arrivals),
        "accepted": len(handles),
        "shed": shed,
        "completed_ok": completed_ok,
        "deadline_misses": missed,
        "deadline_miss_ratio": round(missed / len(handles), 4)
        if handles else 0.0,
        "goodput_rps": round(completed_ok / dt, 2) if dt > 0 else 0.0,
        "wall_s": round(dt, 4),
    }
    if phase_specs is not None:
        phases = []
        for p, (dur, rate) in enumerate(phase_specs):
            ok = sum(
                1 for h, hp in zip(handles, handle_phase)
                if hp == p and h.status == h.DONE
            )
            phases.append({
                "phase": p,
                "duration_s": dur,
                "rate_rps": rate,
                "offered": offered_by_phase.get(p, 0),
                "shed": shed_by_phase.get(p, 0),
                "completed_ok": ok,
                "goodput_rps": round(ok / dur, 2) if dur > 0 else 0.0,
            })
        report["phases"] = phases
    return report
