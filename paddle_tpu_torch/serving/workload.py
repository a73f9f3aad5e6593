"""Closed-loop serving workloads: N concurrent streams vs sequential.

The port's slice of `paddle_tpu/serving/workload.py` (numpy only): the
mixed-length and repetitive prompt generators and the in-process closed
loop, plus `run_closed_loop_rpc`, the same closed loop driven through a
server by `ServingClient` push streams (one client thread a stream), which
also times each request's first token as the client sees it. The open
loop and the chunked-prefill / shared-prefix workloads wait for the port's
benchmark.

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
