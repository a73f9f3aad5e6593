"""`python -m paddle_tpu_torch` — the port's CLI: `serve` only.

The port's counterpart of `paddle_tpu/cli.py`'s `serve` subcommand
(`_serve_args` / `cmd_serve`), with the same flags and the same output
lines, plus `--device` (default `cuda`; the tests pass `cpu`):

    python -m paddle_tpu_torch serve [--device=cuda|cpu] [--port=N]
        [--demo | --load=model.npz] [--max_slots=N] [--page_size=N]
        [--prefill_buckets=16,32,64] [--prefill_chunk=C] [--speculate_k=K]
        [--prefix_cache] [--max_new_limit=N] [--max_queue=N]
        [--tenant_tokens=CAP] [--tenant_tokens_per_s=R] [--tenant_concurrent=N]
        [--default_deadline_s=S] [--default_ttft_deadline_s=S]
        [--engine_restart_max=N] [--engine_stall_timeout_s=S]
        [--lease_s=S] [--require_register=0|1]

It prints `{"role": "serve", "address": [host, port]}` once listening and,
on SIGTERM or SIGINT, `{"final_stats": {...}}` before it exits 0. Not ported
yet: `--tp > 1` (ROADMAP.md queue 1 item 6) and `--config` (item 3.3); both
raise a named NotImplementedError. The router and fleet flags wait for the
router's slice."""

from __future__ import annotations

import argparse
import json
import sys
import threading
from typing import List, Optional

_NOT_PORTED = (
    "{what} is not ported to paddle_tpu_torch yet (ROADMAP.md, queue 1, "
    "item {item})"
)


def _str2bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "yes", "on")


def _serve_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="where the engine runs: cuda (default) or cpu")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0, help="0 picks a free port")
    p.add_argument(
        "--demo", action="store_true",
        help="serve the built-in seeded demo LM (smoke/bench mode)",
    )
    p.add_argument("--load", default=None,
                   help="ServableLM .npz to serve (either package's format)")
    p.add_argument(
        "--config", default=None,
        help="v1 config script served through a GenerationSession (not "
             "ported yet: raises)",
    )
    p.add_argument("--model_dir", default=None, help="params for --config")
    p.add_argument("--config_args", default="")
    p.add_argument("--max_slots", type=int, default=8,
                   help="concurrent decode slots = the continuous batch width")
    p.add_argument("--page_size", type=int, default=16,
                   help="tokens per KV page")
    p.add_argument("--num_pages", type=int, default=0,
                   help="KV page pool size (0 = worst case for max_slots)")
    p.add_argument("--prefill_buckets", default="16,32,64",
                   help="padded prompt lengths of the whole-prompt prefill")
    p.add_argument("--prefill_chunk", type=int, default=0,
                   help="chunked prefill (0 = off): prompts longer than this "
                        "commit their KV one C-token chunk per engine step, "
                        "interleaved with decode; also lifts the bucket cap "
                        "on prompt length")
    p.add_argument("--speculate_k", type=int, default=0,
                   help="prompt-lookup speculative decoding (0 = off): draft "
                        "up to K tokens per request per step from the "
                        "request's own n-grams and score them in ONE "
                        "[1, K+1] verify call; tokens are identical to "
                        "--speculate_k 0")
    p.add_argument("--prefix_cache", action="store_true",
                   help="shared-prefix KV cache (needs --prefill_chunk)")
    p.add_argument("--prefix_cache_pages", type=int, default=0,
                   help="cap on cached prefix pages (0 = bounded by the pool)")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="default sampling temperature (0 = greedy argmax)")
    p.add_argument("--top_k", type=int, default=0,
                   help="default top-k truncation (0 = off)")
    p.add_argument("--tp", type=int, default=0,
                   help="tensor-parallel size (not ported yet: > 1 raises)")
    p.add_argument("--max_new_limit", type=int, default=64)
    p.add_argument("--max_queue", type=int, default=256)
    p.add_argument("--tenant_tokens", type=float, default=0.0,
                   help="per-tenant token-bucket capacity (0 = unlimited)")
    p.add_argument("--tenant_tokens_per_s", type=float, default=0.0)
    p.add_argument("--tenant_concurrent", type=int, default=0,
                   help="per-tenant concurrent-request cap (0 = unlimited)")
    p.add_argument("--default_deadline_s", type=float, default=0.0,
                   help="total-latency deadline for requests that do not set "
                        "one (0 = none); also arms load-aware shedding")
    p.add_argument("--default_ttft_deadline_s", type=float, default=0.0,
                   help="time-to-first-token deadline default (0 = none); "
                        "misses are counted, not fatal")
    p.add_argument("--engine_restart_max", type=int, default=3,
                   help="engine crash/stall recoveries before the server "
                        "fails outstanding requests ('engine_error')")
    p.add_argument("--engine_stall_timeout_s", type=float, default=10.0,
                   help="supervisor stall watchdog: no step progress for this "
                        "long with work pending restarts the engine")
    p.add_argument("--lease_s", type=float, default=30.0,
                   help="tenant lease; silent clients are evicted and their "
                        "queued requests cancelled")
    p.add_argument("--require_register", type=_str2bool, default=False,
                   help="reject requests without a registered tenant lease")
    # demo model shape knobs (ignored with --load)
    p.add_argument("--max_len", type=int, default=0,
                   help="demo model position capacity (0 = largest bucket + "
                        "max_new_limit)")
    p.add_argument("--vocab", type=int, default=128)
    p.add_argument("--n_layers", type=int, default=2)
    p.add_argument("--d_model", type=int, default=32)
    p.add_argument("--n_heads", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)


def cmd_serve(args: argparse.Namespace) -> int:
    """Long-lived serving process: load once, serve until SIGTERM/SIGINT."""
    import signal as _signal

    from paddle_tpu_torch.serving.quota import TenantQuotas
    from paddle_tpu_torch.serving.server import ServingServer

    if args.tp and args.tp > 1:
        raise NotImplementedError(_NOT_PORTED.format(
            what="tensor-parallel serving (--tp > 1)", item="6, TP serving"))
    if args.config:
        raise NotImplementedError(_NOT_PORTED.format(
            what="serving a v1 config (--config, generate_config)",
            item="3.3, generation"))
    quotas = None
    if args.tenant_tokens_per_s > 0 and args.tenant_tokens <= 0:
        # a refill rate without a bucket capacity is a no-op; saying nothing
        # would leave the operator believing rate limiting is on
        print(
            "--tenant_tokens_per_s needs --tenant_tokens (the bucket "
            "capacity); no token quota will be enforced", file=sys.stderr,
        )
    elif args.tenant_tokens > 0 and args.tenant_tokens_per_s <= 0:
        # the inverse surprise: a bucket that never refills is a LIFETIME
        # cap, not a rate limit
        print(
            "--tenant_tokens without --tenant_tokens_per_s never refills: "
            "each tenant gets a one-time lifetime budget of "
            f"{args.tenant_tokens:.0f} tokens", file=sys.stderr,
        )
    if args.tenant_tokens > 0 or args.tenant_concurrent > 0:
        quotas = TenantQuotas(
            token_capacity=args.tenant_tokens or None,
            tokens_per_s=args.tenant_tokens_per_s,
            max_concurrent=args.tenant_concurrent or None,
        )
    if not (args.demo or args.load):
        print("serve needs a model: --demo or --load=model.npz",
              file=sys.stderr)
        return 2

    from paddle_tpu_torch.serving.model import ServableLM
    from paddle_tpu_torch.serving.session import ServingSession, make_demo_session

    buckets = tuple(
        int(b) for b in args.prefill_buckets.split(",") if b.strip()
    )
    session_kw = dict(
        max_slots=args.max_slots,
        page_size=args.page_size,
        num_pages=args.num_pages or None,
        prefill_buckets=buckets,
        prefill_chunk=args.prefill_chunk or None,
        prefix_cache=args.prefix_cache,
        prefix_cache_pages=args.prefix_cache_pages or None,
        speculate_k=args.speculate_k,
        default_temperature=args.temperature,
        default_top_k=args.top_k,
        max_new_limit=args.max_new_limit,
        max_queue=args.max_queue,
        quotas=quotas,
        default_deadline_s=args.default_deadline_s or None,
        default_ttft_deadline_s=args.default_ttft_deadline_s or None,
        engine_restart_max=args.engine_restart_max,
        engine_stall_timeout_s=args.engine_stall_timeout_s,
    )
    if args.load:
        model = ServableLM.load(args.load, device=args.device)
        session = ServingSession(model, device=args.device, **session_kw)
    else:
        session = make_demo_session(
            vocab=args.vocab, n_layers=args.n_layers, d_model=args.d_model,
            n_heads=args.n_heads, seed=args.seed,
            max_len=args.max_len or None, device=args.device, **session_kw,
        )

    stop_evt = threading.Event()
    server = ServingServer(
        session, host=args.host, port=args.port, lease_s=args.lease_s,
        require_register=args.require_register,
    ).start()
    _signal.signal(_signal.SIGTERM, lambda *_: stop_evt.set())
    _signal.signal(_signal.SIGINT, lambda *_: stop_evt.set())
    print(json.dumps({"role": "serve", "address": list(server.address)}),
          flush=True)
    stop_evt.wait()
    server.stop()
    print(json.dumps({"final_stats": session.stats()}), flush=True)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="paddle_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_serve = sub.add_parser(
        "serve", help="continuous-batching inference server"
    )
    _serve_args(p_serve)
    p_serve.set_defaults(fn=cmd_serve)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
