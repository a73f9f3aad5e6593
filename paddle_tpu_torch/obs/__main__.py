"""`python -m paddle_tpu_torch.obs` — operator CLI for the observability plane.

    python -m paddle_tpu_torch.obs export [--endpoint host:port] [--out FILE]
        Prometheus text: from a running master/serving server's `metrics`
        RPC (--endpoint, failover lists accepted), or from this process's
        local registry without one.

    python -m paddle_tpu_torch.obs trace [--endpoint host:port ...] [--out FILE]
        Chrome trace JSON (Perfetto-loadable): local ring buffer merged
        with every --endpoint's `trace_export` RPC — one file, spans
        stitched on trace_id across processes.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def _rpc(endpoint: str, method: str) -> dict:
    from paddle_tpu_torch.runtime.master import MasterClient

    client = MasterClient(endpoint, retries=2, timeout=10.0)
    try:
        return client.call(method)
    finally:
        client.close()


def cmd_export(args: argparse.Namespace) -> int:
    from paddle_tpu_torch.obs import metrics

    if args.endpoint:
        resp = _rpc(args.endpoint, "metrics")
        if "err" in resp:
            print(f"metrics RPC failed: {resp['err']}", file=sys.stderr)
            return 1
        text = resp.get("text", "")
    else:
        text = metrics.to_prometheus_text()
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(args.out)
    else:
        sys.stdout.write(text)
    return 0


def cmd_trace(args: argparse.Namespace) -> int:
    from paddle_tpu_torch.obs import trace

    traces = [trace.export_chrome()]
    for ep in args.endpoint or []:
        resp = _rpc(ep, "trace_export")
        if "err" in resp:
            print(f"trace_export RPC to {ep} failed: {resp['err']}",
                  file=sys.stderr)
            return 1
        traces.append(resp.get("chrome_trace") or {})
    merged = trace.merge_chrome(traces, path=args.out)
    problems = trace.validate_chrome(merged)
    if problems:
        print("trace format problems: " + "; ".join(problems), file=sys.stderr)
        return 1
    if args.out:
        print(args.out)
    else:
        json.dump(merged, sys.stdout)
        sys.stdout.write("\n")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="paddle_tpu_torch.obs")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_exp = sub.add_parser("export", help="Prometheus metrics text")
    p_exp.add_argument(
        "--endpoint", default=None,
        help="master/serving server to query (host:port, failover list ok); "
             "omitted = this process's local registry",
    )
    p_exp.add_argument("--out", default=None, help="write to file (default stdout)")
    p_exp.set_defaults(fn=cmd_export)

    p_tr = sub.add_parser("trace", help="Chrome trace JSON (Perfetto)")
    p_tr.add_argument(
        "--endpoint", action="append", default=None,
        help="server(s) whose span buffers to merge in (repeatable)",
    )
    p_tr.add_argument("--out", default=None, help="write to file (default stdout)")
    p_tr.set_defaults(fn=cmd_trace)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
