"""One rank of a multi-card cell, started by `launch.py`:

    python -m portbench.rank --workload <cell> --seed <n> --seconds <s>
        --trace <0|1> --t_start <unix s> --rank <r> --world <n> --store <host:port>

It joins the NCCL group over the launcher's store, runs the cell on
`cuda:<rank>` (`harness.run_rank`, or with --calibrate the readings of
`calibrate.py`) and, on rank 0, leaves the result in the store."""

from __future__ import annotations

import argparse
import datetime
import json
import sys

from portbench.run import cache_env


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench.rank")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--t_start", type=float, default=0.0)
    p.add_argument("--calibrate", default="")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--store", required=True)
    args = p.parse_args(argv)
    cache_env()
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import distributed

    from portbench import harness, manifest
    from portbench.launch import RESULT_KEY

    cell = manifest.load(args.workload)
    device = torch.device("cuda", args.rank)
    torch.cuda.set_device(device)
    distributed.initialize(args.store, args.world, args.rank, backend="nccl", host_store=False)
    host, port = args.store.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), args.world, False,
                          timeout=datetime.timedelta(seconds=300))
    coord = harness.Coord(rank=args.rank, world=args.world, store=store)
    if args.calibrate:
        from portbench import calibrate

        result = calibrate.calibrate_rank(cell, [int(s) for s in args.calibrate.split(",")],
                                          coord, device)
    else:
        result = harness.run_rank(cell, args.seed, args.seconds, bool(args.trace), coord,
                                  device, args.t_start)
    if result is not None:
        store.set(RESULT_KEY, json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
