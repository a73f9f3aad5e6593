"""The readings that a cell's limits for `correct` are set from, many seeds
in one process (one a card):

    python -m portbench.calibrate --workload <cell> --seeds 1,2,3 [--out FILE]

For each seed, the program's first three steps as a run takes them (the
same set-up, call and feed), then the reference's, and against the
reference:
  program   the program's numbers (the lower readings);
  control   the reference in the program's place at the configuration's
            `control` precision (the nearest below the stated one);
  half      the reference in the program's place on half of each batch,
            the mean taken over the rest (a planted fault);
  exchange  on several ranks: the reference on rank 0's rows alone, as
            when the exchange between cards is left out (a planted fault).
A step that returns its state unchanged reads 1 on `delta_gap` by the
measure itself and needs no run. One JSON line a seed on stdout (and in
--out)."""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from portbench import compare
from portbench.harness import Coord, Setup, cut


def calibrate_rank(cell, seeds: List[int], coord: Coord, device: torch.device,
                   out: Optional[Any] = None) -> Optional[List[Dict[str, Any]]]:
    s = Setup(cell, coord, device)
    cfg = cell.config
    lines = []
    for seed in seeds:
        t0 = time.perf_counter()
        first = s.first_steps(seed)
        coord.post(f"cal{seed}", first["prog"])
        if coord.rank != 0:
            continue
        progs = coord.gather(f"cal{seed}", first["prog"])
        # the step graphs' memory goes before the references run (the next
        # seed's first step captures anew)
        s.trainer.graphs.clear()
        gc.collect()
        torch.cuda.empty_cache()
        ref = s.reference(first)
        line = {"seed": seed, "program": compare.worst_over(
            [compare.numbers(p, ref) for p in progs])}
        alts = {"control": s.reference(first, precision=cfg["control"]),
                "half": s.reference(first, rows=lambda b: cut(b, 0, 2))}
        if coord.world > 1:
            alts["exchange"] = s.reference(first, rows=lambda b: cut(b, 0, coord.world))
        line.update({k: compare.numbers(v, ref) for k, v in alts.items()})
        line["losses"] = {"program": first["prog"]["losses"], "reference": ref["losses"],
                          **{k: v["losses"] for k, v in alts.items()}}
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        if out is not None:
            out.write(json.dumps(line) + "\n")
            out.flush()
        lines.append(line)
        del first
        torch.cuda.empty_cache()
    return lines if coord.rank == 0 else None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--out", default="")
    p.add_argument("--program-precision", default="",
                   help="run the program at this precision instead of the configuration's "
                        "(a second witness beside the reference)")
    args = p.parse_args(argv)
    from portbench.run import cache_env

    cache_env()
    from portbench import manifest

    cell = manifest.load(args.workload)
    if args.program_precision:
        cell.config = dict(cell.config, precision=args.program_precision)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print("portbench.calibrate: not enough CUDA cards", file=sys.stderr)
        return 3
    if cell.chips > 1:
        from portbench.launch import launch

        lines = launch(cell.chips, ["--workload", args.workload, "--calibrate", args.seeds],
                       3000.0)
        if lines is None:
            return 1
        text = "".join(json.dumps(line) + "\n" for line in lines)
        print(text, end="")
        if args.out:
            with open(args.out, "w") as f:
                f.write(text)
        return 0
    with open(args.out, "w") if args.out else contextlib.nullcontext() as f:
        calibrate_rank(cell, [int(x) for x in args.seeds.split(",")], Coord(),
                       torch.device("cuda", 0), f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
