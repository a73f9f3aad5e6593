"""The benchmark's command:

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Runs the cell named in BENCHMARK.json on the
cards of this machine (one process a card; a cell of several cards starts
its ranks through `launch.py`) and prints one JSON line last on stdout.
Fails, and prints no result, where there is no card, or fewer than the
cell asks for, or where the program is not in the checkout."""

from __future__ import annotations

import time

T_START = time.time()  # the run's start: setup_s counts from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 330.0


def cache_env() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = ROOT / "build" / "portbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)
    os.environ["USE_FLAX"] = "0"


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cache_env()
    import torch

    from portbench import harness, manifest

    cell = manifest.load(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), "
              f"{have} visible; no result", file=sys.stderr)
        return 3
    if cell.chips == 1:
        import paddle_tpu_torch  # noqa: F401 (fails where the program is absent)

        result = harness.run_rank(cell, args.seed, args.seconds, bool(args.trace),
                                  harness.Coord(), torch.device("cuda", 0), T_START)
    else:
        from portbench.launch import launch

        result = launch(cell.chips, ["--workload", args.workload, "--seed", str(args.seed),
                                     "--seconds", str(args.seconds), "--trace", str(args.trace),
                                     "--t_start", repr(T_START)], RANK_TIMEOUT_S)
        if result is None:
            return 1
    return harness.emit(result)


if __name__ == "__main__":
    sys.exit(main())
