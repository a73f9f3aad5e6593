"""One rank of a cell's run: set-up, the measured window, the traced
stretch and the comparison with the reference.

The window drives the entry users call, `SGDTrainer.train(reader)`, with
the port's `DevicePrefetcher` feeding it host batches cycled from a pool
made from the seed. Set-up builds the trainer, hands it the benchmark's
weights (`load_params`, `load_states`) and drives it through its first
three steps on three different batches by the same call and feed: the
first runs eagerly and captures the step graph, the next two replay it.
Those three steps are what the reference follows. The window then runs
for `seconds` and ends on a device sync; its rate is all the work whose
steps completed over all of its time.

On several ranks each process runs this with its own card; rank 0 decides
when the window ends and the others stop at the same step (through the
launcher's store), and rank 0 gathers what every rank read."""

from __future__ import annotations

import dataclasses
import gc
import json
import sys
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from portbench import compare, generator, isolation, peaks
from portbench.manifest import Cell

SETUP_STEPS = 3
STOP_MARGIN = 8  # steps a multi-rank window runs on past rank 0's deadline


@dataclasses.dataclass
class Coord:
    """This rank's place in the run. `store`: the launcher's key-value
    store (None on one rank); `group`: the process group the mesh spans
    (None: the default one)."""
    rank: int = 0
    world: int = 1
    store: Any = None
    group: Any = None

    def post(self, key: str, value: Any) -> None:
        if self.store is not None:
            self.store.set(f"portbench/{key}/{self.rank}", json.dumps(value))

    def gather(self, key: str, mine: Any) -> List[Any]:
        if self.store is None:
            return [mine]
        return [mine if r == self.rank else json.loads(self.store.get(f"portbench/{key}/{r}"))
                for r in range(self.world)]


@dataclasses.dataclass
class Run:
    """What the per-layer readers read (`metrics/<metric>.py`)."""
    cell: Cell
    reference: Any
    card: Dict[str, float]
    world: int
    window_s: float
    window_flops: float
    trace: Any
    traced_batches: List[Dict[str, np.ndarray]]


def cut(batch: Dict[str, np.ndarray], rank: int, world: int) -> Dict[str, np.ndarray]:
    """This rank's rows of a global batch."""
    if world == 1:
        return batch
    n = len(next(iter(batch.values()))) // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


class Setup:
    """The trainer, its mesh and the pool; the first steps' readings."""

    def __init__(self, cell: Cell, coord: Coord, device: torch.device,
                 mark: Callable[[str], None] = lambda stage: None):
        self.cell, self.coord, self.device, self.mark = cell, coord, device, mark
        self.program, self.ref = cell.program(), cell.reference()
        self.parallel = None
        if coord.world > 1:
            from paddle_tpu_torch.parallel import DataParallel, make_mesh

            self.parallel = DataParallel(make_mesh({"data": coord.world}, group=coord.group,
                                                   device=device))
        self.trainer = self.program.build_trainer(cell.config, device, self.parallel)

    def feed(self, reader: Callable[[], Iterator]):
        from paddle_tpu_torch.data.pipeline import DevicePrefetcher

        return DevicePrefetcher(reader, device=self.device, parallel=self.parallel)

    def first_steps(self, seed: int) -> Dict[str, Any]:
        """Pool and weights from `seed`, then the trainer's first steps on
        the pool's first batches, through `train` and the prefetcher. ->
        the pool, the weights and this rank's readings of the steps."""
        cfg, dev = self.cell.config, self.device
        pool = generator.make_pool(cfg, self.cell.traffic, seed, dev)
        self.mark("pool")
        params0 = self.ref.make_params(cfg, seed, dev)
        states0 = self.ref.initial_states(cfg, dev)
        self.mark("weights")
        tr = self.trainer
        tr.init_state(cut(pool[0], self.coord.rank, self.coord.world))
        tr.load_params(params0)
        if states0:
            tr.load_states(states0)
        self.mark("init_state")
        losses: List[float] = []
        seen: Dict[str, Any] = {}

        def on_event(ev):
            from paddle_tpu_torch.trainer.events import EndIteration

            if not isinstance(ev, EndIteration):
                return
            losses.append(ev.cost)
            self.mark(f"step{ev.batch_id + 1}")
            if ev.batch_id == 0:
                seen["grad"] = compare.norms(self.program.first_grads(
                    cfg, tr.state["opt"]["slots"]))
            if ev.batch_id == SETUP_STEPS - 1:
                seen["delta"] = compare.readings(
                    [], {}, tr.canonical_params(), tr.state["states"], params0, states0)["delta"]

        tr.train(self.feed(lambda: iter(pool[:SETUP_STEPS])), num_passes=1,
                 event_handler=on_event)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prog = {"losses": losses, "grad": seen["grad"], "delta": seen["delta"]}
        return {"pool": pool, "params0": params0, "states0": states0, "prog": prog}

    def reference(self, first: Dict[str, Any], precision: Optional[str] = None,
                  rows: Optional[Callable] = None) -> Dict[str, Any]:
        """The readings of the reference's three steps on the same weights and
        batches: in f32 with TF32 off, or at `precision` (a control), or on
        `rows` of each batch (a planted fault)."""
        cfg = self.cell.config
        batches = first["pool"][:SETUP_STEPS]
        if rows is not None:
            batches = [rows(b) for b in batches]
        out = self.ref.train_steps(cfg, first["params0"], first["states0"], batches,
                                   precision or "f32", self.device)
        return compare.readings(out["losses"], out["first_grad"], out["params"], out["states"],
                                first["params0"], first["states0"])


def _window_reader(pool, start: int, seconds: float, coord: Coord, t0: List[float],
                   yielded: List[int]):
    """Pool batches from `start` on, cycled, until the window's end: on one
    rank its deadline; on several, the step rank 0 names once its deadline
    has passed (every rank stops at the same step)."""
    def reader():
        stop_at = None
        i = start
        while True:
            n = len(yielded)
            if stop_at is None:
                if coord.world == 1 or coord.rank == 0:
                    if time.perf_counter() >= t0[0] + seconds:
                        stop_at = n + (STOP_MARGIN if coord.world > 1 else 0)
                        if coord.world > 1:
                            coord.store.set("portbench/stop_at", str(stop_at))
                elif coord.store.check(["portbench/stop_at"]):
                    stop_at = int(coord.store.get("portbench/stop_at"))
                    if n > stop_at:
                        raise RuntimeError(f"rank {coord.rank} is {n - stop_at} steps past "
                                           f"the window's end")
            if stop_at is not None and n >= stop_at:
                return
            yielded.append(i)
            yield pool[i]
            i = (i + 1) % len(pool)
    return reader


def run_rank(cell: Cell, seed: int, seconds: float, trace: bool, coord: Coord,
             device: torch.device, t_start: float) -> Optional[Dict[str, Any]]:
    """One rank's whole run -> the result (rank 0) or None."""
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    def mark(stage):
        # set-up's parts, as seconds from the run's start, on early stderr lines
        print(f"portbench: set-up {stage} at {time.time() - t_start:.3f} s", file=sys.stderr,
              flush=True)

    mark("imports")
    s = Setup(cell, coord, device, mark)
    mark("trainer")
    first = s.first_steps(seed)
    pool, cfg, tr = first["pool"], cell.config, s.trainer
    sync()
    # the window
    yielded: List[int] = []
    t0 = [time.perf_counter()]
    setup_s = time.time() - t_start
    reader = _window_reader(pool, SETUP_STEPS % len(pool), seconds, coord, t0, yielded)
    tr.train(s.feed(reader), num_passes=1)
    sync()
    window_s = time.perf_counter() - t0[0]
    batches = [pool[i] for i in yielded]
    work = float(sum(s.ref.work(cfg, b) for b in batches))
    flops = float(sum(s.ref.step_flops(cfg, b) for b in batches))
    tr_obj, traced = None, []
    if trace:
        from portbench.trace import profile_stretch

        k = int(cell.traffic["trace_steps"])
        at = (yielded[-1] + 1) % len(pool) if yielded else 0
        idx = [(at + j) % len(pool) for j in range(k)]
        traced = [cut(pool[i], coord.rank, coord.world) for i in idx]
        tr_obj = profile_stretch(
            lambda: tr.train(s.feed(lambda: iter([pool[i] for i in idx])), num_passes=1),
            device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    # the program's state goes before the reference runs
    tr.close()
    del tr, s.trainer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    mine = {"prog": first["prog"], "peak": peak, "busy_s": tr_obj.busy_s if tr_obj else None}
    if coord.rank != 0:
        # this rank's last step: what it loaded is final here
        coord.post("rank", dict(mine, found=isolation.forbidden_modules()))
        return None
    ranks = coord.gather("rank", mine)
    ref = s.reference(first)
    nums = compare.worst_over([compare.numbers(r["prog"], ref) for r in ranks])
    correct, compared = compare.judge(nums, cell.limits)
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    result: Dict[str, Any] = {
        "correct": correct, "attempted": SETUP_STEPS + len(yielded),
        "failed": 0 if correct else SETUP_STEPS,
        "metrics": {},
        "device": {"platform": "gpu" if cuda else "cpu", "kind": name, "count": coord.world,
                   "memory_peak_bytes": max(r["peak"] for r in ranks)},
    }
    if trace:
        run = Run(cell=cell, reference=s.ref, card=peaks.card(name) if cuda else {},
                  world=coord.world, window_s=window_s, window_flops=flops, trace=tr_obj,
                  traced_batches=traced)
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(run)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        result["device"]["busy_s"] = sum(r["busy_s"] for r in ranks) / len(ranks)
        result["device"]["window_s"] = tr_obj.window_s
        result["breakdown"] = {"device_ops": tr_obj.top_ops(), "idle_gaps": tr_obj.top_gaps()}
    else:
        for m in cell.end_to_end:
            value = (setup_s if m["name"] == "setup_s"
                     else work / window_s if m["name"] == cfg["rate_metric"] else None)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    result["window"] = {"seconds": window_s, "steps": len(yielded), "work": work,
                        "leaves": nums["leaves"]}
    # taken once the reference and the readers have run: what they load counts
    result["found_modules"] = sorted(set(isolation.forbidden_modules()).union(
        *(r.get("found", ()) for r in ranks)))
    result["compared"] = compared
    return result


def emit(result: Dict[str, Any]) -> int:
    """Print the result's line last on stdout and the compared numbers last
    on stderr -> the exit code (1 when a forbidden module was loaded, here
    or on a rank, and then no result)."""
    found = sorted(set(result.pop("found_modules", ())) | set(isolation.forbidden_modules()))
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 1
    for k, c in result["compared"].items():
        print(f"compared {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result, allow_nan=True), flush=True)
    sys.stderr.flush()
    return 0
