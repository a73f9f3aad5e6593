"""Pass profiling and step cost reports (`--profile pass:N`), the port's
counterpart of `paddle_tpu/obs/profile.py`.

  * `PassProfiler` — watches the trainer's event stream and captures a
    `torch.profiler` trace of exactly one pass (start at BeginPass N, stop
    at EndPass N) into `logdir/trace.json`, through the idempotent
    `core.stats.profiler_start/stop`. `captured` says whether the trace
    holds events of the pass's device (kernel events on a card, operator
    events on the CPU): a window the profiler recorded nothing in is not a
    capture.
  * `compiled_cost_report` / `trainer_cost_report` — the reference's
    report keys (`top_k`, `generated_unix_s`,
    `executables.train_step.{flops, bytes_accessed, top_buckets}`), with
    torch's own counts in place of XLA's `cost_analysis()`: FLOPs from
    `torch.utils.flop_counter.FlopCounterMode`, bytes as the sum of each
    aten op's tensor inputs and outputs (a dispatch-mode count), both over
    one eager step at the batch, never inside a graph capture. A
    hand-written kernel called through ctypes is not an aten op: its work
    is not in either count.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = [
    "PassProfiler",
    "compiled_cost_report",
    "parse_profile_spec",
    "trainer_cost_report",
]


def parse_profile_spec(spec: str) -> Tuple[str, int]:
    """'pass:N' → ("pass", N); anything else is a ValueError naming the
    accepted form."""
    kind, sep, arg = (spec or "").partition(":")
    if kind != "pass" or not sep:
        raise ValueError(
            f"bad --profile spec {spec!r}: expected 'pass:N' "
            f"(capture a torch.profiler trace of pass N)"
        )
    try:
        n = int(arg)
    except ValueError:
        raise ValueError(f"bad --profile spec {spec!r}: N must be an integer")
    if n < 0:
        raise ValueError(f"bad --profile spec {spec!r}: N must be >= 0")
    return kind, n


class PassProfiler:
    """Wraps a trainer event handler; profiles exactly one pass."""

    def __init__(self, pass_id: int, logdir: str):
        self.pass_id = int(pass_id)
        self.logdir = logdir
        self.captured = False
        self.events = 0
        self.device_events = 0
        self._active = False

    @classmethod
    def from_spec(cls, spec: str, logdir: str) -> "PassProfiler":
        _, n = parse_profile_spec(spec)
        return cls(n, logdir)

    def wrap(self, handler: Callable) -> Callable:
        from paddle_tpu_torch.trainer.events import BeginPass, EndPass

        def wrapped(event):
            if isinstance(event, BeginPass) and event.pass_id == self.pass_id:
                self.start()
            try:
                handler(event)
            finally:
                if isinstance(event, EndPass) and self._active:
                    self.stop()

        return wrapped

    def start(self) -> None:
        from paddle_tpu_torch.core import stats

        os.makedirs(self.logdir, exist_ok=True)
        stats.profiler_start(self.logdir)
        self._active = True

    def stop(self) -> None:
        from paddle_tpu_torch.core import stats

        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the pass's kernels land in the window
        prof = stats.profiler_stop()
        self._active = False
        if prof is None:
            return
        evs = prof.events()
        self.events = len(evs)
        self.device_events = sum(
            1 for e in evs if e.device_type == torch.autograd.DeviceType.CUDA)
        self.captured = (self.device_events if torch.cuda.is_available()
                         else self.events) > 0


# -- step cost buckets ----------------------------------------------------------


class _ByteCount(TorchDispatchMode):
    """Dispatch mode: bytes of every aten op's tensor inputs and outputs,
    by op."""

    def __init__(self):
        super().__init__()
        self.by_op: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        n = sum(t.numel() * t.element_size()
                for t in tree_leaves((args, kwargs, out))
                if isinstance(t, torch.Tensor))
        key = str(func.overloadpacket)
        self.by_op[key] = self.by_op.get(key, 0) + n
        return out


def compiled_cost_report(fn: Callable[[], Any], top_k: int = 3) -> Dict[str, Any]:
    """One callable's cost, ranked: headline flops and bytes accessed, and
    the top-k per-op buckets (`flops:<op>` and `bytes:<op>`) by magnitude.
    `fn` runs once, eagerly, under the counters."""
    from torch.utils.flop_counter import FlopCounterMode

    flops = FlopCounterMode(display=False)
    nbytes = _ByteCount()
    with flops, nbytes:
        fn()
    by_flop: Dict[str, float] = {}
    for counts in flops.get_flop_counts().values():
        for op, n in counts.items():
            key = f"flops:{op}"
            by_flop[key] = max(by_flop.get(key, 0.0), float(n))
    entries: List[Dict[str, Any]] = [{"bucket": k, "value": v} for k, v in by_flop.items()]
    entries += [{"bucket": f"bytes:{op}", "value": float(n)} for op, n in nbytes.by_op.items()]
    buckets = sorted((b for b in entries if b["value"] > 0),
                     key=lambda b: (-b["value"], b["bucket"]))[: max(0, int(top_k))]
    return {
        "flops": float(flops.get_total_flops()),
        "bytes_accessed": float(sum(nbytes.by_op.values())),
        "top_buckets": buckets,
    }


def _clone(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree


def trainer_cost_report(trainer: Any, batch: Dict[str, Any], top_k: int = 3) -> Dict[str, Any]:
    """The cost buckets of a trainer's training step against `batch` (a
    feed-ready batch of the trained shape): one eager step on a copy of the
    train state, so the trainer's own state does not move."""
    assert trainer.state is not None, "init_state()/train() first"
    own = trainer.state
    trainer.state = _clone(own)
    try:
        report = compiled_cost_report(lambda: trainer._step_body(batch), top_k)
    finally:
        trainer.state = own
    return {
        "top_k": top_k,
        "generated_unix_s": int(time.time()),
        "executables": {"train_step": report},
    }


def write_report(report: Dict[str, Any], path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    return path
