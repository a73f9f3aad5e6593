"""A traced stretch: `torch.profiler` (CUPTI) over a callable, reduced to
what the per-layer readers and the breakdown read.

  kernels    device operation name -> [seconds, count] (kernels, copies,
             sets), summed over the stretch;
  busy_s     the union of the device intervals inside the stretch;
  window_s   the stretch's length from its first device operation to the
             end of its `portbench.stretch` span (the pass's start, host
             work before the first step that a window pays once, is left
             out);
  gaps       the idle intervals in that window, longest first, each
             labelled with the innermost host operation the issuing thread
             was in at the gap's middle (`cudaGraphLaunch`,
             `cudaStreamSynchronize`, ...; "host python" where it was in
             none).

The device and host events share the profiler's clock, so a gap is placed
against the host's work without a second clock."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import torch

STRETCH = "portbench.stretch"


@dataclasses.dataclass
class Trace:
    kernels: Dict[str, List[float]]
    busy_s: float
    window_s: float
    gaps: List[Tuple[str, float]]

    def seconds_where(self, match: Callable[[str], bool]) -> float:
        """Device seconds of the operations whose name `match` accepts."""
        return sum(s for name, (s, _) in self.kernels.items() if match(name))

    def top_ops(self, n: int = 10) -> List[List]:
        return [[name[:120], s] for name, (s, _) in
                sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:n]]

    def top_gaps(self, n: int = 10) -> List[List]:
        return [[label[:120], s] for label, s in self.gaps[:n]]


def profile_stretch(fn: Callable[[], None], device: torch.device) -> Trace:
    """Run `fn` (which ends in a device sync) under the profiler and reduce
    its events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(STRETCH):
            fn()
            torch.cuda.synchronize(device)
    events = prof.events()
    span = next(e for e in events if e.name == STRETCH and e.device_type == DeviceType.CPU)
    lo, hi = span.time_range.start, span.time_range.end  # microseconds
    kernels: Dict[str, List[float]] = {}
    intervals = []
    host = []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name == STRETCH or getattr(e, "is_user_annotation", False):
                continue  # the host span's shadow on the device timeline
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += (b - a) / 1e6
            k[1] += 1
            intervals.append((a, b))
        elif e.thread == span.thread and e is not span:
            host.append((a, b, e.name))
    intervals.sort()
    if intervals:
        lo = intervals[0][0]
    busy, gaps, cursor = 0.0, [], lo
    for a, b in intervals:
        if a > cursor:
            gaps.append((cursor, a))
        if b > cursor:
            busy += b - max(a, cursor)
            cursor = b
    if hi > cursor:
        gaps.append((cursor, hi))
    labelled = []
    for a, b in gaps:
        mid = (a + b) / 2
        inner = [h for h in host if h[0] <= mid <= h[1]]
        label = max(inner, key=lambda h: h[0])[2] if inner else "host python"
        labelled.append((label, (b - a) / 1e6))
    labelled.sort(key=lambda g: -g[1])
    return Trace(kernels=kernels, busy_s=busy / 1e6, window_s=(hi - lo) / 1e6, gaps=labelled)
