"""The arithmetic the per-layer readers (`metrics/<metric>.py`) share.
Each takes a `harness.Run` and returns a number, or None where the run
holds nothing to read (the harness then leaves the metric out)."""

from __future__ import annotations

from typing import Optional


def mfu(run) -> Optional[float]:
    """The window's model FLOPs a second a card over the card's peak at
    the configuration's precision, in %. Read from the traced run's window,
    outside the profiler's stretch."""
    if not run.card or run.window_s <= 0:
        return None
    peak = run.card[run.cell.config["precision"]]
    return 100.0 * run.window_flops / run.window_s / run.world / peak


def idle_share(run) -> Optional[float]:
    """The traced stretch's share with no operation on the card, in %."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (run.trace.window_s - run.trace.busy_s) / run.trace.window_s


def device_share(run, fragment: str) -> Optional[float]:
    """Device time of the operations whose name holds `fragment` over the
    device's busy time in the traced stretch, in %; None where none ran."""
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    secs = run.trace.seconds_where(lambda name: fragment in name.lower())
    return 100.0 * secs / run.trace.busy_s if secs > 0 else None
