"""The comparison that decides `correct` for a training cell.

Both sides run the same first three steps from the same weights on the
same batches. The numbers read, each compared where `cells/<cell>.json` gives it a
limit:

  loss_gap       the widest of the three steps' |L_prog - L_ref| / |L_ref|;
  loss1_gap      the same of the first step alone (one forward from the
                 same weights: no trajectory to drift);
  grad_gap       the worst leaf of the first step's gradient as the
                 optimizer got it: | |g_prog| - |g_ref| | / max(|g_ref|,
                 median leaf |g_ref|);
  grad_gap_med   the median leaf of the same;
  delta_gap      the worst leaf of the change after three steps
                 (parameters and states, such as batch norm's moving
                 statistics), the same measure;
  delta_gap_med  the median leaf of the same.
A parameter whose reference gradient is under a thousandth of the median
leaf's moves by round-off alone (a bias under a normalisation) and is
left out of the change.

On a data-parallel cell every rank's numbers are held against the
reference, and the worst rank counts. Norms are taken in f64."""

from __future__ import annotations

import math
import statistics
from typing import Any, Dict, List, Mapping, Optional

import torch

STILL = 1e-3  # a leaf whose reference gradient is under STILL x the median's


def norms(tree: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in tree.items()}


def diff_norms(after: Mapping[str, torch.Tensor],
               before: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(after[k].detach().double()
                                              - before[k].detach().double()))
            for k in before}


def readings(losses: List[float], first_grad: Mapping[str, torch.Tensor],
             params: Mapping[str, torch.Tensor], states: Mapping[str, torch.Tensor],
             params0: Mapping[str, torch.Tensor],
             states0: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """One side's readings: its losses, the first gradient's leaf norms and
    the leaf norms of the change after the steps."""
    delta = diff_norms(params, params0)
    delta.update({f"state:{k}": v for k, v in diff_norms(states, states0).items()})
    return {"losses": [float(x) for x in losses], "grad": norms(first_grad), "delta": delta}


def _finite(x: float) -> float:
    """A NaN reading compares as the worst there is."""
    return x if math.isfinite(x) else math.inf


def _leaf_gaps(got: Mapping[str, float], want: Mapping[str, float], keys) -> Dict[str, float]:
    keys = list(keys)
    med = statistics.median(want[k] for k in keys)
    return {k: _finite(abs(got[k] - want[k]) / max(want[k], med, 1e-30)) for k in keys}


NAMES = ("loss_gap", "loss1_gap", "grad_gap", "grad_gap_med", "delta_gap", "delta_gap_med")


def numbers(prog: Mapping[str, Any], ref: Mapping[str, Any]) -> Dict[str, Any]:
    """The numbers of one side against the reference, with the worst leaf
    of each for the record."""
    losses = [_finite(abs(a - b) / abs(b)) for a, b in zip(prog["losses"], ref["losses"])]
    grads = _leaf_gaps(prog["grad"], ref["grad"], ref["grad"])
    med_g = statistics.median(ref["grad"].values())
    moved = [k for k in ref["delta"]
             if k.startswith("state:") or ref["grad"][k] >= STILL * med_g]
    deltas = _leaf_gaps(prog["delta"], ref["delta"], moved)
    return {"loss_gap": max(losses), "loss1_gap": losses[0],
            "grad_gap": max(grads.values()), "grad_gap_med": statistics.median(grads.values()),
            "delta_gap": max(deltas.values()),
            "delta_gap_med": statistics.median(deltas.values()),
            "leaves": {"grad_gap": max(grads, key=grads.get),
                       "delta_gap": max(deltas, key=deltas.get),
                       "left_out": sorted(set(ref["delta"]) - set(moved))}}


def worst_over(sides: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The widest of each number over several sides (ranks)."""
    out = dict(max(sides, key=lambda s: s["delta_gap"]))
    for k in NAMES:
        out[k] = max(s[k] for s in sides)
    return out


def judge(nums: Mapping[str, Any], limits: Optional[Mapping[str, float]]) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number that has a limit
    finite and at or under it. No limits: not correct."""
    compared = {k: {"value": nums[k], "limit": (limits or {}).get(k)} for k in NAMES
                if limits is None or k in limits}
    ok = limits is not None and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in compared.values())
    return ok, compared
