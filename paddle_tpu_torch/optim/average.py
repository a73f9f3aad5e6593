"""Parameter averaging (counterpart of `paddle_tpu/optim/average.py`; the
reference's AverageOptimizer): an averaged copy of the parameters beside
the optimizer, the incremental mean over a window that grows to
`max_average_window` updates; at test time the averages stand in for the
parameters.

The state is {"avg": {name: f32 tensor}, "n": 0-d f32 tensor}, or {} when
averaging is off (`average_window` 0), as the JAX package lays it out.
`update` writes the new averages and `n` into their own storage (under the
divergence guard's `ok`, only where it holds), so it runs inside the
trainer's captured step."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from paddle_tpu_torch.optim.optimizers import write_into

Params = Dict[str, torch.Tensor]


class ModelAverage:
    def __init__(self, average_window: float = 0.0, max_average_window: int = 0):
        self.average_window = average_window
        self.max_average_window = max_average_window or 2 ** 31 - 1
        self.enabled = average_window > 0

    def init_state(self, params: Params) -> Dict[str, Any]:
        if not self.enabled:
            return {}
        dev = next(iter(params.values())).device
        return {"avg": {k: p.detach().float().clone() for k, p in params.items()},
                "n": torch.zeros((), dtype=torch.float32, device=dev)}

    @torch.no_grad()
    def update(self, state: Dict[str, Any], params: Params,
               ok: Optional[torch.Tensor] = None) -> None:
        """Fold the (new) parameters into the averages, in place."""
        if not self.enabled:
            return
        n = torch.clamp_max(state["n"] + 1.0, float(self.max_average_window))
        w = 1.0 / n
        for k, a in state["avg"].items():
            write_into(a, (1.0 - w) * a + w * params[k].float(), ok)
        write_into(state["n"], n, ok)

    def averaged_params(self, state: Dict[str, Any], params: Params) -> Params:
        """The averages in the parameters' dtypes (the parameters themselves
        when averaging is off)."""
        if not self.enabled or not state:
            return params
        return {k: state["avg"][k].to(p.dtype) for k, p in params.items()}
