"""The training loop (counterpart of `SGDTrainer` in
`paddle_tpu/trainer/trainer.py`), the single-device f32 path.

One `step(batch)` is the JAX package's compiled step run eagerly: the lr
comes from the schedule at the samples counter BEFORE the step, the forward
is `Network.apply`, the backward is autograd over the summed costs, the
optimizer returns new parameters, and the samples counter advances by the
batch size. `train(reader, num_passes, event_handler)` runs passes over a
reader that yields dicts of numpy arrays (`<slot>` and `<slot>.lengths`)
and fires BeginPass / BeginIteration / EndIteration / EndPass; `test`
averages the cost over a reader, weighted by batch size.

Not ported yet (ROADMAP.md): checkpoints, the divergence guard,
`steps_per_dispatch`, the bf16 policy and remat, model averaging, the
parallel updaters and elastic resize."""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.nn.graph import Layer, Network
from paddle_tpu_torch.optim import schedules
from paddle_tpu_torch.optim.optimizers import Optimizer
from paddle_tpu_torch.trainer.events import BeginIteration, BeginPass, EndIteration, EndPass

TrainState = Dict[str, Any]  # params / opt / samples


class SGDTrainer:
    """v2 `trainer.SGD` analog. `device=None` means CUDA and raises when no
    card is present; the CPU runs only when asked for (`device="cpu"`)."""

    def __init__(self, cost: Union[Layer, Sequence[Layer]], optimizer: Optimizer,
                 seed: int = 0, device: DeviceLike = None):
        costs = [cost] if isinstance(cost, Layer) else list(cost)
        self.cost_names = [c.name for c in costs]
        self.network = Network(costs)
        self.optimizer = optimizer
        self.schedule = schedules.build(optimizer.learning_rate)
        self.seed = seed
        self.device = resolve_device(device)
        self.state: Optional[TrainState] = None

    # -- state ---------------------------------------------------------------
    def init_state(self, sample_batch: Mapping[str, Any]) -> TrainState:
        """Create parameters (seeded from `seed`) and optimizer slots."""
        params = self.network.init(sample_batch, seed=self.seed, device=self.device)
        self.optimizer.param_attrs = self.network.param_attrs
        self.state = {"params": params, "opt": self.optimizer.init_state(params),
                      "samples": 0}
        return self.state

    def load_params(self, params: Mapping[str, Any]) -> None:
        """Replace the parameters' values (tensors or arrays, e.g. from
        `nn/convert.params_from_jax`); names and shapes must match."""
        assert self.state is not None, "call init_state() first"
        own = self.state["params"]
        if set(params) != set(own):
            raise KeyError(
                f"parameter names differ: missing {sorted(set(own) - set(params))}, "
                f"unknown {sorted(set(params) - set(own))}")
        for name, value in params.items():
            v = torch.as_tensor(np.asarray(value) if not isinstance(value, torch.Tensor)
                                else value, dtype=torch.float32)
            if tuple(v.shape) != tuple(own[name].shape):
                raise ValueError(f"{name}: shape {tuple(v.shape)} != {tuple(own[name].shape)}")
            own[name] = v.to(self.device).clone()

    # -- one step ------------------------------------------------------------
    def _cost(self, params: Dict[str, torch.Tensor], batch: Mapping[str, Any]) -> torch.Tensor:
        outs = self.network.apply(params, batch)
        return sum(outs[c].value for c in self.cost_names).float()

    def cost_and_grads(self, batch: Mapping[str, Any]):
        """(cost, {name: gradient}) at the current parameters, no update."""
        names = list(self.state["params"])
        params = {k: v.detach().requires_grad_(True)
                  for k, v in self.state["params"].items()}
        cost = self._cost(params, batch)
        grads = torch.autograd.grad(cost, [params[k] for k in names])
        return cost.detach(), dict(zip(names, grads))

    def step(self, batch: Mapping[str, Any]) -> torch.Tensor:
        """One training step on `batch`; returns the step's cost (a device
        scalar, no host sync)."""
        if self.state is None:
            self.init_state(batch)
        lr = self.schedule(self.state["samples"])
        cost, grads = self.cost_and_grads(batch)
        params, opt = self.optimizer.update(grads, self.state["opt"],
                                            self.state["params"], lr)
        self.state = {"params": params, "opt": opt,
                      "samples": self.state["samples"] + _batch_size(batch)}
        return cost

    # -- loops -----------------------------------------------------------------
    def train(self, reader: Callable, num_passes: int = 1,
              event_handler: Optional[Callable] = None) -> TrainState:
        """`num_passes` passes over `reader()`; EndPass metrics carry
        avg_cost (one host sync per pass), batches and pass_seconds."""
        event_handler = event_handler or (lambda e: None)
        for pass_id in range(num_passes):
            event_handler(BeginPass(pass_id))
            t0 = time.time()
            cost_sum = None
            n = 0
            for batch_id, batch in enumerate(reader()):
                event_handler(BeginIteration(pass_id, batch_id))
                cost = self.step(batch)
                cost_sum = cost if cost_sum is None else cost_sum + cost
                n += 1
                event_handler(EndIteration(pass_id, batch_id, cost))
            event_handler(EndPass(pass_id, {
                "avg_cost": float(cost_sum) / n if n else 0.0,
                "batches": n, "pass_seconds": time.time() - t0,
            }))
        return self.state

    def test(self, reader: Callable) -> Dict[str, Any]:
        """Average cost over `reader()`, weighted by batch size."""
        assert self.state is not None, "call train() or init_state() first"
        total, n = 0.0, 0
        with torch.no_grad():
            for batch in reader():
                bs = _batch_size(batch)
                total += float(self._cost(self.state["params"], batch)) * bs
                n += bs
        return {"cost": total / max(n, 1), "samples": n}


def _batch_size(batch: Mapping[str, Any]) -> int:
    for k, v in batch.items():
        if not k.endswith(".lengths"):
            return int(np.shape(v)[0])
    raise ValueError("empty batch")
