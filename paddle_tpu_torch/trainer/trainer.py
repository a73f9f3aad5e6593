"""The training loop (counterpart of `SGDTrainer` in
`paddle_tpu/trainer/trainer.py`), the single-device path.

One `step(batch)` is the JAX package's compiled step run eagerly: the lr
comes from the schedule at the samples counter BEFORE the step, the forward
is `Network.apply` in train mode under the trainer's dtype policy, the
backward is autograd over the summed costs, the optimizer returns new
parameters, the states (batch norm's moving statistics) are replaced by the
forward's new ones, and the samples counter advances by the batch size.
`multi_step(batches)` runs K same-shape batches stacked on a leading axis
in one call (the counterpart of `make_multi_step`; a plain loop of `step`
here). `train(reader, num_passes, event_handler, steps_per_dispatch)` runs
passes over a reader that yields dicts of numpy arrays (`<slot>` and
`<slot>.lengths`) and fires BeginPass / BeginIteration / EndIteration /
EndPass; `test` averages the cost over a reader, weighted by batch size,
with the moving statistics.

`precision="f32"` (the default ambient policy) or `"bf16"` pins the dtype
policy when the trainer is built. Under f32 on the card the trainer turns
TF32 off for cuBLAS and cuDNN, process-wide: the reference's f32 is
`Precision.HIGHEST`, and autograd runs the backward's convs and matmuls
outside any context manager around the forward.

Not ported yet (ROADMAP.md): checkpoints, the divergence guard, remat,
the CUDA-graph capture of K steps, model averaging, the parallel updaters
and elastic resize."""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from paddle_tpu_torch.core import dtypes
from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.nn.graph import Layer, Network
from paddle_tpu_torch.optim import schedules
from paddle_tpu_torch.optim.optimizers import Optimizer
from paddle_tpu_torch.trainer.events import BeginIteration, BeginPass, EndIteration, EndPass

TrainState = Dict[str, Any]  # params / opt / states / samples
Batch = Mapping[str, Any]


class SGDTrainer:
    """v2 `trainer.SGD` analog. `device=None` means CUDA and raises when no
    card is present; the CPU runs only when asked for (`device="cpu"`)."""

    def __init__(self, cost: Union[Layer, Sequence[Layer]], optimizer: Optimizer,
                 seed: int = 0, device: DeviceLike = None,
                 precision: Optional[str] = None):
        costs = [cost] if isinstance(cost, Layer) else list(cost)
        self.cost_names = [c.name for c in costs]
        self.network = Network(costs)
        self.optimizer = optimizer
        self.schedule = schedules.build(optimizer.learning_rate)
        self.seed = seed
        self.device = resolve_device(device)
        self.policy = dtypes.get(precision) if precision is not None else dtypes.current()
        if self.policy.compute_dtype == torch.float32 and self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.state: Optional[TrainState] = None

    @property
    def precision(self) -> str:
        return self.policy.name

    # -- state ---------------------------------------------------------------
    def init_state(self, sample_batch: Batch) -> TrainState:
        """Create parameters (seeded from `seed`), states and optimizer
        slots."""
        params, states = self.network.init(sample_batch, seed=self.seed,
                                            device=self.device, policy=self.policy,
                                            with_states=True)
        self.optimizer.param_attrs = self.network.param_attrs
        self.state = {"params": params, "opt": self.optimizer.init_state(params),
                      "states": states, "samples": 0}
        return self.state

    def load_params(self, params: Mapping[str, Any]) -> None:
        """Replace the parameters' values (tensors or arrays, e.g. from
        `nn/convert.params_from_jax`); names and shapes must match."""
        self._load("params", params)

    def load_states(self, states: Mapping[str, Any]) -> None:
        """Replace the states' values (e.g. a JAX state dict through
        `nn/convert.params_from_jax`)."""
        self._load("states", states)

    def _load(self, kind: str, values: Mapping[str, Any]) -> None:
        assert self.state is not None, "call init_state() first"
        own = self.state[kind]
        if set(values) != set(own):
            raise KeyError(
                f"{kind} names differ: missing {sorted(set(own) - set(values))}, "
                f"unknown {sorted(set(values) - set(own))}")
        for name, value in values.items():
            v = torch.as_tensor(np.asarray(value) if not isinstance(value, torch.Tensor)
                                else value, dtype=torch.float32)
            if tuple(v.shape) != tuple(own[name].shape):
                raise ValueError(f"{name}: shape {tuple(v.shape)} != {tuple(own[name].shape)}")
            own[name] = v.to(self.device).clone()

    # -- one step ------------------------------------------------------------
    def _cost(self, params: Dict[str, torch.Tensor], batch: Batch,
              train: bool):
        """(summed f32 cost, new states) of a forward at `params`."""
        outs, states = self.network.apply(params, batch, self.state["states"],
                                          train=train, policy=self.policy)
        return sum(outs[c].value for c in self.cost_names).float(), states

    def cost_grads_and_states(self, batch: Batch):
        """(cost, {name: gradient}, new states) of a train-mode forward at
        the current parameters, no update."""
        names = list(self.state["params"])
        params = {k: v.detach().requires_grad_(True)
                  for k, v in self.state["params"].items()}
        cost, states = self._cost(params, batch, train=True)
        grads = torch.autograd.grad(cost, [params[k] for k in names])
        return cost.detach(), dict(zip(names, grads)), states

    def cost_and_grads(self, batch: Batch):
        """(cost, {name: gradient}) of a train-mode forward at the current
        parameters, no update."""
        cost, grads, _ = self.cost_grads_and_states(batch)
        return cost, grads

    def step(self, batch: Batch) -> torch.Tensor:
        """One training step on `batch`; returns the step's cost (a device
        scalar, no host sync)."""
        if self.state is None:
            self.init_state(batch)
        lr = self.schedule(self.state["samples"])
        cost, grads, states = self.cost_grads_and_states(batch)
        params, opt = self.optimizer.update(grads, self.state["opt"],
                                            self.state["params"], lr)
        self.state = {"params": params, "opt": opt,
                      "states": {k: v.detach() for k, v in states.items()},
                      "samples": self.state["samples"] + _batch_size(batch)}
        return cost

    def multi_step(self, batches: Batch) -> torch.Tensor:
        """K training steps in one call: every slot of `batches` is stacked
        on a leading K axis. Returns the K costs as one device tensor [K].
        The same updates as K calls of `step`, bit for bit."""
        k = _stack_size(batches)
        if self.state is None:
            self.init_state(_unstack(batches, 0))
        return torch.stack([self.step(_unstack(batches, i)) for i in range(k)])

    # -- loops -----------------------------------------------------------------
    def train(self, reader: Callable, num_passes: int = 1,
              event_handler: Optional[Callable] = None,
              steps_per_dispatch: int = 1) -> TrainState:
        """`num_passes` passes over `reader()`; EndPass metrics carry
        avg_cost (one host sync per pass), batches and pass_seconds.

        steps_per_dispatch=K > 1: K consecutive batches of one shape
        signature are stacked and run through `multi_step`; a shape change
        flushes the batches waiting through single steps, and so does the
        end of the pass for a remainder of fewer than K. Events fire per
        call: BeginIteration with the first batch id of the group,
        EndIteration with the last and the group's last cost. A K-grouped
        pass applies the same updates as K=1, and sums the same costs in
        the same order."""
        if steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got {steps_per_dispatch}")
        event_handler = event_handler or (lambda e: None)
        for pass_id in range(num_passes):
            event_handler(BeginPass(pass_id))
            t0 = time.time()
            cost_sum: Optional[torch.Tensor] = None
            n = 0
            pending: List[Any] = []  # (batch_id, batch) waiting for a group

            def dispatch(first: int, last: int, batch: Batch, k: int) -> None:
                nonlocal cost_sum, n
                event_handler(BeginIteration(pass_id, first))
                costs = [self.step(batch)] if k == 1 else self.multi_step(batch)
                for cost in costs:
                    cost_sum = cost if cost_sum is None else cost_sum + cost
                n += k
                event_handler(EndIteration(pass_id, last, costs[-1]))

            def flush() -> None:
                for batch_id, batch in pending:
                    dispatch(batch_id, batch_id, batch, 1)
                pending.clear()

            for batch_id, batch in enumerate(reader()):
                if steps_per_dispatch == 1:
                    dispatch(batch_id, batch_id, batch, 1)
                    continue
                if pending and _signature(batch) != _signature(pending[0][1]):
                    flush()
                pending.append((batch_id, batch))
                if len(pending) == steps_per_dispatch:
                    dispatch(pending[0][0], pending[-1][0],
                             _stack([b for _, b in pending]), steps_per_dispatch)
                    pending.clear()
            flush()
            event_handler(EndPass(pass_id, {
                "avg_cost": float(cost_sum) / n if n else 0.0,
                "batches": n, "pass_seconds": time.time() - t0,
            }))
        return self.state

    def test(self, reader: Callable) -> Dict[str, Any]:
        """Average cost over `reader()`, weighted by batch size; batch norm
        uses its moving statistics."""
        assert self.state is not None, "call train() or init_state() first"
        total, n = 0.0, 0
        with torch.no_grad():
            for batch in reader():
                bs = _batch_size(batch)
                total += float(self._cost(self.state["params"], batch, train=False)[0]) * bs
                n += bs
        return {"cost": total / max(n, 1), "samples": n}


def _signature(batch: Batch) -> tuple:
    """Shape and dtype of every slot: batches that stack."""
    return tuple(sorted((k, tuple(np.shape(v)), str(getattr(v, "dtype", type(v).__name__)))
                        for k, v in batch.items()))


def _stack(batches: List[Batch]) -> Dict[str, Any]:
    """Same-signature batches stacked on a new leading axis (torch tensors
    with torch, anything else with numpy)."""
    return {k: (torch.stack if isinstance(v, torch.Tensor) else np.stack)(
        [b[k] for b in batches]) for k, v in batches[0].items()}


def _unstack(batches: Batch, i: int) -> Dict[str, Any]:
    return {k: v[i] for k, v in batches.items()}


def _stack_size(batches: Batch) -> int:
    return int(np.shape(next(iter(batches.values())))[0])


def _batch_size(batch: Mapping[str, Any]) -> int:
    for k, v in batch.items():
        if not k.endswith(".lengths"):
            return int(np.shape(v)[0])
    raise ValueError("empty batch")
