"""paddle.v2.trainer analog (counterpart of `paddle_tpu/v2/trainer.py`;
python/paddle/v2/trainer.py:24 SGD, .train :124).

`SGD` drives the port's `SGDTrainer` (the training step as one CUDA graph
on the card); the v2 reader / event / feeding protocol is the reference's:
the reader yields minibatches (lists of sample tuples), `feeding` maps data
layer names to tuple positions, and `event_handler` receives BeginPass /
BeginIteration / EndIteration / EndPass. Given `parameters`, the trainer's
state is built from the first batch and then takes their values by name
(a warm start, or a JAX package's tar through `Parameters.from_tar`); the
trained values come back to the host once, at the end of `train`.

The device is `device=`, else `paddle.init`'s (CUDA unless use_gpu=False).

`paddle.init(trainer_count=N)` with N > 1 is data parallelism
(`parallel/`). The JAX package runs N devices in one process; the port
runs one process (or thread) per rank, so `SGD` must be built in each rank
of an N-rank group: the default group `parallel.distributed.initialize`
brought up, or `group=` (e.g. a gloo group of N threads). It then trains
through `DataParallel(make_mesh({"data": N}))`, every rank reading the
same reader and keeping its own rows; without such a group it raises and
says how to launch the ranks."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

from paddle_tpu_torch.core.init_ctx import flags
from paddle_tpu_torch.device import DeviceLike
from paddle_tpu_torch.trainer.trainer import SGDTrainer
from paddle_tpu_torch.v2.event import TestResult
from paddle_tpu_torch.v2.parameters import Parameters
from paddle_tpu_torch.v2.topology import Topology


class SGD:
    def __init__(self, cost, parameters: Optional[Parameters] = None,
                 update_equation=None, extra_layers: Sequence = (),
                 is_local: bool = True, device: DeviceLike = None, group=None,
                 **_compat):
        from paddle_tpu_torch.v2 import optimizer as v2opt

        if update_equation is None:
            update_equation = v2opt.Momentum(learning_rate=0.01)
        device = device or flags().device
        parallel = _data_parallel(flags().trainer_count, group, device)
        if parallel is not None:
            device = parallel.device
        self.topology = Topology(cost, extra_layers=extra_layers)
        self.parameters = parameters
        costs = cost if isinstance(cost, (list, tuple)) else [cost]
        self._trainer = SGDTrainer(
            list(costs), update_equation.optimizer, seed=flags().seed,
            device=device, extra_outputs=list(extra_layers),
            schedule=update_equation.schedule,
            model_average=update_equation.model_average, parallel=parallel)

    @property
    def trainer(self) -> SGDTrainer:
        return self._trainer

    # -- API ----------------------------------------------------------------------
    def train(self, reader: Callable, num_passes: int = 1,
              event_handler: Optional[Callable] = None,
              feeding: Optional[Dict[str, int]] = None):
        feeder = self.topology.make_feeder(feeding)
        if self.parameters is not None and self._trainer.state is None:
            self._seed_state_from_parameters(reader, feeder)
        state = self._trainer.train(reader, num_passes=num_passes,
                                    event_handler=event_handler, feeder=feeder)
        self._sync_parameters_out()
        return state

    def test(self, reader: Callable, feeding: Optional[Dict[str, int]] = None) -> TestResult:
        feeder = self.topology.make_feeder(feeding)
        if self._trainer.state is None:
            if self.parameters is None or not len(self.parameters):
                raise ValueError(
                    "test() before train(): pass trained Parameters to SGD(...) "
                    "(e.g. Parameters.from_tar) or call train() first")
            self._seed_state_from_parameters(reader, feeder)
        res = self._trainer.test(reader, feeder)
        return TestResult(pass_id=-1, cost=res["cost"], metrics=res)

    def save_parameter_to_tar(self, f) -> None:
        self._sync_parameters_out()
        assert self.parameters is not None
        self.parameters.to_tar(f)

    # -- internals --------------------------------------------------------------
    def _seed_state_from_parameters(self, reader, feeder) -> None:
        """Build the trainer's state from the first batch, then copy the
        given Parameters' values over it by name."""
        self._trainer.init_state(feeder(next(iter(reader()))))
        own = self._trainer.canonical_params()
        self._trainer.load_params({k: self.parameters.get(k) if k in self.parameters
                                   else v for k, v in own.items()})

    def _sync_parameters_out(self) -> None:
        if self._trainer.state is None:
            return
        if self.parameters is None:
            self.parameters = Parameters()
        for k, v in self._trainer.canonical_params().items():
            self.parameters.set(k, v.detach().cpu().numpy())


def _data_parallel(trainer_count: int, group, device):
    """The DataParallel plan of `paddle.init(trainer_count=N)`, or None for
    one trainer."""
    n = int(trainer_count or 1)
    if n <= 1:
        return None
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import DataParallel, make_mesh

    if group is None and not (dist.is_initialized() and dist.get_world_size() == n):
        raise RuntimeError(
            f"paddle.init(trainer_count={n}): the port runs one process per rank (the JAX "
            f"package runs {n} devices in one process). Start {n} processes and call "
            "paddle_tpu_torch.parallel.distributed.initialize(coordinator_address, "
            f"{n}, rank) in each before building SGD (or pass group=, a process group "
            f"of {n} ranks), or train with `python -m paddle_tpu_torch train "
            f"--trainer_count={n}`, which starts the ranks itself")
    return DataParallel(make_mesh({"data": n}, group=group, device=device))
