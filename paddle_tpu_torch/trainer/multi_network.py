"""Alternating multi-network training, the GAN demo's class (counterpart of
`paddle_tpu/trainer/multi_network.py`; MultiNetwork.cpp,
GradientMachineMode.h and the v1_api_demo/gan host loop, gan_trainer.py).

Two or more networks share parameters by NAME; each phase marks the other
side's parameters `is_static` (its optimizer leaves them and their slots
untouched, `optim/optimizers.py`), and after a phase's step its updated
values are copied into the other phases' same-named parameters.

Each phase is the port's `SGDTrainer`, whose step runs on the card as its
own CUDA graph (`trainer/step_graph.py`), reading its own parameter
tensors. So the sharing copies values, device to device, into the other
phases' existing tensors (`copy_`), and never rebinds a state entry as the
JAX package does: a rebound tensor would be invisible to the captured
graph, which keeps reading the old storage."""

from __future__ import annotations

from typing import Any, Dict

import torch

from paddle_tpu_torch.trainer.trainer import SGDTrainer


class MultiNetworkTrainer:
    """Coordinate named SGDTrainers whose networks share parameters by name.

    Usage (the gan_conf.py pattern):
        mt = MultiNetworkTrainer({"dis": dis_trainer, "gen": gen_trainer})
        mt.init_state({"dis": dis_batch, "gen": gen_batch})
        cost = mt.step("dis", dis_batch)   # trains dis_*, syncs shared params
        cost = mt.step("gen", gen_batch)   # trains gen_*, syncs shared params
    """

    def __init__(self, trainers: Dict[str, SGDTrainer]):
        if not trainers:
            raise ValueError("need at least one named trainer")
        self.trainers = dict(trainers)

    def init_state(self, sample_batches: Dict[str, Any]) -> None:
        for name, tr in self.trainers.items():
            tr.init_state(sample_batches[name])
        # start from ONE consistent copy of every shared parameter: the first
        # trainer that owns a name wins (the demo copies gen->dis at start)
        seen: Dict[str, torch.Tensor] = {}
        with torch.no_grad():
            for tr in self.trainers.values():
                for k, v in tr.state["params"].items():
                    if k in seen:
                        v.copy_(seen[k])
                    else:
                        seen[k] = v

    def sync_shared(self, src: str) -> None:
        """copy_shared_parameters: copy src's current values into every other
        trainer's same-named parameter, in its own storage."""
        src_params = self.trainers[src].state["params"]
        with torch.no_grad():
            for name, tr in self.trainers.items():
                if name == src:
                    continue
                for k, v in tr.state["params"].items():
                    if k in src_params:
                        v.copy_(src_params[k])

    def step(self, phase: str, batch: Any, sync: bool = True) -> torch.Tensor:
        """One train step of `phase`'s network (a graph replay on the card
        after its first step), then its shared parameters go to the other
        phases. Returns the phase cost (a device scalar)."""
        cost = self.trainers[phase].step(batch)
        if sync:
            self.sync_shared(phase)
        return cost

    def state_of(self, phase: str):
        return self.trainers[phase].state
