"""The training loop (counterpart of `SGDTrainer` in
`paddle_tpu/trainer/trainer.py`), the single-device path.

One step is the JAX package's compiled step, and its whole train state
lives on the device: the parameters, the optimizer's slots and `t`, the
states (batch norm's moving statistics), the model averages, the samples
counter (int32), `lr_scale`, the threefry key `rng`, the divergence count
`diverged` and the guard's pass-cost accumulator `cost_acc`. A step reads
the lr as `schedule(samples) * lr_scale` and its random key as
`fold_in(rng, samples)` on the device; the forward is `Network.apply` in
train mode under the trainer's dtype policy (and its `remat` policy), the
backward is autograd over the summed costs; then the optimizer writes the
new parameters, slots and `t` into their own storage, the model average
folds them in, the new states are copied into theirs, and the samples
counter advances by the batch size. With a `divergence_policy`, a step
whose cost is NaN/Inf writes none of that (every leaf is written as
`where(finite, new, old)`) and adds one to `diverged`; the host reads the
count only at a guard poll, every `guard_check_every` steps and at pass
end, and then skips, rolls back to the newest checkpoint with the lr
halved, or raises `DivergenceError`. `multi_step(batches)` runs K
same-shape batches stacked on a leading axis in one dispatch (the
counterpart of `make_multi_step`).

On the card the first `step` or `multi_step` of each batch signature runs
eagerly, as a real step and as the warm-up (kernel builds and plans,
cuBLAS's workspace); then the trainer captures that dispatch as one CUDA
graph (`step_graph.py`) and every later dispatch of the signature copies
its batch into the graph's static inputs and replays it. There is no switch
that turns the graph off, and a failed capture raises. The CPU runs every
step eagerly: it has no graphs.

`train(reader, num_passes, event_handler, feeder, test_reader, save_dir,
log_period, auto_resume, keep_last_n, steps_per_dispatch, async_checkpoint,
remat)`
runs passes over a reader of batches: dicts of arrays or tensors
(`<slot>` and `<slot>.lengths`; a `data.DevicePrefetcher` yields them on
the device, and a `StackedBatch` of K runs as one K-step dispatch), or
lists of samples that `feeder` (a `data.DataFeeder`) turns into them; it
logs the cost of the dispatch that crosses each `log_period` mark
("pass %d batch %d cost=%.6f", read one dispatch later from a
non-blocking copy, so the log costs no sync of its own); it fires
BeginPass / BeginIteration / EndIteration (with the
`extra_outputs`' values) / EndPass, tests on `test_reader` at each pass
end, and with `save_dir` writes a checkpoint there at each pass end
(`save`; the JAX package's pass directory, `checkpoint.py`). `auto_resume`
restores the newest valid checkpoint under `save_dir` and continues with
the pass after it, or, after a preemption drain's mid-pass checkpoint,
with the rest of that pass. A preemption notice (`core/preempt.py`: a
signal, or the `preempt` fault site) drains at the next dispatch
boundary: a mid-pass checkpoint, then `Preempted`. `test` averages the
cost over a reader, weighted by batch size, with the moving statistics and
the model-averaged parameters.

`precision="f32"` (the default ambient policy) or `"bf16"` pins the dtype
policy when the trainer is built. Under f32 on the card the trainer turns
TF32 off for cuBLAS and cuDNN, process-wide: the reference's f32 is
`Precision.HIGHEST`, and autograd runs the backward's convs and matmuls
outside any context manager around the forward.

Data parallelism (`parallel=DataParallel(make_mesh({"data": n}))`, one
rank per process or, in the tests, per thread): every rank reads the same
global batch, pads it to a multiple of n (a row mask and the global real
row count ride beside it) and keeps its own rows; the forward runs on them
under the mesh (synchronized batch norm, costs over the global row count,
the global batch's random bits); the updater (`updater=`, or the one
`shard_update` / `grad_compression` select: replicated, zero1, zero2,
zero3) reduces the gradients and the cost over the mesh inside the step,
so on the card the collectives are captured in the step's graph. The
divergence guard reads the global cost, so a diverged step reverts on
every rank; zero2's `multi_step` merges the K batches into one accumulated
update. On a mesh with a `model` axis (`make_tp_mesh`), a parameter whose
logical axes resolve to it is stored as this rank's slice and gathered over
the axis for the step's compute (`parallel/updaters.py`). Checkpoints hold
the canonical layout (the updater's seams), written by rank 0, and record
the world size; they load under any mode, world size and mesh.

An elastic-resize request (`core/preempt.request_resize`, set by a
master's resize epoch through `runtime/master.ResizeClient`) is taken at
the next dispatch boundary, as the JAX package takes it: the buffered K-step
batches flush on the old mesh, a durable mid-pass checkpoint is written
(with `save_dir`), the fleet barrier (`resize_barrier`) decides the world,
the state re-shards onto it (`resize_to`) and the interrupted pass goes on
with the very next batch; a mesh-less trainer ignores the request with the
JAX package's warning. The JAX package re-meshes one process's devices;
here ranks leave and join a new group (ROADMAP.md §3 difference 27). Only
rank 0 reads the request and calls the barrier (one member a job): with
`train(elastic=True)` it publishes its decision for every boundary in the
job's store, and every other rank reads it there before it dispatches, so
all drain at the same boundary with no collective or host sync added to
the step; the barrier's world reaches them by a broadcast over the old
group. `resize_to` gathers the canonical state on the old group, fires
`reshard_kill`, brings the new world together (`distributed.rendezvous`:
rank 0 announces the attempt, joiners count in; a world that cannot be
built is rejected there on every rank and training goes on, bitwise, on
the old group), then drops the captured graphs, closes the old mesh,
re-lays the state for the new one and, on a grow, broadcasts it from rank 0
to the joiners. A rank outside the new world leaves: its `train()` returns
with `left` set. A joiner (`train(join=plan)`, the plan from
`distributed.join`) receives the state, replays the reader past the
interrupted batch, as auto-resume does, and trains on. EndPass carries
`resize_epochs` and `resizes` (each epoch's drain / reshard / resume
seconds).

Run it on the CPU: `JAX_PLATFORMS=cpu python -m pytest
tests/test_torch_resize.py` (gloo rank threads, joiners started at the
epoch, against the JAX package's `tests/test_resize.py` runs); on one card
`chip_smoke.py` phase 52; across four cards `tools/elastic_nccl_train.py`."""

from __future__ import annotations

import gc
import logging
import os
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from paddle_tpu_torch.core import dtypes, faults, preempt, prng, stats
from paddle_tpu_torch.core import remat as remat_mod
from paddle_tpu_torch.obs import metrics as obs_metrics
from paddle_tpu_torch.obs import trace
from paddle_tpu_torch.data.pipeline import StackedBatch
from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.nn.graph import SAMPLE_COUNT_KEY, SAMPLE_MASK_KEY, Layer, Network
from paddle_tpu_torch.optim import schedules
from paddle_tpu_torch.optim.average import ModelAverage
from paddle_tpu_torch.optim.optimizers import Optimizer, write_into
from paddle_tpu_torch.trainer import checkpoint as ckpt
from paddle_tpu_torch.trainer.events import BeginIteration, BeginPass, EndIteration, EndPass
from paddle_tpu_torch.trainer.step_graph import StepGraph

log = logging.getLogger("paddle_tpu_torch.trainer")

TrainState = Dict[str, Any]  # params / opt / states / avg / samples / lr_scale / ...
Batch = Mapping[str, Any]

DIVERGENCE_POLICIES = ("skip_batch", "rollback", "raise")
SHARD_UPDATE_MODES = ("zero1", "zero2", "zero3")
_RESERVED = (SAMPLE_MASK_KEY, SAMPLE_COUNT_KEY)


def _resolve_shard_mode(shard_update) -> Optional[str]:
    """SGDTrainer(shard_update=...): booleans are the zero1 alias, or one of
    SHARD_UPDATE_MODES."""
    if shard_update in (False, None, "none", "0", "false"):
        return None
    if shard_update in (True, "true", "1"):
        return "zero1"
    if shard_update in SHARD_UPDATE_MODES:
        return shard_update
    raise ValueError(f"shard_update must be a bool or one of {SHARD_UPDATE_MODES}, got "
                     f"{shard_update!r}")
REMAT_POLICIES = remat_mod.POLICIES


class DivergenceError(RuntimeError):
    """Raised by divergence_policy="raise" when a step cost goes NaN/Inf."""


class Preempted(RuntimeError):
    """Raised by train() after a preemption drain (`core/preempt.py`): the
    step in flight finished and, given a save_dir and grace left, a
    CRC-valid mid-pass checkpoint was written. A restart with
    auto_resume=True continues from exactly this batch boundary."""

    def __init__(self, pass_id: int, batches_done: int, checkpoint_dir: Optional[str],
                 reason: Optional[str] = None):
        self.pass_id = pass_id
        self.batches_done = batches_done
        self.checkpoint_dir = checkpoint_dir
        self.reason = reason
        where = f"checkpoint {checkpoint_dir}" if checkpoint_dir else "no checkpoint written"
        super().__init__(f"preempted ({reason or 'signal'}) at pass {pass_id} after "
                         f"{batches_done} batch(es); {where}")


class _LeftJob(Exception):
    """Unwinds the train loop of a rank that a shrinking resize left out."""


# boundary decisions an elastic trainer's rank 0 publishes ("go": dispatch)
_GO, _RESIZE, _PREEMPT = "go", "resize", "preempt"
# boundaries whose decisions stay in the job's store: ranks' hosts are never
# this many dispatches apart (a launch queue is far shorter)
_KEEP_BOUNDARIES = 4096


class SGDTrainer:
    """v2 `trainer.SGD` analog. `device=None` means CUDA and raises when no
    card is present; the CPU runs only when asked for (`device="cpu"`).

    extra_outputs: layers whose values each step hands to EndIteration's
    `metrics`. schedule: lr(samples) (`optim/schedules.py`; default the
    optimizer's constant lr). model_average: a `ModelAverage`, whose
    averages `test()` evaluates. remat: "none" | "dots" | "conv_only" |
    "full" (`core/remat.py`). divergence_policy: None (no guard) |
    "skip_batch" | "rollback" | "raise", polled every guard_check_every
    steps. parallel: a `parallel.DataParallel` (its mesh's device is the
    trainer's); updater: a `parallel.ParameterUpdater`, else the one
    `shard_update` (False | True = "zero1" | "zero1" | "zero2" | "zero3")
    and `grad_compression` ("none" | "bf16" | "int8") select."""

    def __init__(self, cost: Union[Layer, Sequence[Layer]], optimizer: Optimizer,
                 seed: int = 0, device: DeviceLike = None,
                 precision: Optional[str] = None, *,
                 extra_outputs: Sequence[Layer] = (),
                 schedule: Optional[schedules.Schedule] = None,
                 model_average: Optional[ModelAverage] = None,
                 remat: Optional[str] = None,
                 divergence_policy: Optional[str] = None,
                 guard_check_every: int = 16,
                 parallel: Optional[Any] = None,
                 updater: Optional[Any] = None,
                 shard_update: Union[bool, str, None] = False,
                 grad_compression: Optional[str] = None):
        costs = [cost] if isinstance(cost, Layer) else list(cost)
        self.cost_names = [c.name for c in costs]
        self.extra_names = [e.name for e in extra_outputs]
        self.network = Network(costs + list(extra_outputs))
        self.optimizer = optimizer
        self.schedule = schedule or schedules.build(optimizer.learning_rate)
        self.model_average = model_average or ModelAverage(0.0)
        self.remat = remat_mod.resolve(remat)
        if divergence_policy is not None and divergence_policy not in DIVERGENCE_POLICIES:
            raise ValueError(f"divergence_policy must be one of {DIVERGENCE_POLICIES} or "
                             f"None, got {divergence_policy!r}")
        if guard_check_every < 1:
            raise ValueError(f"guard_check_every must be >= 1, got {guard_check_every}")
        self.divergence_policy = divergence_policy
        self.guard_check_every = guard_check_every
        self.seed = seed
        self.shard_update = _resolve_shard_mode(shard_update)
        compressed = grad_compression not in (None, "none")
        if (self.shard_update or compressed) and parallel is None and updater is None:
            raise ValueError("shard_update/grad_compression need a DataParallel mesh "
                             "(SGDTrainer(parallel=...)): there is no data axis to shard "
                             "the update over")
        if compressed and not self.shard_update:
            raise ValueError("grad_compression wraps the sharded update's reduce-scatter "
                             "— pass shard_update=True with it")
        if updater is not None and (self.shard_update or compressed):
            raise ValueError("shard_update/grad_compression select the built-in "
                             "ShardedUpdater and cannot combine with an explicit updater= "
                             "— construct ShardedUpdater(optimizer, parallel, "
                             "compression=...) yourself instead")
        if updater is None:
            from paddle_tpu_torch.parallel import updaters as upd

            if parallel is not None and self.shard_update:
                cls = {"zero1": upd.ShardedUpdater, "zero2": upd.Zero2Updater,
                       "zero3": upd.Zero3Updater}[self.shard_update]
                updater = cls(optimizer, parallel, compression=grad_compression or "none")
            elif parallel is not None:
                updater = upd.IciAllReduceUpdater(optimizer, parallel)
            else:
                updater = upd.SgdLocalUpdater(optimizer)
        self.updater = updater
        self.parallel = parallel
        self.mesh = parallel.mesh if parallel is not None else None
        if self.mesh is not None:
            if device is None:
                device = self.mesh.device
            elif resolve_device(device) != self.mesh.device:
                raise ValueError(f"device {device} is not the mesh's {self.mesh.device}")
        self.device = resolve_device(device)
        if self.mesh is not None and self.device.type == "cuda" and self.mesh.backend != "nccl":
            from paddle_tpu_torch.parallel.mesh import UncapturableGroupError

            raise UncapturableGroupError(
                f"the mesh's {self.mesh.backend} group holds CUDA tensors: its "
                "collectives cannot join the training step's CUDA graph; build the mesh "
                "over NCCL on the card (gloo is the CPU's)")
        self.policy = dtypes.get(precision) if precision is not None else dtypes.current()
        if self.policy.compute_dtype == torch.float32 and self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.state: Optional[TrainState] = None
        # (K, batch signature) -> the captured dispatch (CUDA only)
        self.graphs: Dict[tuple, StepGraph] = {}
        # host mirror of state["diverged"] as of the last guard poll
        self._diverged_seen = 0
        self._ckpt_writer: Optional[ckpt.AsyncCheckpointer] = None
        self._pinned: Dict[str, torch.Tensor] = {}
        self._pending_load: Optional[tuple] = None
        # (save_dir, pass_id) of the newest checkpoint written or loaded:
        # a rollback needs no CRC scan to find it
        self._known_good_pass: Optional[tuple] = None
        # elastic resize: the job's store (resolved once), the attempt that
        # built the current group and the boundary count on it; the epochs
        # completed, the one awaiting its first dispatch, where a rank left
        self._job_store: Optional[Any] = None
        self._attempt = 0
        self._bseq = 0
        self._position = (-1, -1)
        self._resized = False
        self._resize_log: List[Dict[str, Any]] = []
        self._resize_mark: Optional[Dict[str, Any]] = None
        self.left: Optional[Dict[str, Any]] = None
        # what the boundary agreement cost: boundaries, host seconds
        self.agreement = {"boundaries": 0, "seconds": 0.0}

    @property
    def precision(self) -> str:
        return self.policy.name

    # -- state ---------------------------------------------------------------
    def init_state(self, sample_batch: Batch) -> TrainState:
        """Create parameters (seeded from `seed`), states, optimizer slots,
        averages and the counters; drops every captured graph (they point
        at the old state)."""
        params, states = self.network.init(sample_batch, seed=self.seed,
                                            device=self.device, policy=self.policy,
                                            with_states=True)
        self.optimizer.param_attrs = self.network.param_attrs
        dev = self.device
        if self.parallel is not None and not self.parallel.param_attrs:
            self.parallel.param_attrs = self.network.param_attrs
        # the updater owns the layouts: canonical by default, [1, chunk]
        # rows of the flat view under ZeRO (the slots; zero3's parameters)
        opt_state = self.updater.init_opt_state(params)
        params = self.updater.params_from_canonical(params)
        self.state = {
            "params": params, "opt": opt_state, "states": states,
            "avg": self.model_average.init_state(params),
            # int32: f32 would stop counting past 2^24 samples
            "samples": torch.zeros((), dtype=torch.int32, device=dev),
            "lr_scale": torch.ones((), dtype=torch.float32, device=dev),
            "diverged": torch.zeros((), dtype=torch.int32, device=dev),
            "cost_acc": torch.zeros((), dtype=torch.float32, device=dev),
            "rng": prng.PRNGKey(self.seed, dev),
        }
        self._diverged_seen = 0
        self.graphs.clear()
        return self.state

    def set_lr_scale(self, value: float) -> None:
        """Write the lr multiplier into its device tensor (the graphs read
        it there; a rollback halves it)."""
        assert self.state is not None, "call init_state() first"
        self.state["lr_scale"].fill_(float(value))

    def load_params(self, params: Mapping[str, Any]) -> None:
        """Replace the parameters' values (tensors or arrays, e.g. from
        `nn/convert.params_from_jax`); names and shapes must match. The
        values are copied into the parameters' own storage (under zero3,
        this rank's rows of them; on a model axis, this rank's slice)."""
        self._check_names("params", params)
        values = {k: (v if isinstance(v, torch.Tensor)
                      else torch.from_numpy(np.array(v, dtype=np.float32))).float()
                  .to(self.device) for k, v in params.items()}
        for name, v in values.items():  # shapes checked in the canonical layout
            want = self.updater.canonical_shape(name, self.state["params"][name])
            if tuple(v.shape) != want:
                raise ValueError(f"{name}: shape {tuple(v.shape)} != {want}")
        self._load("params", self.updater.params_from_canonical(values))

    def canonical_params(self) -> Dict[str, torch.Tensor]:
        """The parameters in their canonical shapes (zero3 gathers its rows:
        a collective on every rank)."""
        return self.updater.params_to_canonical(self.state["params"])

    def load_states(self, states: Mapping[str, Any]) -> None:
        """Replace the states' values (e.g. a JAX state dict through
        `nn/convert.params_from_jax`), in their own storage."""
        self._load("states", states)

    def _check_names(self, kind: str, values: Mapping[str, Any]) -> None:
        assert self.state is not None, "call init_state() first"
        own = self.state[kind]
        if set(values) != set(own):
            raise KeyError(
                f"{kind} names differ: missing {sorted(set(own) - set(values))}, "
                f"unknown {sorted(set(values) - set(own))}")

    def _load(self, kind: str, values: Mapping[str, Any]) -> None:
        self._check_names(kind, values)
        own = self.state[kind]
        new = {}
        for name, value in values.items():
            v = (value.float() if isinstance(value, torch.Tensor)
                 else torch.from_numpy(np.array(value, dtype=np.float32)))
            if tuple(v.shape) != tuple(own[name].shape):
                raise ValueError(f"{name}: shape {tuple(v.shape)} != {tuple(own[name].shape)}")
            new[name] = v
        with torch.no_grad():
            for name, v in new.items():
                own[name].copy_(v)

    # -- one step ------------------------------------------------------------
    def _cost(self, params: Dict[str, torch.Tensor], batch: Batch, train: bool,
              rng: Optional[Callable[[], torch.Tensor]] = None, resolver=None):
        """(summed f32 cost, outputs, new states) of a forward at `params`
        (under a mesh: this rank's share of the global batch's cost)."""
        outs, states = self.network.apply(params, batch, self.state["states"],
                                          train=train, policy=self.policy, rng=rng,
                                          remat=self.remat if train else None,
                                          mesh=self.mesh, param_resolver=resolver)
        return sum(outs[c].value for c in self.cost_names).float(), outs, states

    def step_rng(self) -> torch.Tensor:
        """The key the next step draws from: fold_in(rng, samples)."""
        return prng.fold_in(self.state["rng"], self.state["samples"])

    def _forward_backward(self, batch: Batch, rng: Callable[[], torch.Tensor]):
        params, leaves, resolver = self.updater.forward_inputs(self.state["params"],
                                                               self.state["opt"])
        names = list(leaves)
        cost, outs, states = self._cost(params, batch, train=True, rng=rng,
                                        resolver=resolver)
        grads = torch.autograd.grad(cost, [leaves[k] for k in names],
                                    allow_unused=True, materialize_grads=True)
        extras = {n: outs[n].value.detach() for n in self.extra_names}
        return cost.detach(), dict(zip(names, grads)), states, extras

    def cost_grads_and_states(self, batch: Batch, rng: Optional[torch.Tensor] = None):
        """(cost, {name: gradient}, new states) of a train-mode forward at
        the current parameters, no update; Dropout draws from `rng`, by
        default the key of the next step."""
        cost, grads, states, _ = self._forward_backward(
            batch, self.step_rng if rng is None else (lambda: rng))
        return cost, grads, states

    def cost_and_grads(self, batch: Batch):
        """(cost, {name: gradient}) of a train-mode forward at the current
        parameters, no update."""
        cost, grads, _ = self.cost_grads_and_states(batch)
        return cost, grads

    def _step_body(self, batch: Batch, weight: int = 1):
        """One step in place -> (its cost, {extra name: value}). The body a
        CUDA graph captures: it reads no device value on the host and
        writes only into the state's own storage. Under a mesh the updater
        reduces the gradients and the cost over it and returns the global
        cost. `weight`: how many batches the step stands for (zero2's
        window), for the guard's per-batch bookkeeping."""
        st = self.state
        samples = st["samples"]
        lr = self.schedule(samples.float()) * st["lr_scale"]
        # the key is computed at the first draw, before the update below:
        # a model without Dropout runs no threefry at all
        cost, grads, states, extras = self._forward_backward(
            batch, lambda: prng.fold_in(st["rng"], samples))
        cost, ok = self.updater.apply(grads, st["opt"], st["params"], lr, cost,
                                      guard=self.divergence_policy is not None)
        self.model_average.update(st["avg"], st["params"], ok=ok)
        with torch.no_grad():
            own = st["states"]
            for k, v in states.items():
                write_into(own[k], v, ok)
            write_into(samples, samples + self._rows(batch), ok)
            if ok is not None:
                write_into(st["cost_acc"], st["cost_acc"] + (cost if weight == 1
                                                             else cost * weight), ok)
                bad = torch.logical_not(ok).to(torch.int32)
                st["diverged"].add_(bad if weight == 1 else bad * weight)
        return cost, extras

    def _rows(self, batch: Batch):
        """The samples counter's step: the batch size; under a mesh the
        global batch's real row count (the same on every rank)."""
        if self.mesh is None:
            return _batch_size(batch)
        if SAMPLE_COUNT_KEY in batch:
            count = batch[SAMPLE_COUNT_KEY]
            count = (count if isinstance(count, torch.Tensor)
                     else torch.from_numpy(np.asarray(count, np.float32)))
            return count.to(self.device).reshape(()).to(torch.int32)
        return _batch_size(batch) * self.mesh.extent("data")

    def _dispatch(self, batch: Batch, k: int):
        """k steps on `batch` (one batch, or k stacked on a leading axis) ->
        (their k costs, the extras of a single step). On the card: replay
        the signature's graph, or run the steps eagerly and capture them.
        Under a mesh a global batch is cut to this rank's rows first, and
        zero2 runs a stack of k as one merged step (its window)."""
        if self.parallel is not None and not self.parallel.is_sharded_batch(batch):
            batch = (self.parallel.shard_batch(batch) if k == 1
                     else self.parallel.shard_batches(batch))
        window = k > 1 and self.updater.mode == "zero2"
        if window:
            batch = _merge_window(batch)
        steps = 1 if window else k

        def body(b):
            return self._step_body(b, k if window else 1)

        if self.device.type == "cuda":
            key = (k, _signature(batch))
            graph = self.graphs.get(key)
            if graph is not None:
                costs, extras = graph.replay(batch)
            else:
                costs, extras = self._eager(batch, steps, body)
                self.graphs[key] = StepGraph(body, batch, steps, self.device)
        else:
            costs, extras = self._eager(batch, steps, body)
        if window:  # one update stands for the k batches
            return [costs[0]] * k, {}
        if extras and self.mesh is not None and self.mesh.extent("data") > 1:
            # the evaluators read the global batch's outputs, as the JAX
            # package's step returns them
            extras = {name: _gather_rows(self.mesh, v) for name, v in extras.items()}
        return list(costs), extras

    def _eager(self, batch: Batch, k: int, body: Optional[Callable] = None):
        body = body or self._step_body
        costs, extras = [], {}
        for i in range(k):
            cost, extras = body(batch if k == 1 else _unstack(batch, i))
            costs.append(cost)
        return costs, (extras if k == 1 else {})

    def step(self, batch: Batch) -> torch.Tensor:
        """One training step on `batch` (under a mesh: the global batch,
        divisible by the data axis, or this rank's cut of one); returns the
        step's cost (a device scalar of its own, no host sync)."""
        if self.state is None:
            self.init_state(batch)
        return self._dispatch(batch, 1)[0][0]

    def multi_step(self, batches: Batch) -> torch.Tensor:
        """K training steps in one dispatch: every slot of `batches` is
        stacked on a leading K axis. Returns the K costs as one device
        tensor [K]. The same updates as K calls of `step`, bit for bit on
        the CPU; under zero2, one accumulated update for the K batches (its
        cost repeated K times)."""
        k = _stack_size(batches)
        if self.state is None:
            self.init_state(_unstack(batches, 0))
        return torch.stack(self._dispatch(batches, k)[0])

    # -- loops -----------------------------------------------------------------
    def _ensure_state(self, batch: Batch) -> None:
        """Build the state from the first batch, then apply a deferred
        auto-resume load (the state's shapes were unknown until now)."""
        if self.state is None:
            self.init_state(batch)
        if self._pending_load is not None:
            pending, self._pending_load = self._pending_load, None
            self.load(*pending)
            self._known_good_pass = pending

    def train(self, reader: Callable, num_passes: int = 1,
              event_handler: Optional[Callable] = None,
              feeder: Optional[Callable] = None,
              test_reader: Optional[Callable] = None,
              save_dir: Optional[str] = None, log_period: int = 100,
              auto_resume: bool = False,
              keep_last_n: Optional[int] = None, steps_per_dispatch: int = 1,
              async_checkpoint: bool = True, remat: Optional[str] = None,
              resize_barrier: Optional[Callable] = None, elastic: bool = False,
              join: Optional[Any] = None) -> TrainState:
        """`num_passes` passes over `reader()`, whose items are batch dicts,
        `StackedBatch`es or, with `feeder`, lists of samples. EndPass metrics
        carry avg_cost (one host sync per pass), batches, pass_seconds,
        divergence_events and, with `test_reader`, test_cost.

        steps_per_dispatch=K > 1: K consecutive batches of one shape
        signature are stacked and run through `multi_step`; a shape change
        flushes the batches waiting through single steps, and so does the
        end of the pass for a remainder of fewer than K. Events fire per
        call: BeginIteration with the first batch id of the group,
        EndIteration with the last and the group's last cost. A K-grouped
        pass applies the same updates as K=1, and sums the same costs in
        the same order.

        save_dir: a checkpoint of pass p is written at its end (`save`; with
        async_checkpoint the training thread only starts the device-to-host
        copies and a writer thread does the file I/O), keeping the newest
        `keep_last_n` passes. auto_resume: restore the newest checkpoint
        under save_dir that passes its CRCs (torn ones are skipped) and
        continue with the pass after it, or with the rest of the pass a
        preemption drain checkpointed; with a deterministic reader a run
        killed or preempted and resumed this way ends where an unbroken run
        ends. train() waits for the writer before it returns, and on its
        error path.

        log_period: a dispatch whose window crosses a multiple of it logs
        its cost (as the JAX trainer does); 0 turns the log off.

        remat: re-pins the rematerialization policy for this and later
        calls, and drops the captured graphs when it changes; None keeps
        the current one.

        resize_barrier: the fleet hook of elastic resize
        (`runtime.master.ResizeClient.barrier`), rank 0's: after the drain
        checkpoint it acks the master's epoch and returns the world to
        re-shard to. Without one, the request's own world is taken. A
        mesh-less trainer takes a pending request and ignores it, as in the
        JAX package.

        elastic: on a mesh of more than one rank, every rank passes it to
        follow resize epochs (rank 0 publishes each boundary's decision in
        the job's store, the others read it there); without it such a
        trainer drops a request with a warning. join: this rank joins a
        running job (`parallel.distributed.join`'s plan, whose group the
        trainer's mesh spans): it receives the state from rank 0 and
        continues the interrupted pass after the plan's batch. A rank that
        a shrink leaves out returns early, with `left` set."""
        if steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got {steps_per_dispatch}")
        if remat is not None:
            resolved = remat_mod.resolve(remat)
            if resolved != self.remat:
                self.remat = resolved
                self.graphs.clear()
        event_handler = event_handler or (lambda e: None)
        resume_pass: Optional[int] = None
        resume_mid, resume_skip = False, 0
        quiet: Optional[tuple] = None  # a joiner's (pass, batch): no boundary through it
        if join is not None:
            self._join_job(join, reader, feeder)
            resume_pass, resume_mid, resume_skip = join.pass_id, True, join.batch
            quiet = (join.pass_id, join.batch)
        elif auto_resume and save_dir is not None:
            self.checkpoint_wait()  # the scan must see completed writes
            resume_pass = ckpt.find_latest_valid_pass(save_dir)
            if resume_pass is not None:
                extra = ckpt.pass_manifest(save_dir, resume_pass).get("extra", {})
                if extra.get("mid_pass"):
                    # a preemption drain's checkpoint: replay the rest of it
                    resume_mid = True
                    resume_skip = int(extra.get("batches_done", 0))
                log.info("auto-resume: restoring from %s/pass-%05d (continuing at "
                         "pass %d%s)", save_dir, resume_pass,
                         resume_pass if resume_mid else resume_pass + 1,
                         f" batch {resume_skip}" if resume_mid else "")
                if self.state is not None:
                    self.load(save_dir, resume_pass)
                    self._known_good_pass = (save_dir, resume_pass)
                else:  # the state's shapes are unknown until a batch arrives
                    self._pending_load = (save_dir, resume_pass)
        flushed = False
        try:
            for pass_id in range(num_passes):
                if resume_pass is not None and (
                        pass_id < resume_pass or (pass_id == resume_pass and not resume_mid)):
                    continue  # completed by the run being resumed
                self._train_one_pass(
                    reader, pass_id, event_handler, feeder, test_reader, save_dir,
                    log_period, keep_last_n, steps_per_dispatch, async_checkpoint,
                    resume_skip if (resume_mid and pass_id == resume_pass) else 0,
                    resize_barrier, elastic,
                    quiet[1] if quiet is not None and pass_id == quiet[0] else -1)
            if self._pending_load is not None:
                # every pass was checkpointed already: nothing ran, so build
                # the state from one batch and load the last checkpoint
                raw = next(iter(reader()), None)
                if raw is not None:
                    if isinstance(raw, StackedBatch):
                        raw = _unstack(raw, 0)
                    self._ensure_state(_feed(raw, feeder))
            self.checkpoint_wait()
            flushed = True
            if self.agreement["boundaries"]:
                a = self.agreement
                log.info("boundary agreement on rank %d: %d boundaries, %.1f us each",
                         self.mesh.rank, a["boundaries"], 1e6 * a["seconds"] / a["boundaries"])
        except _LeftJob:
            flushed = True
            log.warning("rank %d left the job at the resize to %d (pass %d batch %d)",
                        self.left["rank"], self.left["world"], self.left["pass"],
                        self.left["batch"])
        finally:
            self._pending_load = None
            if not flushed and self._ckpt_writer is not None:
                # error path (an injected kill too): land the snapshot in
                # flight, never masking the exception on its way out
                try:
                    self._ckpt_writer.wait()
                except Exception:
                    log.exception("async checkpoint flush failed during error exit")
        return self.state

    def _train_one_pass(self, reader: Callable, pass_id: int, event_handler: Callable,
                        feeder: Optional[Callable], test_reader: Optional[Callable],
                        save_dir: Optional[str], log_period: int,
                        keep_last_n: Optional[int],
                        steps_per_dispatch: int, async_checkpoint: bool,
                        resume_skip: int, resize_barrier: Optional[Callable] = None,
                        elastic: bool = False, quiet_through: int = -1) -> None:
        """One pass. Nothing here reads a device value per step: the pass
        cost is a device sum (or, with the guard, the step's own masked
        accumulator) read once at pass end, and `diverged` is read only at
        guard polls. resume_skip: the batches of this pass a drained
        checkpoint already holds; the reader is consumed past them.
        quiet_through: a joiner's first batch; it takes no boundary decision
        up to it (the old ranks took that one before the resize)."""
        inj = faults.get()
        pass_rz0 = len(self._resize_log)
        guard_on = self.divergence_policy is not None
        pad0 = stats.DATA_EVENTS.get("padded_batches")
        self.updater.start_pass()
        event_handler(BeginPass(pass_id))
        t0 = time.time()
        if guard_on and self.state is not None:
            self.state["cost_acc"].zero_()
        cost_sum: Optional[torch.Tensor] = None
        stepped = 0  # steps dispatched this pass
        pass_div0 = self._diverged_seen
        steps_since_poll = 0
        pending: List[Any] = []  # (batch_id, batch) waiting for a group
        logical = 0  # reader position in single-batch units
        boundary = 0  # every batch before it was applied or skipped
        pending_log: Optional[tuple] = None  # (batch id, host copy, copied event)

        def flush_log() -> None:
            nonlocal pending_log
            if pending_log is not None:
                batch_id, host, copied = pending_log
                pending_log = None
                if copied is not None:
                    copied.synchronize()  # one dispatch behind: landed already
                log.info("pass %d batch %d cost=%.6f", pass_id, batch_id, float(host))

        def dispatch(first: int, last: int, batch: Batch, k: int) -> None:
            nonlocal cost_sum, stepped, steps_since_poll, pending_log
            if inj.active:
                if inj.fire("kill"):
                    raise faults.InjectedKill(
                        f"injected kill at pass {pass_id} batch {first}")
                if inj.fire("preempt"):
                    # only sets the drain flag: this dispatch still steps,
                    # the next boundary drains
                    preempt.get().request(f"injected preempt at pass {pass_id} "
                                          f"batch {first}")
                if inj.fire("nan_loss"):
                    batch = _same_plan(_poison_batch(batch), batch, k=getattr(batch, "k", 1))
            event_handler(BeginIteration(pass_id, first))
            costs, extras = self._dispatch(batch, k)
            if self._resize_mark is not None:
                # the first dispatch on the new mesh returned (its eager run
                # and capture included): the resume leg ends here
                self._note_resize_resumed()
            if not guard_on:
                for cost in costs:
                    cost_sum = cost if cost_sum is None else cost_sum + cost
            stepped += k
            steps_since_poll += k
            if guard_on and steps_since_poll >= self.guard_check_every:
                steps_since_poll = 0
                new = self._poll_guard(pass_id, last, save_dir)
                # a poll after every single step knows this step diverged:
                # its event is not delivered
                if new and k == 1 and self.guard_check_every == 1:
                    return
            event_handler(EndIteration(pass_id, last, costs[-1], extras))
            if log_period > 0 and last % log_period < k:  # crossed a mark
                flush_log()
                pending_log = (last, *host_copy(costs[-1]))

        def flush() -> None:
            nonlocal boundary
            for batch_id, batch in pending:
                dispatch(batch_id, batch_id, batch, 1)
            if pending:
                boundary = pending[-1][0] + 1
            pending.clear()

        for raw in reader():
            k_item = raw.k if isinstance(raw, StackedBatch) else 1
            idx0 = logical
            logical += k_item
            decision, req = (_GO, None) if idx0 <= quiet_through else \
                self._boundary_decision(elastic)
            if decision == _PREEMPT:
                # a dispatch boundary: the previous step completed; the
                # current batch and any buffered ones replay after resume
                self._drain_preempt(save_dir, pass_id, max(boundary, resume_skip),
                                    keep_last_n, async_checkpoint)
            if decision == _RESIZE:
                # cooperative: the buffered batches (padded for the old
                # mesh) flush on it first; the current batch runs on the new
                flush()
                self._drain_resize(req, save_dir, pass_id, max(boundary, resume_skip),
                                   keep_last_n, async_checkpoint, resize_barrier)
                rebind = getattr(reader, "rebind_parallel", None)
                if rebind is not None and self.parallel is not None:
                    # a prefetcher cuts for the plan it was given: only its
                    # in-flight batches take the straggler path below
                    rebind(self.parallel)
            if idx0 + k_item <= resume_skip:
                boundary = logical  # already in the restored state
                continue
            stale = self._stale_cut(raw)
            if isinstance(raw, StackedBatch):
                self._ensure_state(_unstack(raw, 0))
                flush()  # keep the update order the reader's
                skip = max(resume_skip - idx0, 0)  # a group across the boundary
                if skip or stale:
                    for j in range(skip, k_item):
                        # a straggler's global batch padded for the current
                        # plan (the dispatch cuts this rank's rows)
                        b = (self.parallel.maybe_pad_batch(raw.host[j]) if stale
                             else _unstack(raw, j))
                        if b is not None:
                            dispatch(idx0 + j, idx0 + j, b, 1)
                else:
                    dispatch(idx0, idx0 + k_item - 1, raw, k_item)
                boundary = logical
                continue
            batch = raw.host if stale else _feed(raw, feeder)
            if self.parallel is not None and not self.parallel.is_sharded_batch(batch):
                # an indivisible trailing batch pads (its row mask keeps the
                # cost the unpadded one's) instead of dropping
                batch = self.parallel.maybe_pad_batch(batch)
                if batch is None:
                    boundary = logical
                    continue
            self._ensure_state(batch)
            if steps_per_dispatch == 1:
                dispatch(idx0, idx0, batch, 1)
                boundary = logical
                continue
            if pending and _signature(batch) != _signature(pending[0][1]):
                flush()
            pending.append((idx0, batch))
            if len(pending) == steps_per_dispatch:
                dispatch(pending[0][0], pending[-1][0],
                         _stack([b for _, b in pending]), steps_per_dispatch)
                boundary = pending[-1][0] + 1
                pending.clear()
        flush()
        flush_log()
        if self._resize_mark is not None:
            # the resize came at the pass's last boundary: no dispatch after it
            self._note_resize_resumed()
        if guard_on and self.state is not None:
            # the reaction window never crosses a pass boundary: the pass
            # checkpoint must not absorb an unexamined divergence
            self._poll_guard(pass_id, max(logical - 1, 0), save_dir)
        n_diverged = self._diverged_seen - pass_div0
        n_batches = stepped - n_diverged
        if guard_on and self.state is not None:
            cost_sum = self.state["cost_acc"]  # accumulated and masked in the step
        metrics: Dict[str, Any] = {
            "avg_cost": (float(cost_sum) / n_batches
                         if n_batches and cost_sum is not None else 0.0),
            "batches": n_batches, "pass_seconds": time.time() - t0,
            "divergence_events": n_diverged,
        }
        pass_resizes = self._resize_log[pass_rz0:]
        if pass_resizes:
            # the epochs completed this pass and their drain / reshard /
            # resume split (obs_metrics.observe_resize has the same numbers)
            metrics["resize_epochs"] = len(pass_resizes)
            metrics["resizes"] = pass_resizes
        if self.parallel is not None and self.state is not None:
            # per-rank resident bytes and the updater's modeled collective
            # bytes (pass-end bookkeeping, no device sync)
            metrics["padded_batches"] = stats.DATA_EVENTS.get("padded_batches") - pad0
            metrics["param_bytes"] = _tree_bytes(self.state["params"])
            metrics["opt_state_bytes"] = _tree_bytes(self.state["opt"])
            metrics["collective_bytes_per_step"] = \
                self.updater.collective_bytes_per_step(steps_per_dispatch)
            detail = self.updater.collective_bytes_detail(steps_per_dispatch)
            if detail:
                metrics["collective_bytes_detail"] = detail
            if self.device.type == "cuda":
                metrics["peak_hbm_bytes"] = torch.cuda.max_memory_allocated(self.device)
        self.updater.finish_pass()
        if test_reader is not None:
            metrics["test_cost"] = self.test(test_reader, feeder)["cost"]
        if save_dir is not None and self.state is not None:
            self.save(save_dir, pass_id, keep_last_n=keep_last_n, async_=async_checkpoint)
            self._known_good_pass = (save_dir, pass_id)
        event_handler(EndPass(pass_id, metrics))

    # -- divergence guard and preemption ------------------------------------------
    def _poll_guard(self, pass_id: int, batch_id: int, save_dir: Optional[str],
                    react: bool = True) -> int:
        """Read the device's cumulative `diverged` count (the guard's one
        host sync) and react to what is new since the last poll. The step
        already reverted every diverged update on the device, so the
        reaction is policy, not protection. Returns the number of new
        events."""
        d = int(self.state["diverged"])
        new = d - self._diverged_seen
        self._diverged_seen = d
        if new <= 0:
            return 0
        stats.FT_EVENTS.incr("divergence", new)
        if not react:
            log.warning("divergence guard: %d non-finite step cost(s) found while "
                        "draining at pass %d batch %d; the updates were reverted on "
                        "the device, no reaction during the drain", new, pass_id, batch_id)
            return new
        if self.divergence_policy == "raise":
            raise DivergenceError(
                f"non-finite cost in {new} step(s) within the guard window ending at "
                f"pass {pass_id} batch {batch_id}; every poisoned update was rolled "
                f"back to its pre-step state on the device")
        if self.divergence_policy == "rollback":
            self._rollback(save_dir, pass_id, batch_id)
        else:
            log.warning("divergence guard: non-finite cost in %d step(s) in the window "
                        "ending at pass %d batch %d; the poisoned updates were skipped "
                        "on the device", new, pass_id, batch_id)
        return new

    def _rollback(self, save_dir: Optional[str], pass_id: int, batch_id: int) -> None:
        """Restore the newest valid checkpoint and halve the lr multiplier;
        with no checkpoint to return to, the step's own revert stands (as
        skip_batch)."""
        latest: Optional[int] = None
        if save_dir is not None:
            self.checkpoint_wait()  # scan and load only completed writes
            if self._known_good_pass and self._known_good_pass[0] == save_dir:
                latest = self._known_good_pass[1]
            else:
                latest = ckpt.find_latest_valid_pass(save_dir)
        if latest is None:
            log.warning("divergence rollback at pass %d batch %d: no valid checkpoint "
                        "under %r; falling back to skipping the batch",
                        pass_id, batch_id, save_dir)
            return
        cur_scale = float(self.state["lr_scale"])
        seen = self._diverged_seen
        try:
            self.load(save_dir, latest)
        except (OSError, ValueError):
            # the remembered checkpoint rotted on disk: scan for another
            self._known_good_pass = None
            latest = ckpt.find_latest_valid_pass(save_dir)
            if latest is None:
                log.warning("divergence rollback at pass %d batch %d: no valid "
                            "checkpoint under %r; falling back to skipping the batch",
                            pass_id, batch_id, save_dir)
                return
            self.load(save_dir, latest)
        # the events happened: the count stays the live one
        self.state["diverged"].fill_(seen)
        self._diverged_seen = seen
        # halve from the lower of the live and the restored scale, so
        # rollbacks onto one checkpoint compound (0.5, 0.25, ...)
        self.set_lr_scale(min(cur_scale, float(self.state["lr_scale"])) * 0.5)
        stats.FT_EVENTS.incr("divergence_rollback")
        log.warning("divergence rollback at pass %d batch %d: restored pass-%05d, "
                    "lr_scale now %g", pass_id, batch_id, latest,
                    float(self.state["lr_scale"]))

    # -- elastic resize ----------------------------------------------------------
    def _stale_cut(self, raw: Any) -> bool:
        """True for a prefetched batch cut for a plan a resize replaced (a
        straggler in flight across it): it is re-cut from its host copy."""
        plan = getattr(raw, "plan", None)
        if not (self._resized and plan is not None and plan is not self.parallel):
            return False
        if getattr(raw, "host", None) is None:
            raise ValueError("a batch cut for the data-parallel plan before the resize "
                             "carries no host copy of its global batch to re-cut")
        return True

    def _boundary_decision(self, elastic: bool):
        """(go | resize | preempt, the resize request or None) at a dispatch
        boundary. An elastic trainer on several ranks takes rank 0's
        decision from the job's store; without `elastic` such a trainer
        cannot drain in step and drops a resize request."""
        agree = (elastic and self.mesh is not None and self.mesh.size > 1
                 and self.state is not None)
        if not agree:
            if preempt.requested():
                return _PREEMPT, None
            if self.state is None or not preempt.resize_requested():
                return _GO, None
            if self.mesh is not None and self.mesh.size > 1:
                req = preempt.get().take_resize()
                if req is not None:
                    log.warning("resize request (%s) dropped: a trainer of %d ranks "
                                "follows resize epochs with train(elastic=True) on every "
                                "rank", req.reason, self.mesh.size)
                return _GO, None
            return _RESIZE, None
        decision, req = _GO, None
        if self.mesh.rank == 0:
            if preempt.requested():
                decision = _PREEMPT
            elif preempt.resize_requested():
                req = preempt.get().take_resize()
                decision = _RESIZE if req is not None else _GO
        return self._agree(decision), req

    def _agree(self, decision: str) -> str:
        """Rank 0 writes its decision for this boundary into the job's
        store; every other rank reads it there (blocking until it is
        written) before it dispatches. Host work only, no collective."""
        t0 = time.perf_counter()
        store = self._job()
        key = f"elastic/{self._attempt}/b/"
        seq, self._bseq = self._bseq, self._bseq + 1
        if self.mesh.rank == 0:
            store.set(f"{key}{seq}", decision)
            if seq >= _KEEP_BOUNDARIES:
                store.delete_key(f"{key}{seq - _KEEP_BOUNDARIES}")
        else:
            decision = store.get(f"{key}{seq}").decode()
        self.agreement["boundaries"] += 1
        self.agreement["seconds"] += time.perf_counter() - t0
        return decision

    def _job(self):
        """The job's store: the one the trainer's first group was built on
        (a joiner's plan brings it)."""
        if self._job_store is None:
            from paddle_tpu_torch.parallel.mesh import group_store

            self._job_store = group_store(self.mesh.group)
        return self._job_store

    def _from_lead(self, *values: int) -> List[int]:
        """Rank 0's integers on every rank of the mesh (a broadcast over its
        group; nothing on one rank)."""
        if self.mesh.size == 1:
            return [int(v) for v in values]
        t = torch.tensor([int(v) for v in values], dtype=torch.int64, device=self.device)
        self.mesh.broadcast_(t, None)
        return [int(v) for v in t.tolist()]

    def _drain_resize(self, req: Optional[preempt.ResizeRequest], save_dir: Optional[str],
                      pass_id: int, batches_done: int, keep_last_n: Optional[int],
                      async_checkpoint: bool, barrier: Optional[Callable] = None) -> None:
        """The cooperative resize drain at a dispatch boundary, on every rank
        of the mesh together (`req` is rank 0's; the others hold None): fold
        an open guard window, write a durable mid-pass checkpoint (a crash
        in the re-shard resumes from exactly here), pass the fleet barrier
        (rank 0; its world reaches the others by broadcast), re-shard, and
        return to the loop, whose next batch runs on the new mesh. Without
        a mesh the request is ignored, as in the JAX package."""
        lead = self.mesh is None or self.mesh.rank == 0
        if req is None and lead:
            req = preempt.get().take_resize()
            if req is None:
                return  # another poller claimed it
        if self.parallel is None:
            log.warning("resize request (%s) ignored: this trainer has no "
                        "DataParallel mesh to re-shape", req.reason)
            return
        t_req = req.requested_at if req is not None else time.monotonic()
        if self.divergence_policy is not None:
            # fold an unexamined guard window in before the state moves
            self._poll_guard(pass_id, batches_done, save_dir, react=False)
        saved: Optional[str] = None
        if save_dir is not None:
            saved = self.save(save_dir, pass_id, keep_last_n=keep_last_n,
                              mid_pass_batches=batches_done, async_=async_checkpoint)
            self.checkpoint_wait()  # durable before the mesh moves
            self._known_good_pass = (save_dir, pass_id)
        world = epoch = 0
        if lead:
            if barrier is None:
                # local mode: the stall site hooks here (the fleet barrier
                # has its own), one hook a drain
                faults.maybe_stall("resize_drain_stall", env="PADDLE_TPU_RESIZE_STALL_S")
                world = req.world
            else:
                # ack the master's epoch and block until its go; the world
                # it returns supersedes the announced one
                world = int(barrier(req, pass_id, batches_done))
            epoch = req.epoch
        world, epoch = self._from_lead(world, epoch)
        t_drained = time.monotonic()
        trace.span_from_monotonic("train.resize.drain", t_req,
                                  attrs={"epoch": epoch, "pass": pass_id,
                                         "batch": batches_done})
        if lead:
            stats.FT_EVENTS.incr("resize_drain")
        if world == self.parallel.data_axis_size:
            # drain-only: nothing to re-shard, nothing to recapture
            log.info("resize epoch %d: already at world %d; drain-only, no re-shard",
                     epoch, world)
        else:
            self._position = (pass_id, batches_done)
            try:
                self.resize_to(world)
            except ValueError as e:
                # every rank got the same verdict: the pass goes on, bitwise,
                # on the old mesh
                if lead:
                    stats.FT_EVENTS.incr("resize_rejected")
                log.error("resize epoch %d to world=%d rejected: %s; continuing the pass "
                          "on the current %d-rank mesh", epoch, world, e,
                          self.parallel.data_axis_size)
                return
            finally:
                self._position = (-1, -1)
            if self.left is not None:
                raise _LeftJob()
        t_resharded = time.monotonic()
        trace.span_from_monotonic("train.resize.reshard", t_drained, attrs={"world": world})
        log.warning("resize drain at pass %d batch %d: %s; data axis now %d (epoch %d), "
                    "resuming the interrupted pass", pass_id, batches_done,
                    f"checkpointed to {saved}" if saved else "no checkpoint", world, epoch)
        self._resize_mark = {"epoch": epoch, "world": world, "pass": pass_id,
                             "batch": batches_done, "drain_s": t_drained - t_req,
                             "reshard_s": t_resharded - t_drained,
                             "t_resharded": t_resharded}

    def _note_resize_resumed(self) -> None:
        """Close an epoch once the first dispatch after it returned (or at
        pass end): the resume leg of the latency split, the span, the
        metrics and the pass's log entry."""
        m, self._resize_mark = self._resize_mark, None
        resume_s = time.monotonic() - m["t_resharded"]
        trace.span_from_monotonic("train.resize.resume", m["t_resharded"],
                                  attrs={"epoch": m["epoch"], "world": m["world"]})
        split = {"drain": m["drain_s"], "reshard": m["reshard_s"], "resume": resume_s}
        if self.mesh is None or self.mesh.rank == 0:  # one member a job
            obs_metrics.observe_resize(split)
            stats.FT_EVENTS.incr("resize_epoch")
        self._resize_log.append({
            "epoch": m["epoch"], "world": m["world"], "pass": m["pass"],
            "batch": m["batch"], "drain_s": round(split["drain"], 6),
            "reshard_s": round(split["reshard"], 6), "resume_s": round(split["resume"], 6)})
        log.info("resize epoch %d complete: world=%d drain=%.3fs reshard=%.3fs "
                 "resume=%.3fs", m["epoch"], m["world"], split["drain"], split["reshard"],
                 split["resume"])

    def resize_to(self, new_world: int) -> None:
        """Re-shard the live train state onto a mesh whose data axis spans
        `new_world` (the other axes keep their extents). Every rank of the
        current mesh calls it together; joiners of a grow take part through
        `train(join=...)`. In order: the optimizer slots, parameters and
        averages in their canonical layout, gathered on the old group; the
        `reshard_kill` site (rank 0's); the new world's rendezvous over the
        job's store (ValueError on every rank when it cannot be built: a
        joiner missing, or on CUDA more ranks than visible cards; the old
        group is still whole then). Only then: the captured graphs go (they
        hold the old communicator), the old mesh closes, the updater
        rebinds to the new plan, the state is re-laid for it (values exact:
        the canonical round trip a checkpoint takes) and, on a grow, rank
        0 broadcasts it to the joiners. The next dispatch of each signature
        runs eagerly, then captures. A rank outside the new world leaves:
        `left` says where."""
        if self.parallel is None:
            raise ValueError("resize_to needs a DataParallel mesh "
                             "(SGDTrainer(parallel=...)): there is no mesh to re-shape")
        assert self.state is not None, "resize_to needs a live state"
        from paddle_tpu_torch.parallel import distributed
        from paddle_tpu_torch.parallel.data_parallel import DataParallel
        from paddle_tpu_torch.parallel.mesh import resize_mesh

        old, mesh = self.parallel, self.mesh
        new_world = int(new_world)
        if new_world < 1:
            raise ValueError(f"resize target for axis {old.batch_axis!r} must be >= 1")
        axes = dict(mesh.shape)
        axes[old.batch_axis] = new_world
        total = int(np.prod(list(axes.values())))
        # the portable waypoint, gathered on the old group
        canonical = self.updater.to_canonical(self.state["opt"])
        params_c = self.updater.params_to_canonical(self.state["params"])
        avg_c = (self.updater.params_to_canonical(self.state["avg"]["avg"])
                 if self.state["avg"] else None)
        lead = mesh.rank == 0
        kill = lead and faults.get().fire("reshard_kill")
        attempt = self._job().add("elastic/attempts", 1) if lead else 0
        attempt, kill = self._from_lead(attempt, kill)
        if kill:
            # the process dies mid-re-shard, after the drain checkpoint:
            # auto_resume replays the pass from the drained boundary
            raise faults.InjectedKill("injected reshard_kill (chaos)")
        plan = distributed.ElasticPlan(
            attempt, axes, total, mesh.size, mesh.backend, *self._position,
            store=self._job())
        if lead:
            distributed.announce(plan)
        group = distributed.rendezvous(plan, lead, mesh.rank if mesh.rank < total else None,
                                       self.device)
        self._drop_graphs()
        mesh.close()
        if group is None:
            self.left = {"rank": mesh.rank, "world": new_world, "pass": self._position[0],
                         "batch": self._position[1]}
            return
        new_mesh = resize_mesh(mesh, old.batch_axis, new_world, group=group)
        new_parallel = DataParallel(new_mesh, batch_axis=old.batch_axis,
                                    param_attrs=old.param_attrs, rules=old.rules)
        new_updater = self.updater.rebind(new_parallel, params_c)
        state = dict(self.state)
        state["opt"] = new_updater.from_canonical(canonical)
        state["params"] = new_updater.params_from_canonical(params_c)
        if avg_c is not None:
            state["avg"] = {**state["avg"], "avg": new_updater.params_from_canonical(avg_c)}
        self.parallel, self.updater, self.mesh = new_parallel, new_updater, new_mesh
        self.state = new_parallel.shard_state(state)
        self._attempt, self._bseq, self._resized = attempt, 0, True
        if total > mesh.size:
            canon = {"params": params_c, "opt": canonical}
            if avg_c is not None:
                canon["avg"] = {**self.state["avg"], "avg": avg_c}
            self._share_state(canon)

    def _drop_graphs(self) -> None:
        """Free every captured step graph. NCCL does not destroy a
        communicator while a live CUDA graph holds its work, so this comes
        before a group is shut down."""
        self.graphs.clear()
        if self.device.type == "cuda":
            gc.collect()
            torch.cuda.synchronize(self.device)

    def close(self) -> None:
        """The end of a rank's run: free the step graphs, then shut the
        mesh's groups down (every rank of the mesh together)."""
        self._drop_graphs()
        if self.mesh is not None and not self.mesh.closed:
            self.mesh.close()

    def _share_state(self, trees: Optional[Dict[str, Any]] = None) -> None:
        """Rank 0's state on every rank of the new mesh after a grow. The
        old ranks pass the canonical trees they gathered on the old group
        (whole on each of them); a joiner builds empty ones of the same
        shapes from its own state, with no collective. Every leaf is
        broadcast from rank 0, in key order, then laid out for the new mesh
        as a checkpoint loads it, and the counters follow."""
        st, up = self.state, self.updater
        if trees is None:  # a joiner: the canonical shapes, no values yet
            params = {k: torch.empty(up.canonical_shape(k, v), dtype=v.dtype,
                                     device=self.device) for k, v in st["params"].items()}
            opt = self.optimizer.init_state(params)
            if "ef" in st["opt"]:
                opt["ef"] = {k: torch.empty(params[k].shape, dtype=torch.float32,
                                            device=self.device) for k in st["opt"]["ef"]}
            trees = {"params": params, "opt": opt}
            if st["avg"]:
                trees["avg"] = self.model_average.init_state(params)
        trees = {**trees, "states": st["states"]}
        flat = ckpt.flatten_tree(trees, leaf=_leaf)
        with torch.no_grad():
            for k in sorted(flat):
                self.mesh.broadcast_(flat[k], None)
            for k in ("samples", "lr_scale", "diverged", "cost_acc", "rng"):
                self.mesh.broadcast_(st[k], None)
        self.load_params(trees["params"])
        new = {"opt": up.from_canonical(trees["opt"])}
        if "avg" in trees:
            new["avg"] = {**trees["avg"], "avg": up.params_from_canonical(trees["avg"]["avg"])}
        own = ckpt.flatten_tree({k: st[k] if k == "avg" else st["opt"] for k in new},
                                leaf=_leaf)
        with torch.no_grad():
            for k, v in ckpt.flatten_tree(new, leaf=_leaf).items():
                own[k].copy_(v)
        self._diverged_seen = int(st["diverged"])

    def _join_job(self, plan: Any, reader: Callable, feeder: Optional[Callable]) -> None:
        """A joiner's entry into a running job: the state's shapes from the
        reader's first batch, then rank 0's values (`_share_state`, in step
        with the old ranks' resize), and the attempt's boundary count."""
        if self.mesh is None:
            raise ValueError("train(join=...) needs the trainer's mesh over the "
                             "plan's group (SGDTrainer(parallel=...))")
        if plan.pass_id < 0:
            raise ValueError(f"resize attempt {plan.attempt} was made outside train(): "
                             "a joiner has no batch to continue from")
        self._job_store = plan.store
        it = iter(reader())
        try:
            raw = next(it)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()
        if isinstance(raw, StackedBatch):
            raw = _unstack(raw, 0)
        self.init_state(_feed(raw, feeder))
        self._share_state()
        self._attempt, self._bseq, self._resized = plan.attempt, 0, True
        log.info("rank %d joined the job at resize attempt %d (pass %d batch %d, %d "
                 "ranks)", self.mesh.rank, plan.attempt, plan.pass_id, plan.batch,
                 plan.world)

    def _drain_preempt(self, save_dir: Optional[str], pass_id: int, batches_done: int,
                       keep_last_n: Optional[int], async_checkpoint: bool = False) -> None:
        """Preemption drain at a dispatch boundary: a durable mid-pass
        checkpoint unless the grace budget is spent, then Preempted."""
        guard = preempt.get()
        saved: Optional[str] = None
        if self.state is not None and self.divergence_policy is not None:
            # fold an unexamined guard window into the telemetry first
            self._poll_guard(pass_id, batches_done, save_dir, react=False)
        if self.state is not None and save_dir is not None:
            if guard.deadline_passed():
                log.warning("preempt drain at pass %d batch %d: grace budget (%.1fs) "
                            "already spent; exiting without a mid-pass checkpoint",
                            pass_id, batches_done, guard.grace_s)
            else:
                saved = self.save(save_dir, pass_id, keep_last_n=keep_last_n,
                                  mid_pass_batches=batches_done, async_=async_checkpoint)
                self.checkpoint_wait()  # durable before the exit
                self._known_good_pass = (save_dir, pass_id)
        stats.FT_EVENTS.incr("preempt_drain")
        log.warning("preempt drain: stopping at pass %d batch %d (%s)", pass_id,
                    batches_done, f"checkpointed to {saved}" if saved else "no checkpoint")
        raise Preempted(pass_id, batches_done, saved, guard.reason)

    def test(self, reader: Callable, feeder: Optional[Callable] = None) -> Dict[str, Any]:
        """Average cost over `reader()` (batch dicts, or sample lists with
        `feeder`), weighted by batch size, at the model-averaged parameters
        (the parameters without averaging); batch norm uses its moving
        statistics."""
        assert self.state is not None, "call train() or init_state() first"
        params = self.model_average.averaged_params(self.state["avg"],
                                                    self.state["params"])
        resolver = self.updater.eval_resolver(self.state["opt"])
        total, n = 0.0, 0
        with torch.no_grad():
            for raw in reader():
                batch = _feed(raw, feeder)
                if self.parallel is None:
                    bs = _batch_size(batch)
                    total += float(self._cost(params, batch, train=False)[0]) * bs
                    n += bs
                    continue
                if not self.parallel.is_sharded_batch(batch):
                    # the training path's pad and mask: the masked cost is
                    # the mean over the real rows
                    batch = self.parallel.maybe_pad_batch(batch, where="test batch")
                    if batch is None:
                        continue
                    batch = self.parallel.shard_batch(batch)
                cost = self._cost(params, batch, train=False, resolver=resolver)[0]
                cost = self.mesh.all_reduce_(cost.reshape(1).clone())[0]
                bs = int(self._rows(batch))
                total += float(cost) * bs
                n += bs
        return {"cost": total / max(n, 1), "samples": n}

    # -- checkpoints -----------------------------------------------------------
    def _trees(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The checkpoint's three trees as flat {key: tensor} dicts, keyed as
        the JAX package keys them; the averages ride in the optimizer tree."""
        opt_tree = {"opt": self.state["opt"]}
        if self.state["avg"]:
            opt_tree["avg"] = self.state["avg"]
        return {
            "params": ckpt.flatten_tree(self.state["params"], leaf=_leaf),
            "states": ckpt.flatten_tree(self.state["states"], leaf=_leaf),
            "opt": ckpt.flatten_tree(opt_tree, leaf=_leaf),
        }

    def _canonical_trees(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """`_trees` in the canonical layout a checkpoint holds: the
        updater's seams turn ZeRO's flat rows back into parameter shapes
        (all-gathers, so every rank calls it)."""
        up = self.updater
        opt_tree = {"opt": up.to_canonical(self.state["opt"])}
        if self.state["avg"]:
            opt_tree["avg"] = {**self.state["avg"],
                               "avg": up.params_to_canonical(self.state["avg"]["avg"])}
        return {
            "params": ckpt.flatten_tree(up.params_to_canonical(self.state["params"]),
                                        leaf=_leaf),
            "states": ckpt.flatten_tree(self.state["states"], leaf=_leaf),
            "opt": ckpt.flatten_tree(opt_tree, leaf=_leaf),
        }

    def _world(self) -> int:
        return self.parallel.data_axis_size if self.parallel is not None else 1

    def _mesh_barrier(self) -> None:
        """Every rank waits here for the others (a one-float all-reduce):
        rank 0's checkpoint write lands before anyone reads it."""
        if self.mesh is not None and self.mesh.size > 1:
            self.mesh.all_reduce_(torch.zeros(1, device=self.device), axis=None)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()

    def _meta(self, mid_pass_batches: Optional[int] = None) -> Dict[str, Any]:
        st = self.state
        meta = {"samples": int(st["samples"]), "lr_scale": float(st["lr_scale"]),
                "world_size": self._world(), "rng": [int(v) for v in st["rng"].tolist()],
                "diverged": int(st["diverged"])}
        if mid_pass_batches is not None:
            meta["mid_pass"] = True
            meta["batches_done"] = int(mid_pass_batches)
        return meta

    def save(self, save_dir: str, pass_id: int, keep_last_n: Optional[int] = None,
             async_: bool = False, mid_pass_batches: Optional[int] = None) -> str:
        """Write the parameters, states, optimizer slots and `t`, the model
        averages and the counters (samples, lr_scale, rng, diverged) as
        save_dir/pass-%05d (the JAX package's pass directory), so `load` is
        a true resume. mid_pass_batches marks a preemption drain's save:
        the pass is applied through that many batches, and auto-resume
        replays the rest of it.

        async_=True: the training thread waits for the previous snapshot's
        write, starts the device-to-host copies into pinned buffers (kept
        for the next save) on the current stream — ordered before any later
        step's in-place update — and hands the file I/O to the writer
        thread, which waits for the copies' event first. The returned path
        is durable after `checkpoint_wait()`; train() and load() call it."""
        assert self.state is not None
        trees = self._canonical_trees()
        meta = self._meta(mid_pass_batches)
        if self.mesh is not None and self.mesh.rank != 0:
            # rank 0 writes the one canonical copy
            return os.path.join(save_dir, f"pass-{pass_id:05d}")
        if not async_:
            host = {name: {k: v.detach().cpu().numpy() for k, v in flat.items()}
                    for name, flat in trees.items()}
            return ckpt.save_pass(save_dir, pass_id, host["params"], host["states"],
                                  host["opt"], extra_meta=meta, keep_last_n=keep_last_n)
        if self._ckpt_writer is None:
            self._ckpt_writer = ckpt.AsyncCheckpointer()
        self._ckpt_writer.wait()  # the pinned buffers are free again
        host, ready = self._fetch(trees)
        return ckpt.save_pass_async(self._ckpt_writer, save_dir, pass_id, host["params"],
                                    host["states"], host["opt"], extra_meta=meta,
                                    keep_last_n=keep_last_n, ready=ready)

    def _fetch(self, trees):
        """Host copies of the trees -> ({tree: {key: array}}, ready): pinned
        buffers filled by non-blocking copies and the event that says they
        landed, on the card; plain copies on the CPU (ready is None)."""
        if self.device.type != "cuda":
            return {name: {k: v.detach().clone().numpy() for k, v in flat.items()}
                    for name, flat in trees.items()}, None
        host = {}
        for name, flat in trees.items():
            host[name] = {}
            for k, v in flat.items():
                buf = self._pinned.get(f"{name}:{k}")
                if buf is None or buf.shape != v.shape or buf.dtype != v.dtype:
                    buf = torch.empty(v.shape, dtype=v.dtype).pin_memory()
                    self._pinned[f"{name}:{k}"] = buf
                buf.copy_(v.detach(), non_blocking=True)
                host[name][k] = buf.numpy()
        copied = torch.cuda.Event()
        copied.record()
        return host, copied.synchronize

    def checkpoint_wait(self) -> None:
        """Durability barrier for async saves: returns once no checkpoint
        write is in flight, re-raising any writer failure (under a mesh,
        once rank 0's write landed, on every rank)."""
        if self._ckpt_writer is not None:
            self._ckpt_writer.wait()
        self._mesh_barrier()

    def load(self, save_dir: str, pass_id: Optional[int] = None) -> None:
        """Restore the parameters, states, optimizer slots and `t`, the
        model averages and the counters from a checkpoint (this package's or
        the JAX package's, which holds no rng or diverged: those stay;
        pass_id=None takes the newest), copying every value into the state's
        own storage, so captured step graphs stay valid. A reference v1
        model directory restores the parameters only. The optimizer tree is
        read in the canonical layout and re-laid by the updater, so a
        checkpoint loads under any ZeRO mode and world size; one whose
        shapes or keys do not match that layout at all (a raw per-rank
        tree) raises, naming both world sizes."""
        assert self.state is not None, "init_state() with a sample batch first"
        self.checkpoint_wait()  # never read a checkpoint that is mid-write
        canon = self._canonical_trees()
        params, states, opt, manifest = ckpt.load_pass(
            save_dir, pass_id, params_template=lambda: {
                k: np.empty(tuple(v.shape), np.float32) for k, v in canon["params"].items()})
        self.load_params(params)
        if states:
            self._load("states", states)
        if opt:
            self._load_opt(save_dir, opt, manifest)
        extra = manifest.get("extra", {})
        st = self.state
        if extra.get("samples") is not None:
            st["samples"].fill_(int(extra["samples"]))
        if extra.get("lr_scale") is not None:
            st["lr_scale"].fill_(float(extra["lr_scale"]))
        if extra.get("rng") is not None:
            st["rng"].copy_(torch.tensor(extra["rng"], dtype=torch.int64))
        if extra.get("diverged") is not None:
            st["diverged"].fill_(int(extra["diverged"]))
            self._diverged_seen = int(extra["diverged"])

    def _load_opt(self, save_dir: str, opt: Mapping[str, Any], manifest) -> None:
        up = self.updater
        template = {"opt": up.to_canonical(self.state["opt"])}
        if self.state["avg"]:
            template["avg"] = {**self.state["avg"],
                               "avg": up.params_to_canonical(self.state["avg"]["avg"])}

        def raw_shard_error(reason: str) -> ValueError:
            found = manifest.get("extra", {}).get("world_size")
            return ValueError(
                f"checkpoint under {save_dir!r} holds optimizer state that does not match "
                f"this trainer's canonical layout: {reason}. The checkpoint records "
                f"world_size={found}, this trainer runs world_size={self._world()}; "
                "canonical checkpoints are world-size-portable, so the opt tree was saved "
                "as raw per-shard state — re-export it through the updater's "
                "to_canonical seam before resuming")

        mism = ckpt.tree_shape_mismatches(template, opt)
        if mism:
            more = f" (+{len(mism) - 4} more)" if len(mism) > 4 else ""
            raise raw_shard_error("optimizer state shapes differ: " + "; ".join(
                f"{k}: expected {e} found {g}" for k, e, g in mism[:4]) + more)
        missing = [k for k in ckpt.tree_missing_keys(template, opt) if k.startswith("opt")]
        if missing:
            more = f" (+{len(missing) - 4} more)" if len(missing) > 4 else ""
            names = ", ".join(missing[:4]) + more
            if len(missing) == len(ckpt.tree_missing_keys({"opt": template["opt"]}, {})):
                raise raw_shard_error(f"no entry for {names}, so restore_tree would "
                                      "silently keep freshly-initialized slots")
            log.warning("checkpoint %s: optimizer state has no entry for %s; those slots "
                        "start fresh, everything else resumes", save_dir, names)
        restored = ckpt.restore_tree(template, opt)
        new = {"opt": up.from_canonical(restored["opt"])}
        if "avg" in restored:
            new["avg"] = {**restored["avg"],
                          "avg": up.params_from_canonical(restored["avg"]["avg"])}
        own = ckpt.flatten_tree({k: self.state[k] if k == "avg" else self.state["opt"]
                                 for k in new}, leaf=_leaf)
        with torch.no_grad():
            for k, v in ckpt.flatten_tree(new, leaf=_leaf).items():
                own[k].copy_(v)


def _leaf(x: Any) -> Any:
    return x


def host_copy(value: torch.Tensor):
    """(host copy, event) of a device value: a non-blocking copy into pinned
    memory and the event that says it landed; on the CPU a plain copy and
    no event."""
    if value.device.type != "cuda":
        return value.detach().clone(), None
    host = torch.empty(value.shape, dtype=value.dtype).pin_memory()
    host.copy_(value.detach(), non_blocking=True)
    copied = torch.cuda.Event()
    copied.record()
    return host, copied


def _feed(raw: Any, feeder: Optional[Callable]) -> Batch:
    """A reader item as a batch dict: dicts pass, sample lists go through
    the feeder."""
    if feeder is not None and not isinstance(raw, Mapping):
        return feeder(raw)
    return raw


def _signature(batch: Batch) -> tuple:
    """Shape and dtype of every slot: batches that stack."""
    return tuple(sorted((k, tuple(np.shape(v)), str(getattr(v, "dtype", type(v).__name__)))
                        for k, v in batch.items()))


def _stack(batches: List[Batch]) -> Dict[str, Any]:
    """Same-signature batches stacked on a new leading axis (torch tensors
    with torch, anything else with numpy); a rank's cuts stay its cut."""
    out = {k: (torch.stack if isinstance(v, torch.Tensor) else np.stack)(
        [b[k] for b in batches]) for k, v in batches[0].items()}
    return _same_plan(out, batches[0], k=len(batches))


def _unstack(batches: Batch, i: int) -> Dict[str, Any]:
    return _same_plan({k: v[i] for k, v in batches.items()}, batches)


def _same_plan(values: Dict[str, Any], src: Batch, k: int = 1) -> Dict[str, Any]:
    """`values` tagged as the cut of `src`'s DataParallel plan, if it has one."""
    plan = getattr(src, "plan", None)
    if plan is None:
        return values
    from paddle_tpu_torch.parallel.data_parallel import ShardedBatch

    out = ShardedBatch(values)
    out.plan, out.k = plan, k
    return out


def _stack_size(batches: Batch) -> int:
    return int(np.shape(next(iter(batches.values())))[0])


def _batch_size(batch: Mapping[str, Any]) -> int:
    for k, v in batch.items():
        if not k.endswith(".lengths") and k not in _RESERVED:
            return int(np.shape(v)[0])
    raise ValueError("empty batch")


def _merge_window(batches: Batch) -> Dict[str, Any]:
    """zero2's window: a rank's K stacked batches ([K, b, ...] a slot) as
    one [K*b] batch of its rows (the rows never leave the rank); the masks
    concatenate and the real row counts add up."""
    out: Dict[str, Any] = {}
    for k, v in batches.items():
        shape = tuple(np.shape(v))
        if k == SAMPLE_COUNT_KEY:
            out[k] = v.sum(0) if isinstance(v, torch.Tensor) else np.asarray(v).sum(0)
        else:
            out[k] = v.reshape((shape[0] * shape[1],) + shape[2:])
    return out


def _gather_rows(mesh, v: torch.Tensor) -> torch.Tensor:
    """Every rank's [b, ...] rows of `v`, rank by rank: [n*b, ...]."""
    full = mesh.all_gather(v.reshape(1, -1))
    return full.reshape((mesh.extent("data") * v.shape[0],) + tuple(v.shape[1:]))


def _tree_bytes(tree: Any) -> int:
    return stats.tensor_bytes(ckpt.flatten_tree(tree, leaf=_leaf).values())


def _poison_batch(batch: Batch) -> Dict[str, Any]:
    """The nan_loss fault: NaN out the first float slot (shape and dtype
    unchanged, so the same graph replays it). A batch of ids only (seq2seq)
    gets its first id slot set past every vocabulary instead: the embedding
    reads such an id as a NaN row (jnp.take's fill mode, `layers.take_rows`);
    the JAX package's fault refuses such a batch."""
    slots = [(k, v) for k, v in batch.items()
             if not k.endswith((".lengths", ".sub_lengths")) and k not in _RESERVED]
    for k, v in slots:
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            return {**batch, k: v * float("nan")}
        if not isinstance(v, torch.Tensor) and np.issubdtype(np.asarray(v).dtype, np.floating):
            return {**batch, k: np.asarray(v) * np.float32("nan")}
    for k, v in slots:
        if isinstance(v, torch.Tensor) and not v.is_floating_point():
            return {**batch, k: torch.full_like(v, torch.iinfo(v.dtype).max)}
        if not isinstance(v, torch.Tensor) and np.issubdtype(np.asarray(v).dtype, np.integer):
            a = np.asarray(v)
            return {**batch, k: np.full_like(a, np.iinfo(a.dtype).max)}
    raise ValueError("nan_loss fault: batch has no float or id slot to poison")
