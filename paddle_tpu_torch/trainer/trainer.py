"""The training loop (counterpart of `SGDTrainer` in
`paddle_tpu/trainer/trainer.py`), the single-device path.

One step is the JAX package's compiled step: the lr comes from the
schedule at the samples counter BEFORE the step (computed on the host and
copied into a 0-d f32 tensor), the forward is `Network.apply` in train mode
under the trainer's dtype policy, the backward is autograd over the summed
costs, the optimizer writes the new parameters, its slots and its step
counter `t` into their own storage, the new states (batch norm's moving
statistics) are copied into theirs, and the samples counter advances by the
batch size. `multi_step(batches)` runs K same-shape batches stacked on a
leading axis in one dispatch (the counterpart of `make_multi_step`).

On the card the first `step` or `multi_step` of each batch signature runs
eagerly, as a real step and as the warm-up (kernel builds and plans,
cuBLAS's workspace); then the trainer captures that dispatch as one CUDA
graph (`step_graph.py`) and every later dispatch of the signature copies
its batch into the graph's static inputs and replays it. There is no switch
that turns the graph off, and a failed capture raises. The CPU runs every
step eagerly: it has no graphs.

`train(reader, num_passes, event_handler, feeder, test_reader, save_dir,
auto_resume, keep_last_n, steps_per_dispatch, async_checkpoint)` runs
passes over a reader of batches: dicts of arrays (`<slot>` and
`<slot>.lengths`), or lists of samples that `feeder` (a `data.DataFeeder`)
turns into them; it fires BeginPass / BeginIteration / EndIteration /
EndPass, tests on `test_reader` at each pass end, and with `save_dir`
writes a checkpoint there at each pass end (`save`; the JAX package's pass
directory, `checkpoint.py`). `auto_resume` restores the newest valid
checkpoint under `save_dir` and continues with the pass after it. `test`
averages the cost over a reader, weighted by batch size, with the moving
statistics.

`precision="f32"` (the default ambient policy) or `"bf16"` pins the dtype
policy when the trainer is built. Under f32 on the card the trainer turns
TF32 off for cuBLAS and cuDNN, process-wide: the reference's f32 is
`Precision.HIGHEST`, and autograd runs the backward's convs and matmuls
outside any context manager around the forward.

Not ported yet (ROADMAP.md): the lr schedules other than the constant one,
the divergence guard and rollback, the preemption drain, remat, model
averaging, the parallel updaters and elastic resize."""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from paddle_tpu_torch.core import dtypes, faults
from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.nn.graph import Layer, Network
from paddle_tpu_torch.optim import schedules
from paddle_tpu_torch.optim.optimizers import Optimizer
from paddle_tpu_torch.trainer import checkpoint as ckpt
from paddle_tpu_torch.trainer.events import BeginIteration, BeginPass, EndIteration, EndPass
from paddle_tpu_torch.trainer.step_graph import StepGraph

log = logging.getLogger("paddle_tpu_torch.trainer")

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
        # the lr multiplier a checkpoint carries (the JAX package's rollback
        # halves it); 1.0 unless a loaded checkpoint says otherwise
        self.lr_scale = 1.0
        # (K, batch signature) -> the captured dispatch (CUDA only)
        self.graphs: Dict[tuple, StepGraph] = {}
        self._lr: Optional[torch.Tensor] = None
        self._ckpt_writer: Optional[ckpt.AsyncCheckpointer] = None
        self._pinned: Dict[str, torch.Tensor] = {}
        self._pending_load: Optional[tuple] = None

    @property
    def precision(self) -> str:
        return self.policy.name

    # -- state ---------------------------------------------------------------
    def init_state(self, sample_batch: Batch) -> TrainState:
        """Create parameters (seeded from `seed`), states and optimizer
        slots; drops every captured graph (they point at the old state)."""
        params, states = self.network.init(sample_batch, seed=self.seed,
                                            device=self.device, policy=self.policy,
                                            with_states=True)
        self.optimizer.param_attrs = self.network.param_attrs
        self.state = {"params": params, "opt": self.optimizer.init_state(params),
                      "states": states, "samples": 0}
        self._lr = torch.zeros((), dtype=torch.float32, device=self.device)
        self.graphs.clear()
        return self.state

    def load_params(self, params: Mapping[str, Any]) -> None:
        """Replace the parameters' values (tensors or arrays, e.g. from
        `nn/convert.params_from_jax`); names and shapes must match. The
        values are copied into the parameters' own storage."""
        self._load("params", params)

    def load_states(self, states: Mapping[str, Any]) -> None:
        """Replace the states' values (e.g. a JAX state dict through
        `nn/convert.params_from_jax`), in their own storage."""
        self._load("states", states)

    def _load(self, kind: str, values: Mapping[str, Any]) -> None:
        assert self.state is not None, "call init_state() first"
        own = self.state[kind]
        if set(values) != set(own):
            raise KeyError(
                f"{kind} names differ: missing {sorted(set(own) - set(values))}, "
                f"unknown {sorted(set(values) - set(own))}")
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

    def _step_body(self, batch: Batch, lr: torch.Tensor) -> torch.Tensor:
        """One update in place at the 0-d lr tensor `lr` -> the step's cost.
        The body a CUDA graph captures: it reads no device value on the
        host and writes only into the state's own storage."""
        cost, grads, states = self.cost_grads_and_states(batch)
        self.optimizer.update(grads, self.state["opt"], self.state["params"], lr)
        own = self.state["states"]
        with torch.no_grad():
            for k, v in states.items():
                if v is not own[k]:
                    own[k].copy_(v)
        return cost

    def _lrs(self, k: int, bs: int) -> List[float]:
        """The schedule's lr before each of the next k steps of bs samples."""
        s = self.state["samples"]
        return [float(self.schedule(s + i * bs)) * self.lr_scale for i in range(k)]

    def _dispatch(self, batch: Batch, k: int) -> List[torch.Tensor]:
        """k steps on `batch` (one batch, or k stacked on a leading axis) ->
        their k costs. On the card: replay the signature's graph, or run the
        steps eagerly and capture them."""
        first = batch if k == 1 else _unstack(batch, 0)
        bs = _batch_size(first)
        lrs = self._lrs(k, bs)
        if self.device.type == "cuda":
            key = (k, _signature(batch))
            graph = self.graphs.get(key)
            if graph is not None:
                costs = list(graph.replay(batch, lrs))
            else:
                costs = self._eager(batch, k, lrs)
                self.graphs[key] = StepGraph(self._step_body, batch, k, self.device)
        else:
            costs = self._eager(batch, k, lrs)
        self.state["samples"] += k * bs
        return costs

    def _eager(self, batch: Batch, k: int, lrs: List[float]) -> List[torch.Tensor]:
        costs = []
        for i in range(k):
            self._lr.fill_(lrs[i])
            costs.append(self._step_body(batch if k == 1 else _unstack(batch, i),
                                         self._lr))
        return costs

    def step(self, batch: Batch) -> torch.Tensor:
        """One training step on `batch`; returns the step's cost (a device
        scalar of its own, no host sync)."""
        if self.state is None:
            self.init_state(batch)
        return self._dispatch(batch, 1)[0]

    def multi_step(self, batches: Batch) -> torch.Tensor:
        """K training steps in one dispatch: every slot of `batches` is
        stacked on a leading K axis. Returns the K costs as one device
        tensor [K]. The same updates as K calls of `step`, bit for bit on
        the CPU."""
        k = _stack_size(batches)
        if self.state is None:
            self.init_state(_unstack(batches, 0))
        return torch.stack(self._dispatch(batches, k))

    # -- loops -----------------------------------------------------------------
    def _ensure_state(self, batch: Batch) -> None:
        """Build the state from the first batch, then apply a deferred
        auto-resume load (the state's shapes were unknown until now)."""
        if self.state is None:
            self.init_state(batch)
        if self._pending_load is not None:
            pending, self._pending_load = self._pending_load, None
            self.load(*pending)

    def train(self, reader: Callable, num_passes: int = 1,
              event_handler: Optional[Callable] = None,
              feeder: Optional[Callable] = None,
              test_reader: Optional[Callable] = None,
              save_dir: Optional[str] = None, auto_resume: bool = False,
              keep_last_n: Optional[int] = None, steps_per_dispatch: int = 1,
              async_checkpoint: bool = True) -> TrainState:
        """`num_passes` passes over `reader()`, whose items are batch dicts
        or, with `feeder`, lists of samples. EndPass metrics carry avg_cost
        (one host sync per pass), batches, pass_seconds and, with
        `test_reader`, test_cost.

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
        continue with the pass after it; with a deterministic reader a run
        killed and resumed this way ends where an unbroken run ends. train()
        waits for the writer before it returns, and on its error path."""
        if steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got {steps_per_dispatch}")
        event_handler = event_handler or (lambda e: None)
        resume_pass: Optional[int] = None
        if auto_resume and save_dir is not None:
            self.checkpoint_wait()  # the scan must see completed writes
            resume_pass = ckpt.find_latest_valid_pass(save_dir)
            if resume_pass is not None:
                log.info("auto-resume: restoring from %s/pass-%05d (continuing at "
                         "pass %d)", save_dir, resume_pass, resume_pass + 1)
                if self.state is not None:
                    self.load(save_dir, resume_pass)
                else:  # the state's shapes are unknown until a batch arrives
                    self._pending_load = (save_dir, resume_pass)
        flushed = False
        try:
            for pass_id in range(num_passes):
                if resume_pass is not None and pass_id <= resume_pass:
                    continue  # completed by the run being resumed
                self._train_one_pass(reader, pass_id, event_handler, feeder,
                                     test_reader, save_dir, keep_last_n,
                                     steps_per_dispatch, async_checkpoint)
            if self._pending_load is not None:
                # every pass was checkpointed already: nothing ran, so build
                # the state from one batch and load the last checkpoint
                raw = next(iter(reader()), None)
                if raw is not None:
                    self._ensure_state(_feed(raw, feeder))
            self.checkpoint_wait()
            flushed = True
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
                        save_dir: Optional[str], keep_last_n: Optional[int],
                        steps_per_dispatch: int, async_checkpoint: bool) -> None:
        inj = faults.get()
        event_handler(BeginPass(pass_id))
        t0 = time.time()
        cost_sum: Optional[torch.Tensor] = None
        n = 0
        pending: List[Any] = []  # (batch_id, batch) waiting for a group

        def dispatch(first: int, last: int, batch: Batch, k: int) -> None:
            nonlocal cost_sum, n
            if inj.active and inj.fire("kill"):
                raise faults.InjectedKill(f"injected kill at pass {pass_id} batch {first}")
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

        for batch_id, raw in enumerate(reader()):
            batch = _feed(raw, feeder)
            self._ensure_state(batch)
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
        metrics: Dict[str, Any] = {
            "avg_cost": float(cost_sum) / n if n else 0.0,
            "batches": n, "pass_seconds": time.time() - t0,
        }
        if test_reader is not None:
            metrics["test_cost"] = self.test(test_reader, feeder)["cost"]
        if save_dir is not None and self.state is not None:
            self.save(save_dir, pass_id, keep_last_n=keep_last_n, async_=async_checkpoint)
        event_handler(EndPass(pass_id, metrics))

    def test(self, reader: Callable, feeder: Optional[Callable] = None) -> Dict[str, Any]:
        """Average cost over `reader()` (batch dicts, or sample lists with
        `feeder`), weighted by batch size; batch norm uses its moving
        statistics."""
        assert self.state is not None, "call train() or init_state() first"
        total, n = 0.0, 0
        with torch.no_grad():
            for raw in reader():
                batch = _feed(raw, feeder)
                bs = _batch_size(batch)
                total += float(self._cost(self.state["params"], batch, train=False)[0]) * bs
                n += bs
        return {"cost": total / max(n, 1), "samples": n}

    # -- checkpoints -----------------------------------------------------------
    def _trees(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The checkpoint's three trees as flat {key: tensor} dicts, keyed as
        the JAX package keys them."""
        return {
            "params": ckpt.flatten_tree(self.state["params"], leaf=_leaf),
            "states": ckpt.flatten_tree(self.state["states"], leaf=_leaf),
            "opt": ckpt.flatten_tree({"opt": self.state["opt"]}, leaf=_leaf),
        }

    def _meta(self) -> Dict[str, Any]:
        return {"samples": int(self.state["samples"]), "lr_scale": float(self.lr_scale),
                "world_size": 1}

    def save(self, save_dir: str, pass_id: int, keep_last_n: Optional[int] = None,
             async_: bool = False) -> str:
        """Write the parameters, states, optimizer slots and `t` and the
        samples counter as save_dir/pass-%05d (the JAX package's pass
        directory), so `load` is a true resume.

        async_=True: the training thread waits for the previous snapshot's
        write, starts the device-to-host copies into pinned buffers (kept
        for the next save) on the current stream — ordered before any later
        step's in-place update — and hands the file I/O to the writer
        thread, which waits for the copies' event first. The returned path
        is durable after `checkpoint_wait()`; train() and load() call it."""
        assert self.state is not None
        trees = self._trees()
        if not async_:
            host = {name: {k: v.detach().cpu().numpy() for k, v in flat.items()}
                    for name, flat in trees.items()}
            return ckpt.save_pass(save_dir, pass_id, host["params"], host["states"],
                                  host["opt"], extra_meta=self._meta(),
                                  keep_last_n=keep_last_n)
        if self._ckpt_writer is None:
            self._ckpt_writer = ckpt.AsyncCheckpointer()
        self._ckpt_writer.wait()  # the pinned buffers are free again
        host, ready = self._fetch(trees)
        return ckpt.save_pass_async(self._ckpt_writer, save_dir, pass_id, host["params"],
                                    host["states"], host["opt"], extra_meta=self._meta(),
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
        write is in flight, re-raising any writer failure."""
        if self._ckpt_writer is not None:
            self._ckpt_writer.wait()

    def load(self, save_dir: str, pass_id: Optional[int] = None) -> None:
        """Restore the parameters, states, optimizer slots and `t` and the
        samples counter from a checkpoint (this package's or the JAX
        package's; pass_id=None takes the newest), copying every value into
        the state's own storage, so captured step graphs stay valid. A
        reference v1 model directory restores the parameters only."""
        assert self.state is not None, "init_state() with a sample batch first"
        self.checkpoint_wait()  # never read a checkpoint that is mid-write
        params, states, opt, manifest = ckpt.load_pass(
            save_dir, pass_id, params_template=lambda: {
                k: np.empty(tuple(v.shape), np.float32)
                for k, v in self.state["params"].items()})
        self._load("params", params)
        if states:
            self._load("states", states)
        if opt:
            own = self._trees()["opt"]
            bad = [(k, tuple(opt[k].shape), tuple(v.shape)) for k, v in own.items()
                   if k in opt and tuple(opt[k].shape) != tuple(v.shape)]
            if bad:
                raise ValueError(f"checkpoint under {save_dir!r}: optimizer state shapes "
                                 f"differ (key, found, expected): {bad[:4]}")
            missing = [k for k in own if k not in opt]
            if len(missing) == len(own):
                raise ValueError(f"checkpoint under {save_dir!r} holds no entry of this "
                                 f"optimizer's state (e.g. {missing[:4]})")
            if missing:
                log.warning("checkpoint %s: optimizer state has no entry for %s; those "
                            "slots start fresh, everything else resumes",
                            save_dir, missing[:4])
            with torch.no_grad():
                for k, v in own.items():
                    if k in opt:
                        v.copy_(torch.from_numpy(np.asarray(opt[k])))
        extra = manifest.get("extra", {})
        if extra.get("samples") is not None:
            self.state["samples"] = int(extra["samples"])
        if extra.get("lr_scale") is not None:
            self.lr_scale = float(extra["lr_scale"])


def _leaf(x: Any) -> Any:
    return x


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
