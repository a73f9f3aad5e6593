"""The fluid Executor (counterpart of `paddle_tpu/fluid/executor.py`;
framework/executor.cc:81 Executor::Run).

`run(program, feed, fetch_list, scope, train, use_jit, rng)` interprets the
global block op by op on torch tensors on the executor's device: the
persistable values come from the scope, the feeds are added, the ops run
(`_run_ops`, with the `backward`, `recurrent`, `while` and `cond` ops
handled here), the new persistable values go back into the scope and the
fetches come back as numpy arrays (one host read a run: that is the API).

On the card, `use_jit=True` runs each signature as the training step does
(`trainer/step_graph.py`): the first two runs of a signature are eager and
the second is then captured as one CUDA graph, which every later run
replays. The signature is the JAX package's compile key (program id, op
count, `train`, the fetch names, the persistable names, the feed shapes
and dtypes) plus whether an `rng` was given and the scope. What makes the
capture legal:
  * the persistable values live in the scope's own tensors and a graphed
    run writes their new values into them (`copy_`), never rebinding them;
    a scope entry replaced between runs is copied back into the graph's
    tensor before the next replay;
  * the run's key is `fold_in(PRNGKey(seed), run count)` as in the JAX
    package, computed inside the graph from a device counter the host
    writes before each replay (a given `rng` is copied into a buffer);
  * `load` is read once per signature (the JAX package reads it once at
    trace time) and `save` writes after each replay from a buffer the
    graph fills (`ops.py`).
A program with a `while` op (its trip count is a device value) or a
`precision_recall` without `class_number` runs eagerly on the card every
time (`graphable`), reading the condition once an iteration. `use_jit=False`
is the eager interpreter on whatever device the executor has; on the CPU
both flags run eagerly: the name is kept for API fidelity.

Gradients: a block holding a `backward` op (`append_backward`) runs with
the listed parameters as autograd leaves, and the op takes
`torch.autograd.grad` of sum(loss) over the ops before it. The JAX package
re-traces those ops under `jax.grad` with the same key, so dropout repeats
its masks there; here the one forward is differentiated, with the same
result. Control flow: `recurrent` is a loop over time, `while` a host loop,
`cond` runs the true and then the false block and selects with
`torch.where` (the JAX package's per-sample form; for the pure sub-blocks
the executor builds it equals `lax.cond`). The JAX package traces each
sub-block once, so a random op inside one draws the same key at every
step: each iteration here restarts the context's draw count."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from paddle_tpu_torch.core import prng
from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.fluid import ops as ops_mod
from paddle_tpu_torch.fluid.framework import Block, OpDesc, Program, Scope, VarDesc, Variable
from paddle_tpu_torch.fluid.lod import LoDTensor
from paddle_tpu_torch.trainer.step_graph import StepGraph


def _init_value(vd: VarDesc, key: Callable[[], torch.Tensor],
                device: torch.device) -> torch.Tensor:
    init = vd.initializer
    shape = tuple(vd.shape or ())
    dtype = ops_mod.torch_dtype(vd.dtype)
    if isinstance(init, np.ndarray):
        return ops_mod.as_tensor(init, device)
    if isinstance(init, tuple):
        kind = init[0]
        if kind == "constant":
            return torch.full(shape, init[1], dtype=dtype, device=device)
        if kind == "uniform":
            return prng.uniform(key(), shape, init[1], init[2]).to(dtype)
        if kind == "normal":
            return (init[1] + init[2] * prng.normal(key(), shape)).to(dtype)
        raise ValueError(f"unknown initializer {init!r} for {vd.name}")
    return torch.zeros(shape, dtype=dtype, device=device)


def _stable_key(name: str, seed: int, device: torch.device) -> torch.Tensor:
    """fold_in(PRNGKey(seed), FNV-1a hash of the name), the JAX package's
    per-variable initializer key."""
    h = 2166136261
    for ch in name.encode():
        h = ((h ^ ch) * 16777619) & 0x7FFFFFFF
    return prng.fold_in(prng.PRNGKey(seed, device), h)


def graphable(program: Program) -> bool:
    """Whether a run of `program` can be captured as one CUDA graph: no
    `while` op in any block (its trip count is read on the host each
    iteration) and no `precision_recall` without a `class_number`."""
    return not any(
        op.type == "while"
        or (op.type == "precision_recall" and "class_number" not in op.attrs)
        for b in program.blocks for op in b.desc.ops)


def scope_from_arrays(values: Mapping[str, Any], device: DeviceLike = None) -> Scope:
    """A Scope holding `values` (e.g. a JAX package Scope's values as numpy
    arrays, by name) as tensors on `device`; `Scope.numpy()` reads them
    back. So both executors can start from the same parameters."""
    dev = resolve_device(device)
    scope = Scope()
    for name, v in values.items():
        scope.set(name, ops_mod.as_tensor(v, dev))
    return scope


def _host_feed(v: Any) -> torch.Tensor:
    """A fed value as a tensor (on the host unless given on the card),
    64-bit dtypes narrowed to 32 as in the JAX package."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype=ops_mod.torch_dtype(v.dtype))
    return ops_mod.as_tensor(v, torch.device("cpu"))


def _to_numpy(v: Any) -> np.ndarray:
    if isinstance(v, LoDTensor):
        v = v.data
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _on(v: Any, device: torch.device) -> Any:
    return v.to(device) if isinstance(v, LoDTensor) else ops_mod.as_tensor(v, device)


def _detach(v: Any) -> Any:
    return v.detach() if isinstance(v, torch.Tensor) else v


def _private(v: Any, storages: set) -> Any:
    """`v`, or a copy of it where it shares storage with a tensor the run
    rewrites in place (a reshape of an updated parameter): the value of
    the run, as the JAX package's immutable arrays give it."""
    if isinstance(v, torch.Tensor) and v.untyped_storage().data_ptr() in storages:
        return v.clone()
    return v


def _write_in_place(own: Dict[str, torch.Tensor], new: Dict[str, Any]) -> None:
    """Copy each persistable's new value into its own tensor; a new value
    that aliases one of those tensors is copied out first."""
    storages = {t.untyped_storage().data_ptr() for t in own.values()}
    new = {n: v if v.data_ptr() == own[n].data_ptr() else _private(v, storages)
           for n, v in new.items()}
    with torch.no_grad():
        for n, v in new.items():
            if v.data_ptr() != own[n].data_ptr():
                own[n].copy_(v)


class Executor:
    """Executor(place).run(program, feed, fetch_list) parity. `place` is
    kept for API fidelity; the device is `device` (None means CUDA and
    raises without a card; the CPU runs only when asked for). Under f32 on
    the card TF32 goes off for cuBLAS and cuDNN, as in the trainer.

    `graphs` maps a signature to its captured run (`StepGraph`, whose
    `replays` counts the replays); `eager_runs` counts the runs that ran
    op by op."""

    def __init__(self, place: Any = None, seed: int = 0, device: DeviceLike = None):
        self.place = place
        self.seed = seed
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.graphs: Dict[Tuple, StepGraph] = {}
        self.eager_runs = 0
        self._runs_of: Dict[Tuple, int] = {}
        self._graph_state: Dict[Tuple, dict] = {}
        self._consts: Dict[Tuple, Dict[str, torch.Tensor]] = {}
        self._run_count = 0  # per-run rng fold so dropout masks differ
        self._base_key = prng.PRNGKey(seed, self.device)
        # the run count on the device: a graph folds it into its key
        self._counter = torch.zeros((), dtype=torch.int64, device=self.device)
        self._scope: Optional[Scope] = None

    # -- startup (the reference's startup ProgramDesc role) -----------------
    def initialize(self, program: Program, scope: Scope) -> None:
        for name, vd in program.global_block().desc.vars.items():
            if vd.persistable and not scope.has(name):
                scope.set(name, _init_value(
                    vd, lambda: _stable_key(name, self.seed, self.device), self.device))

    # -- eager interpretation ------------------------------------------------
    def _run_ops(self, block: Block, values: Dict[str, Any],
                 ctx: ops_mod.OpContext) -> Dict[str, Any]:
        for op in block.desc.ops:
            if op.type == "backward":
                self._run_backward(block, op, values, ctx)
                continue
            if op.type == "recurrent":
                self._run_recurrent(block, op, values, ctx)
                continue
            if op.type == "while":
                self._run_while(block, op, values, ctx)
                continue
            if op.type == "cond":
                self._run_cond(block, op, values, ctx)
                continue
            fn = ops_mod.OPS.get(op.type)
            ins = {
                slot: [values[n] for n in names]
                for slot, names in op.inputs.items()
                if all(n in values for n in names)
            }
            outs = fn(ctx, ins, op.attrs)
            for slot, names in op.outputs.items():
                got = outs.get(slot)
                if got is None:
                    continue
                if isinstance(got, list):
                    for n, v in zip(names, got):
                        values[n] = v
                else:
                    values[names[0]] = got
        return values

    def _run_backward(self, block: Block, op: OpDesc, values: Dict[str, Any],
                      ctx: ops_mod.OpContext) -> None:
        """The append_backward op: the gradients of sum(loss) with respect
        to the parameters' leaves (`_execute` made them), written as
        `<param>@GRAD`; every value is detached after it, so the optimizer
        ops record nothing for autograd."""
        loss = values[op.attrs["loss"]]
        params = op.attrs["params"]
        leaves = [ctx.leaves[p] for p in params]
        if loss.requires_grad:
            grads = torch.autograd.grad(loss.sum(), leaves, allow_unused=True,
                                        materialize_grads=True)
        else:
            grads = [torch.zeros_like(v) for v in leaves]
        for k, v in list(values.items()):
            values[k] = _detach(v)
        for p, g in zip(params, grads):
            values[p + "@GRAD"] = g

    # -- control flow (cond_op.cc:231 / recurrent_op.cc:222 / while) ---------

    def _sub_block(self, block: Block, idx: int) -> Block:
        return block.program.blocks[idx]

    def _run_recurrent(self, block, op, values, ctx) -> None:
        """recurrent_op.cc:222 as a loop over time. Attrs: sub_block: int;
        seq_ins: {block_var: parent_seq_var} ([B, T, ...], sliced per step
        as [B, ...]); states: {block_pre_state: (boot_var, block_state)};
        seq_outs: {parent_out: block_var} (stacked [B, T, ...])."""
        sub = self._sub_block(block, op.attrs["sub_block"])
        seq_ins: Dict[str, str] = op.attrs.get("seq_ins", {})
        states: Dict[str, Any] = op.attrs.get("states", {})
        seq_outs: Dict[str, str] = op.attrs.get("seq_outs", {})
        reverse = bool(op.attrs.get("reverse", False))

        base = {k: v for k, v in values.items() if k not in seq_ins.values()}
        carry = {pre: values[boot] for pre, (boot, _st) in states.items()}
        t_len = values[next(iter(seq_ins.values()))].shape[1]
        stacked: Dict[str, List[Any]] = {pv: [None] * t_len for pv in seq_outs}
        count0 = ctx._count
        for t in (range(t_len - 1, -1, -1) if reverse else range(t_len)):
            ctx._count = count0  # lax.scan traces the body once
            local = dict(base)
            local.update({bv: values[pv][:, t] for bv, pv in seq_ins.items()})
            local.update(carry)
            local = self._run_ops(sub, local, ctx)
            carry = {pre: local[st] for pre, (_b, st) in states.items()}
            for pv, bv in seq_outs.items():
                stacked[pv][t] = local[bv]
        for pv, seq in stacked.items():
            values[pv] = torch.stack(seq, 1)
        for pre, (_b, st) in states.items():
            values[f"{op.attrs.get('name', 'recurrent')}.{st}@LAST"] = carry[pre]

    def _run_while(self, block, op, values, ctx) -> None:
        """The while op: a host loop that reads the condition (a scalar bool
        var the sub-block recomputes) once an iteration. Attrs: sub_block,
        cond, carry (var names carried across iterations)."""
        sub = self._sub_block(block, op.attrs["sub_block"])
        carry_names = list(op.attrs["carry"])
        cond_name = op.attrs["cond"]
        base = {k: v for k, v in values.items() if k not in carry_names}
        names = {cond_name, *carry_names}
        carry = {n: values[n] for n in names}
        count0 = ctx._count
        while bool(torch.as_tensor(carry[cond_name]).reshape(())):
            ctx._count = count0  # lax.while_loop traces the body once
            local = dict(base)
            local.update(carry)
            local = self._run_ops(sub, local, ctx)
            carry = {n: local[n] for n in names}
        values.update(carry)

    def _run_cond(self, block, op, values, ctx) -> None:
        """cond_op.cc:231: the true block, then the false block (or the
        outer values, broadcast to the true block's shapes), each on the
        full batch, selected by the condition: a scalar picks one branch's
        outputs, a vector (per-sample condition) picks rows. For pure
        sub-blocks this equals the reference's scope split / merge and the
        JAX package's lax.cond, with its rng counts."""
        cond = values[op.attrs["cond"]]
        true_b = self._sub_block(block, op.attrs["true_block"])
        false_b = (
            self._sub_block(block, op.attrs["false_block"])
            if op.attrs.get("false_block") is not None
            else None
        )
        out_names = list(op.attrs["outs"])
        base = dict(values)

        def run_block(sub):
            local = self._run_ops(sub, dict(base), ctx)
            return [local[n] for n in out_names]

        if false_b is None:
            missing = [n for n in out_names if n not in base]
            if missing:
                raise KeyError(
                    f"cond op: outputs {missing} are not defined outside the "
                    "true block, so there is no passthrough value for the "
                    "false branch — provide a false_block"
                )

        count0 = ctx._count
        t_outs = run_block(true_b)
        if false_b is not None:
            f_outs = run_block(false_b)
        else:
            # the JAX package traces the true block again for the
            # passthrough's shapes (jax.eval_shape), drawing its keys twice
            ctx._count += ctx._count - count0
            f_outs = [torch.broadcast_to(ops_mod.as_tensor(base[n], t.device),
                                         t.shape).to(t.dtype)
                      for n, t in zip(out_names, t_outs)]
        cond_t = torch.as_tensor(cond)
        if cond_t.numel() == 1:
            mask = cond_t.reshape(()).bool()
            outs = [torch.where(mask, t, f) for t, f in zip(t_outs, f_outs)]
        else:
            mask = cond_t.reshape(-1).bool()
            outs = [torch.where(mask.reshape((-1,) + (1,) * (t.ndim - 1)), t, f)
                    for t, f in zip(t_outs, f_outs)]
        values.update(dict(zip(out_names, outs)))

    def _execute(self, block: Block, values: Dict[str, Any], ctx: ops_mod.OpContext,
                 fetch_names: Sequence[str], persist: Sequence[str]):
        """One run of `block` from `values` -> (the fetches, {persistable
        name: new value}). The parameters a `backward` op lists become
        autograd leaves first; without one, autograd records nothing."""
        params = [p for op in block.desc.ops if op.type == "backward"
                  for p in op.attrs["params"]]
        with torch.set_grad_enabled(bool(params)):
            for p in params:
                values[p] = ctx.leaves[p] = values[p].detach().requires_grad_(True)
            values = self._run_ops(block, values, ctx)
        return ([_detach(values[n]) for n in fetch_names],
                {n: _detach(values[n]) for n in persist})

    # -- public API ----------------------------------------------------------
    def run(
        self,
        program: Program,
        feed: Optional[Dict[str, Any]] = None,
        fetch_list: Sequence[Union[str, Variable]] = (),
        scope: Optional[Scope] = None,
        train: bool = True,
        use_jit: bool = True,
        rng: Optional[Any] = None,
    ) -> List[np.ndarray]:
        scope = scope if scope is not None else self._scope
        if scope is None:
            scope = self._scope = Scope()
        self.initialize(program, scope)
        feed = {k: _host_feed(v) for k, v in (feed or {}).items()}
        fetch_names = [f.name if isinstance(f, Variable) else f for f in fetch_list]
        block = program.global_block()
        persist = sorted(
            n for n, vd in block.desc.vars.items()
            if vd.persistable and scope.has(n)
        )
        self._run_count += 1
        if rng is not None:
            rng = ops_mod.as_tensor(rng, self.device).to(torch.int64) & 0xFFFFFFFF
        key = (
            id(program), len(block.desc.ops), train, tuple(fetch_names),
            tuple(persist),
            tuple(sorted((k, tuple(v.shape), str(v.dtype)) for k, v in feed.items())),
        )
        consts = self._consts.setdefault(key, {}) if use_jit else None
        graph_mode = use_jit and self.device.type == "cuda" and graphable(program)
        if not graph_mode:
            return self._run_eager(block, scope, feed, fetch_names, persist, train, rng,
                                   consts, in_place=False)
        gkey = key + (rng is not None, id(scope))
        graph = self.graphs.get(gkey)
        if graph is not None:
            return self._replay(gkey, graph, scope, feed, rng)
        self._runs_of[gkey] = n = self._runs_of.get(gkey, 0) + 1
        for name in persist:  # the graph reads and writes the scope's own tensors
            v = scope.find(name)
            if (name not in scope.values or not isinstance(v, torch.Tensor)
                    or v.device != self.device):
                scope.set(name, ops_mod.as_tensor(v, self.device).clone())
        out = self._run_eager(block, scope, feed, fetch_names, persist, train, rng,
                              consts, in_place=True)
        if n >= 2:
            self._capture(gkey, block, scope, feed, fetch_names, persist, train, rng,
                          consts)
        return out

    def _rng_fn(self, rng: Optional[torch.Tensor]) -> Callable[[], torch.Tensor]:
        if rng is not None:
            return lambda: rng
        count = self._run_count
        return lambda: prng.fold_in(self._base_key, count)

    def _run_eager(self, block, scope, feed, fetch_names, persist, train, rng, consts,
                   in_place: bool) -> List[np.ndarray]:
        """One run op by op. `in_place` writes the new persistable values
        into the scope's tensors (graph signatures on the card), else the
        scope's entries are rebound to them, as in the JAX package."""
        self.eager_runs += 1
        ctx = ops_mod.OpContext(rng=self._rng_fn(rng), train=train, device=self.device,
                                consts=consts)
        values = {n: _on(scope.find(n), self.device) for n in persist}
        values.update({k: v.to(self.device) for k, v in feed.items()})
        fetches, new = self._execute(block, values, ctx, fetch_names, persist)
        out = [_to_numpy(v) for v in fetches]  # before any in-place write
        own = {n: scope.find(n) for n in new}
        same = {n: v for n, v in new.items()
                if in_place and isinstance(own[n], torch.Tensor)
                and isinstance(v, torch.Tensor) and own[n].shape == v.shape
                and own[n].dtype == v.dtype}
        _write_in_place({n: own[n] for n in same}, same)
        for n, v in new.items():
            if n not in same:
                scope.set(n, v)
        return out

    def _capture(self, gkey, block, scope, feed, fetch_names, persist, train, rng,
                 consts) -> None:
        """Capture the signature's run as one CUDA graph over the scope's
        tensors (`StepGraph`: static feed buffers, prints and launch
        counts)."""
        own = {n: scope.find(n) for n in persist}
        saves: List[tuple] = []
        rng_buf = torch.zeros(2, dtype=torch.int64, device=self.device)
        given = rng is not None

        def body(feeds):
            ctx = ops_mod.OpContext(
                rng=(lambda: rng_buf) if given else
                (lambda: prng.fold_in(self._base_key, self._counter)),
                train=train, device=self.device, consts=consts, saves=saves)
            values = dict(own)
            values.update(feeds)
            fetches, new = self._execute(block, values, ctx, fetch_names, persist)
            for n, v in new.items():
                if v.shape != own[n].shape or v.dtype != own[n].dtype:
                    raise RuntimeError(
                        f"fluid graph: {n} changes from {tuple(own[n].shape)} "
                        f"{own[n].dtype} to {tuple(v.shape)} {v.dtype} in a run")
            storages = {t.untyped_storage().data_ptr() for t in own.values()}
            fetches = [_private(f, storages) for f in fetches]
            _write_in_place(own, new)
            zero = torch.zeros((), device=self.device)
            return zero, {str(i): f for i, f in enumerate(fetches)}

        self.graphs[gkey] = StepGraph(body, feed, 1, self.device)
        self._graph_state[gkey] = dict(own=own, saves=saves, rng_buf=rng_buf,
                                       n_fetch=len(fetch_names))

    def _replay(self, gkey, graph: StepGraph, scope: Scope, feed, rng) -> List[np.ndarray]:
        st = self._graph_state[gkey]
        with torch.no_grad():
            for n, t in st["own"].items():  # a rebound entry goes back in place
                cur = scope.find(n)
                if cur is not t:
                    t.copy_(ops_mod.as_tensor(cur, self.device))
                    scope.set(n, t)
            if rng is not None:
                st["rng_buf"].copy_(rng)
            else:
                self._counter.fill_(self._run_count)
        _, fetches = graph.replay(feed)
        for path, overwrite, buf in st["saves"]:
            ops_mod.save_array(path, buf, overwrite)
        return [_to_numpy(fetches[str(i)]) for i in range(st["n_fetch"])]
