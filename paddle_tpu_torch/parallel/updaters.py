"""The ParameterUpdater hierarchy (counterpart of
`paddle_tpu/parallel/updaters.py`): where parallelism plugs into the
trainer. The reference's `init / startPass / startBatch / update /
finishBatch / finishPass` protocol hides local SGD, the ring all-reduce or
the pserver; here `apply` runs inside the training step (and so inside its
CUDA graph) and writes the new parameters, slots, `t` and error-feedback
residuals into their own storage, as `Optimizer.update` does.

`apply(grads, opt_state, params, lr, cost, guard)` takes this rank's
gradients and cost (each already divided by the global row count, so the
ranks' values sum to the unsharded batch's), reduces them over the mesh,
and returns (the global cost, ok): with `guard`, ok is "the global cost is
finite", the same on every rank, and every write is `where(ok, new, old)`,
so a diverged step reverts on every rank.

  * SgdLocalUpdater: one rank, no collective (the mesh-less trainer).
  * IciAllReduceUpdater: one flat f32 all-reduce of every gradient and the
    cost (`DataParallel.reduce_grads`), then the same update on every rank.
  * ShardedUpdater (zero1): each non-static parameter is viewed as [n,
    chunk] (chunk aligned to the compression's `chunk_align`) and rank r
    owns row r. One reduce-scatter of the position-wise concatenated
    gradients (the cost rides as a last column), the optimizer step on the
    owned rows with the slots kept as [1, chunk] rows, one all-gather of
    the updated rows. Under bf16 / int8 the scatter leg is an all-to-all of
    the encoded rows and a local f32 sum (`compression.py`).
  * Zero2Updater: zero1's update, run once per K-batch window by the
    trainer's `multi_step` (gradient accumulation).
  * Zero3Updater: the parameters themselves live as [1, chunk] rows. Each
    layer's read of a flat parameter gathers it (`_Z3Gather`, whose
    backward hands the [n, chunk] gradient to an anchor the trainer
    differentiates), and `apply` reduce-scatters the concatenated gradients
    once and steps the owned rows; there is no trailing gather.

The canonical seams (`to_canonical` / `from_canonical`,
`params_to_canonical` / `params_from_canonical`) turn the flat rows back
into parameter shapes (all-gathers outside the step) and back, so a
checkpoint holds one layout that loads under any mode and world size.
`collective_bytes_per_step` / `collective_bytes_detail` keep the JAX
package's ring-convention byte model. Static parameters keep the
canonical per-parameter update (which leaves them as they are)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.nn.graph import ParamAttr
from paddle_tpu_torch.optim.optimizers import Optimizer, write_into
from paddle_tpu_torch.parallel import compression as compression_mod
from paddle_tpu_torch.parallel import distributed

Params = Dict[str, torch.Tensor]


class ParameterUpdater:
    """The reference protocol (ParameterUpdater.h:38)."""

    # ZeRO mode tag: None for the replicated updaters, "zero1" / "zero2" /
    # "zero3" on the sharded family
    mode: Optional[str] = None
    optimizer: Optimizer

    def init(self, params: Params) -> None:  # noqa: A003
        pass

    def start_pass(self) -> None:
        pass

    def finish_pass(self) -> None:
        pass

    def start_batch(self, batch_size: int) -> None:
        pass

    def finish_batch(self, cost: float) -> None:
        pass

    def apply(self, grads: Params, opt_state: Dict[str, Any], params: Params,
              lr: torch.Tensor, cost: torch.Tensor,
              guard: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        raise NotImplementedError

    # -- the training step's inputs ------------------------------------------
    def forward_inputs(self, params: Params, opt_state: Dict[str, Any]):
        """(the parameters the network reads, {name: leaf to differentiate},
        the Context.param resolver or None) for one step: by default each
        stored parameter is its own leaf."""
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        return leaves, leaves, None

    def eval_resolver(self, opt_state: Dict[str, Any]) -> Optional[Callable]:
        """The resolver of a forward without gradients (`test`)."""
        return None

    # -- optimizer-state and parameter layout seams ----------------------------
    def init_opt_state(self, params: Params) -> Dict[str, Any]:
        return self.optimizer.init_state(params)

    def to_canonical(self, opt_state: Dict[str, Any]) -> Dict[str, Any]:
        """Updater layout -> the optimizer's canonical per-parameter layout
        (what checkpoints store)."""
        return opt_state

    def from_canonical(self, opt_canonical: Dict[str, Any]) -> Dict[str, Any]:
        return opt_canonical

    def params_to_canonical(self, params: Params) -> Params:
        return params

    def params_from_canonical(self, params: Params) -> Params:
        return params

    def collective_bytes_per_step(self, steps_per_dispatch: int = 1) -> int:
        """Modeled bytes per rank crossing collectives per train step (ring
        convention: an all-reduce of M bytes moves 2M(n-1)/n per rank, each
        decomposed phase M(n-1)/n); 0 on one rank."""
        return 0

    def collective_bytes_detail(self, steps_per_dispatch: int = 1) -> Dict[str, Any]:
        """{"mode": ..., "per_leg": {leg: {"dtype", "bytes_per_step"}}}; {}
        on one rank."""
        return {}

    def rebind(self, parallel, params: Params) -> "ParameterUpdater":
        return self


class SgdLocalUpdater(ParameterUpdater):
    """Single-replica updater: the optimizer update in the step, no
    collective."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer

    def apply(self, grads, opt_state, params, lr, cost, guard=False):
        ok = torch.isfinite(cost) if guard else None
        self.optimizer.update(grads, opt_state, params, lr, ok=ok)
        return cost, ok


class IciAllReduceUpdater(SgdLocalUpdater):
    """The pserver / ring replacement: the gradients and the cost are
    summed over the mesh in one flat all-reduce, then every rank applies
    the same update."""

    def __init__(self, optimizer: Optimizer, parallel):
        super().__init__(optimizer)
        self.parallel = parallel
        self._grad_bytes = 0

    @property
    def mesh(self):
        return self.parallel.mesh

    def start_pass(self) -> None:
        if distributed.process_count() > 1:
            distributed.barrier("start_pass")

    def finish_pass(self) -> None:
        if distributed.process_count() > 1:
            distributed.barrier("finish_pass")

    def init_opt_state(self, params: Params) -> Dict[str, Any]:
        self._record_grad_bytes(params)
        return super().init_opt_state(params)

    def _record_grad_bytes(self, params: Params) -> None:
        self._grad_bytes = sum(
            int(np.prod(tuple(p.shape))) * p.element_size() for k, p in params.items()
            if not (self.optimizer.param_attrs.get(k) or ParamAttr()).is_static)

    def apply(self, grads, opt_state, params, lr, cost, guard=False):
        grads, cost = self.parallel.reduce_grads(grads, cost)
        return super().apply(grads, opt_state, params, lr, cost, guard)

    def collective_bytes_per_step(self, steps_per_dispatch: int = 1) -> int:
        n = self.parallel.data_axis_size
        if n <= 1:
            return 0
        return int(2 * self._grad_bytes * (n - 1) / n)

    def collective_bytes_detail(self, steps_per_dispatch: int = 1) -> Dict[str, Any]:
        total = self.collective_bytes_per_step(steps_per_dispatch)
        if not total:
            return {}
        return {"mode": "replicated",
                "per_leg": {"all_reduce": {"dtype": "grad", "bytes_per_step": total}}}

    def rebind(self, parallel, params: Params) -> "IciAllReduceUpdater":
        new = type(self)(self.optimizer, parallel)
        new._record_grad_bytes(params)
        return new


@dataclasses.dataclass
class _FlatGeom:
    """Flat geometry of one parameter: viewed as [n, chunk], zero-padded
    (chunk aligned for block quantization)."""

    shape: Tuple[int, ...]
    size: int
    chunk: int
    flat: bool  # False: the canonical treatment (static)


def _to_flat(x: torch.Tensor, n: int, chunk: int) -> torch.Tensor:
    """[*shape] -> the [n, chunk] zero-padded flat view."""
    xf = x.reshape(-1)
    pad = n * chunk - xf.shape[0]
    if pad:
        xf = torch.cat([xf, xf.new_zeros(pad)])
    return xf.reshape(n, chunk)


def _from_flat(x2: torch.Tensor, shape: Tuple[int, ...], size: int) -> torch.Tensor:
    return x2.reshape(-1)[:size].reshape(shape)


def _pack(arrays) -> torch.Tensor:
    """Row-aligned [m, w_i] arrays of any dtypes -> one [m, bytes] uint8
    buffer (a collective that moves rows but adds nothing can carry it)."""
    return torch.cat([a.contiguous().view(torch.uint8) for a in arrays], dim=1)


def _unpack(buf: torch.Tensor, like) -> Tuple[torch.Tensor, ...]:
    """Inverse of `_pack`, given (dtype, width) per array."""
    out, off = [], 0
    for dtype, width in like:
        nbytes = width * torch.empty((), dtype=dtype).element_size()
        out.append(buf[:, off:off + nbytes].contiguous().view(dtype))
        off += nbytes
    return tuple(out)


class ShardedUpdater(IciAllReduceUpdater):
    """ZeRO-1: reduce-scatter the gradients -> the optimizer step on this
    rank's 1/n of every flat parameter (the slots live as its [1, chunk]
    rows) -> all-gather the updated rows. With `none` compression and SGD
    the update is bitwise the replicated updater's (the same elementwise
    arithmetic on each element); Adam agrees to rounding."""

    mode = "zero1"

    def __init__(self, optimizer: Optimizer, parallel, compression: str = "none"):
        super().__init__(optimizer, parallel)
        self.compression = compression_mod.make(compression)
        self.n = parallel.data_axis_size
        self._geom: Dict[str, _FlatGeom] = {}

    @property
    def rank(self) -> int:
        return self.parallel.mesh.rank

    # -- layout ---------------------------------------------------------------
    def _param_geom(self, k: str, p: torch.Tensor) -> _FlatGeom:
        attr = self.optimizer.param_attrs.get(k) or ParamAttr()
        size = int(np.prod(tuple(p.shape))) if p.dim() else 1
        flat = not attr.is_static and self._resolves_replicated(k, attr, p)
        align = self.compression.chunk_align
        chunk = -(-size // self.n)
        chunk = -(-chunk // align) * align
        return _FlatGeom(tuple(p.shape), size, chunk, flat)

    def _resolves_replicated(self, k: str, attr: ParamAttr, p: torch.Tensor) -> bool:
        """Whether the declared axes resolve to replicated on this mesh
        (through the rules table, so tensor-parallel logical axes that do
        not bite on a data-only mesh still take the flat layout)."""
        axes = attr.logical_axes if attr.logical_axes is not None else attr.sharding
        if axes is None:
            return True
        spec = self.parallel.rules.spec_for(axes, self.parallel.mesh, ndim=p.dim(), param=k)
        return all(a is None for a in spec)

    def bind_geometry(self, params: Params) -> None:
        self._geom = {k: self._param_geom(k, p) for k, p in params.items()}

    def rebind(self, parallel, params: Params) -> "ShardedUpdater":
        new = type(self)(self.optimizer, parallel, compression=self.compression.name)
        new._record_grad_bytes(params)
        new.bind_geometry(params)
        return new

    def _row(self, x: torch.Tensor, k: str) -> torch.Tensor:
        """This rank's [1, chunk] row of a canonical tensor, as its own
        storage."""
        g = self._geom[k]
        r = self.rank
        return _to_flat(x, self.n, g.chunk)[r:r + 1].clone()

    def _gather_rows(self, row: torch.Tensor, k: str) -> torch.Tensor:
        """Every rank's [1, chunk] row of `k` -> the canonical tensor."""
        g = self._geom[k]
        full2 = self.parallel.mesh.all_gather(row.contiguous())
        return _from_flat(full2, g.shape, g.size)

    def _ef_init(self, k: str, dev: torch.device) -> torch.Tensor:
        # this rank's residual of its own (partial) gradient, [n, chunk]
        return torch.zeros((self.n, self._geom[k].chunk), dtype=torch.float32, device=dev)

    def init_opt_state(self, params: Params) -> Dict[str, Any]:
        self._record_grad_bytes(params)
        self.bind_geometry(params)
        opt = self.optimizer
        dev = next(iter(params.values())).device
        slots = {}
        for k, p in params.items():
            g = self._geom[k]
            slots[k] = (opt.init_param_state(p) if not g.flat
                        else opt.init_param_state(p.new_zeros((1, g.chunk))))
        state: Dict[str, Any] = {"slots": slots,
                                 "t": torch.zeros((), dtype=torch.int32, device=dev)}
        if self.compression.uses_error_feedback:
            state["ef"] = {k: self._ef_init(k, dev) for k, g in self._geom.items() if g.flat}
        return state

    def to_canonical(self, opt_state: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(opt_state)
        out["slots"] = {k: ss if not self._geom[k].flat
                        else tuple(self._gather_rows(s, k) for s in ss)
                        for k, ss in opt_state["slots"].items()}
        if "ef" in opt_state:
            out["ef"] = {k: self._ef_to_canonical(e, k) for k, e in opt_state["ef"].items()}
        return out

    def _ef_to_canonical(self, e: torch.Tensor, k: str) -> torch.Tensor:
        # the ranks' residuals of their partial gradients sum to the
        # residual of the whole gradient
        g = self._geom[k]
        total = e.clone()
        self.parallel.mesh.all_reduce_(total)
        return _from_flat(total, g.shape, g.size)

    def _ef_from_canonical(self, e: torch.Tensor, k: str) -> torch.Tensor:
        g = self._geom[k]
        full2 = _to_flat(e.float(), self.n, g.chunk).clone()
        return full2 if self.rank == 0 else torch.zeros_like(full2)

    def from_canonical(self, opt_canonical: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(opt_canonical)
        out["slots"] = {k: ss if not self._geom[k].flat
                        else tuple(self._row(s, k) for s in ss)
                        for k, ss in opt_canonical["slots"].items()}
        if "ef" in opt_canonical:
            out["ef"] = {k: self._ef_from_canonical(e, k)
                         for k, e in opt_canonical["ef"].items()}
        return out

    # -- the scatter leg --------------------------------------------------------
    def _scatter(self, arrays, cost: torch.Tensor, reduce_in_collective: bool):
        """Every rank's [n, w] payload arrays (positions of one encoding)
        and cost -> (this rank's rows of each position, summed over ranks;
        the global cost). `reduce_in_collective`: one f32 reduce-scatter
        with the cost as a last column; else an all-to-all of the packed
        rows (the cost's bytes last) and a local f32 sum after decoding, so
        the result is a tuple of [n, w] per-rank contributions to decode
        and add (`_sum_rows`)."""
        mesh = self.parallel.mesh
        n = self.n
        costs = cost.float().reshape(1, 1).expand(n, 1)
        if reduce_in_collective:
            (cat,) = arrays
            row = mesh.reduce_scatter(torch.cat([cat, costs], dim=1))
            return (row[:, :-1],), row[0, -1]
        like = [(a.dtype, a.shape[1]) for a in arrays] + [(torch.float32, 1)]
        recv = mesh.all_to_all(_pack(list(arrays) + [costs]))
        parts = _unpack(recv, like)
        return parts[:-1], parts[-1].sum()

    # -- the sharded update (runs inside the step) ------------------------------
    def apply(self, grads, opt_state, params, lr, cost, guard=False):
        opt, comp, n, r = self.optimizer, self.compression, self.n, self.rank
        t_new = opt_state["t"] + 1
        ef = opt_state.get("ef")
        flat_keys = [k for k in params if self._geom[k].flat]
        opt._step_constants = opt.step_constants(t_new)
        try:
            payloads, new_ef = [], {}
            for k in flat_keys:
                g2 = _to_flat(grads[k].float(), n, self._geom[k].chunk)
                payload, nef = comp.encode_scatter(g2, None if ef is None else ef[k])
                payloads.append(payload)
                if nef is not None:
                    new_ef[k] = nef
            if not flat_keys:
                payloads = [(cost.new_zeros((n, 0)),)]
            widths = [[a.shape[1] for a in p] for p in payloads]
            cats = tuple(torch.cat(arrs, dim=1) for arrs in zip(*payloads))
            parts, cost = self._scatter(cats, cost, comp.reduces_in_collective)
            ok = torch.isfinite(cost) if guard else None
            gathers, offs = [], [0] * len(parts)
            fulls = {}
            for i, k in enumerate(flat_keys):
                g = self._geom[k]
                piece = []
                for j, part in enumerate(parts):
                    piece.append(part[:, offs[j]:offs[j] + widths[i][j]])
                    offs[j] += widths[i][j]
                g_row = comp.decode_scatter(tuple(piece))
                if not comp.reduces_in_collective:
                    g_row = g_row.sum(dim=0, keepdim=True)  # every rank's share
                fulls[k] = p_full2 = _to_flat(params[k], n, g.chunk)
                p2 = p_full2[r:r + 1]
                new_p2, new_s = opt.update_one(k, g_row, opt_state["slots"][k], p2, lr,
                                               t_new)
                for own, new in zip(opt_state["slots"][k], new_s):
                    write_into(own, new, ok)
                gathers.append(comp.encode_gather(new_p2, p2))
            if flat_keys:
                gat = self.parallel.mesh.all_gather(torch.cat(gathers, dim=1))
                off = 0
                for k in flat_keys:
                    g = self._geom[k]
                    piece = gat[:, off:off + g.chunk]
                    off += g.chunk
                    new_full = _from_flat(comp.decode_gather(piece, fulls[k]), g.shape, g.size)
                    write_into(params[k], new_full, ok)
            for k, e in new_ef.items():
                write_into(ef[k], e, ok)
            write_into(opt_state["t"], t_new, ok)
        finally:
            opt._step_constants = None
        return cost, ok

    # -- the collective-bytes model (ring convention, per leg) ------------------
    def _flat_payload_elems(self) -> int:
        return sum(self.n * g.chunk for g in self._geom.values() if g.flat)

    def _leg_bytes(self, itemsize: float, per_dispatch_of: int = 1) -> int:
        if self.n <= 1:
            return 0
        ring = (self.n - 1) / self.n
        return int(self._flat_payload_elems() * itemsize * ring / max(per_dispatch_of, 1))

    def collective_bytes_detail(self, steps_per_dispatch: int = 1) -> Dict[str, Any]:
        """zero1: one gradient scatter and one updated-parameter gather per
        STEP, whatever the dispatch fusion."""
        comp = self.compression
        return {"mode": self.mode, "per_leg": {
            "scatter": {"dtype": comp.scatter_dtype,
                        "bytes_per_step": self._leg_bytes(comp.scatter_itemsize)},
            "gather": {"dtype": comp.gather_dtype,
                       "bytes_per_step": self._leg_bytes(comp.gather_itemsize)}}}

    def collective_bytes_per_step(self, steps_per_dispatch: int = 1) -> int:
        detail = self.collective_bytes_detail(steps_per_dispatch)
        if not detail:
            return 0
        return int(sum(leg["bytes_per_step"] for leg in detail["per_leg"].values()))


class Zero2Updater(ShardedUpdater):
    """ZeRO-2: zero1's update, applied once per dispatch: the trainer's
    `multi_step` merges the K stacked batches into one [K*b] batch of this
    rank's rows and runs ONE forward, backward and update, so the gradient
    scatter and the parameter gather cross once per dispatch. Semantics:
    gradient accumulation over the window's real rows. At K = 1 (and for a
    pass's remainder singles) it is zero1."""

    mode = "zero2"

    def collective_bytes_detail(self, steps_per_dispatch: int = 1) -> Dict[str, Any]:
        comp = self.compression
        k = max(int(steps_per_dispatch), 1)
        return {"mode": self.mode, "per_leg": {
            "scatter": {"dtype": comp.scatter_dtype,
                        "bytes_per_step": self._leg_bytes(comp.scatter_itemsize, k)},
            "gather": {"dtype": comp.gather_dtype,
                       "bytes_per_step": self._leg_bytes(comp.gather_itemsize, k)}}}


class _Z3Gather(torch.autograd.Function):
    """One flat parameter's on-demand all-gather: the owner's encoded row
    crosses, every rank decodes the same [n, chunk] view. The backward
    hands the view's gradient, [n, chunk] and not yet reduced, to `anchor`
    (the leaf the trainer differentiates), and the row gets none: `apply`
    reduce-scatters all the flat gradients in one collective. A straight
    pass for the quantized modes, as the JAX package's custom_vjp."""

    @staticmethod
    def forward(ctx, row, anchor, updater, ef):
        return updater._gather_param(row, ef)

    @staticmethod
    def backward(ctx, d_full2):
        return None, d_full2, None, None


class Zero3Updater(ShardedUpdater):
    """ZeRO-3: the parameters themselves live as this rank's [1, chunk]
    rows (~n x less parameter memory at rest), gathered at each layer's
    read (`param_resolver`, once per forward: the consuming op keeps the
    full view for its backward, where the JAX package re-gathers it); the
    gradients cross one reduce-scatter and the update stays on the rows.
    Checkpoints hold the canonical layout through the parameter seams."""

    mode = "zero3"

    def _ef_init(self, k, dev):
        # the parameter gather's residual of the owned row
        return torch.zeros((1, self._geom[k].chunk), dtype=torch.float32, device=dev)

    def _ef_to_canonical(self, e, k):
        return self._gather_rows(e, k)

    def _ef_from_canonical(self, e, k):
        return self._row(e.float(), k)

    # -- parameter layout seams ----------------------------------------------
    def params_to_canonical(self, params: Params) -> Params:
        return {k: p if not self._geom[k].flat else self._gather_rows(p, k)
                for k, p in params.items()}

    def params_from_canonical(self, params: Params) -> Params:
        return {k: p if not self._geom[k].flat else self._row(p, k)
                for k, p in params.items()}

    # -- the on-demand gather ---------------------------------------------------
    def _gather_param(self, row: torch.Tensor, ef: Optional[torch.Tensor]) -> torch.Tensor:
        comp, mesh = self.compression, self.parallel.mesh
        payload, _ = comp.encode_param_gather(row, ef)
        if len(payload) == 1 and payload[0].dtype == torch.float32:
            return mesh.all_gather(payload[0])
        like = [(a.dtype, a.shape[1]) for a in payload]
        return comp.decode_param_gather(_unpack(mesh.all_gather(_pack(payload)), like))

    def _resolver(self, opt_state: Dict[str, Any], anchors: Optional[Params]):
        ef = opt_state.get("ef")

        def resolve(name: str, stored: torch.Tensor) -> torch.Tensor:
            g = self._geom.get(name)
            if g is None or not g.flat:
                return stored
            anchor = None if anchors is None else anchors[name]
            full2 = _Z3Gather.apply(stored, anchor, self, None if ef is None else ef[name])
            return _from_flat(full2, g.shape, g.size)

        return resolve

    def forward_inputs(self, params, opt_state):
        net, leaves = {}, {}
        anchors = {}
        for k, v in params.items():
            g = self._geom[k]
            if g.flat:
                net[k] = v.detach()
                # a zero-stride leaf: its gradient is the [n, chunk] view's
                anchors[k] = leaves[k] = v.new_zeros(()).expand(self.n, g.chunk) \
                    .requires_grad_(True)
            else:
                net[k] = leaves[k] = v.detach().requires_grad_(True)
        return net, leaves, self._resolver(opt_state, anchors)

    def eval_resolver(self, opt_state):
        return self._resolver(opt_state, None)

    # -- the sharded update (no trailing gather) ---------------------------------
    def apply(self, grads, opt_state, params, lr, cost, guard=False):
        opt, comp = self.optimizer, self.compression
        t_new = opt_state["t"] + 1
        ef = opt_state.get("ef")
        flat_keys = [k for k in params if self._geom[k].flat]
        opt._step_constants = opt.step_constants(t_new)
        try:
            enc = [comp.encode_z3_scatter(grads[k].float()) for k in flat_keys]
            if not enc:
                enc = [cost.new_zeros((self.n, 0))]
            parts, cost = self._scatter((torch.cat(enc, dim=1),), cost,
                                        comp.z3_reduces_in_collective)
            (part,) = parts
            ok = torch.isfinite(cost) if guard else None
            off = 0
            for k in flat_keys:
                g = self._geom[k]
                g_row = comp.decode_z3_scatter(part[:, off:off + g.chunk])
                off += g.chunk
                if not comp.z3_reduces_in_collective:
                    g_row = g_row.sum(dim=0, keepdim=True)
                p2 = params[k]
                new_p2, new_s = opt.update_one(k, g_row, opt_state["slots"][k], p2, lr,
                                               t_new)
                if ef is not None:
                    # the gather's residual, from the forward's encode of
                    # the pre-update row (local arithmetic)
                    _, nef = comp.encode_param_gather(p2, ef[k])
                    write_into(ef[k], nef, ok)
                for own, new in zip(opt_state["slots"][k], new_s):
                    write_into(own, new, ok)
                write_into(p2, new_p2, ok)
            write_into(opt_state["t"], t_new, ok)
        finally:
            opt._step_constants = None
        return cost, ok

    def collective_bytes_detail(self, steps_per_dispatch: int = 1) -> Dict[str, Any]:
        """The JAX package's zero3 model: the parameter gather twice a step
        (forward + its remat's re-gather) and the gradient scatter once."""
        comp = self.compression
        return {"mode": self.mode, "per_leg": {
            "scatter": {"dtype": comp.z3_scatter_dtype,
                        "bytes_per_step": self._leg_bytes(comp.z3_scatter_itemsize)},
            "gather": {"dtype": comp.param_gather_dtype,
                       "bytes_per_step": self._leg_bytes(2 * comp.param_gather_itemsize)}}}
