"""Functional layer graph (counterpart of `paddle_tpu/nn/graph.py`).

Layers are pure specs; `Network` orders them topologically once and runs
each layer's `forward` once per call. Parameters are a plain dict of
tensors keyed exactly as the JAX package keys them (`attr.name` or
`f"{layer.name}.{pname}"`, e.g. `enc.fw.w_hzr`, `trg_emb_table`): the names
hold dots and may be shared between layers through `ParamAttr(name=...)`,
neither of which `nn.Module` attributes allow, and the same names let
`nn/convert.py` move parameters to and from the JAX package unchanged.
Backward is autograd over `Network.apply`, as it is `jax.grad` over the
traced forward in the JAX package. Non-trainable states (batch norm's
moving statistics) are a second dict keyed `f"{layer.name}.{name}"`:
`init(..., with_states=True)` returns them beside the parameters, and
`apply(params, batch, states, train=...)` returns the new ones beside the
outputs. Both run under the dtype policy they are given (`core/dtypes.py`).

Ragged sequences are padded [B, T, ...] tensors plus a [B] `lengths`
tensor; a batch dict carries `<name>.lengths` beside each sequence slot.
Nested sequences are [B, S, T, ...] with `lengths` [B] counting the valid
subsequences and `sub_lengths` [B, S] the valid steps of each, fed as
`<name>.sub_lengths`.

Randomness is jax's: `apply(..., rng=key)` hands the context a threefry
key (`core/prng.py`), and `Context.next_rng(tag)` folds in the tag's
stable hash and a per-apply draw count, as `paddle_tpu/nn/graph.py` does,
so Dropout draws the reference's masks bit for bit. `apply(...,
remat=policy)` runs the layers in segments that end at a conv or fc, each
under `core/remat.py`'s checkpoint, with the draw count rewound for the
recompute. A layer's output is dropped once its last consumer has run.

Data parallelism (`parallel/`): `apply(..., mesh=m)` runs the forward on
this rank's rows of the global batch. Batch norm then reduces its sums over
the mesh, the cost layers divide by the global row count, and every random
draw over the batch draws the global shape's bits and keeps this rank's
rows (`batch_rows`), so the masks equal the JAX package's at any
world size. A padded batch (`DataParallel.pad_batch`) carries the [B] row
mask under `SAMPLE_MASK_KEY` and the global real row count under
`SAMPLE_COUNT_KEY`; `Network._run` strips both into the context."""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.utils.checkpoint

from paddle_tpu_torch.core import dtypes, prng, remat as remat_mod, stack_trace
from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.nn import init as init_mod

Params = Dict[str, torch.Tensor]

# Reserved batch slot: [B] float 0/1 row-validity mask attached when a
# trailing batch is padded up to the mesh data-axis multiple
# (DataParallel.pad_batch). Network._run strips it into Context.sample_mask;
# cost layers weight per-example costs by it and normalize by the real row
# count, so padded rows contribute nothing to cost or gradients.
SAMPLE_MASK_KEY = "__sample_mask__"
# The port's second reserved slot beside the mask: the global batch's real
# row count as a [1] f32 tensor (a rank holds only its rows of the mask; the
# denominator is the whole batch's). Stripped into Context.sample_count.
SAMPLE_COUNT_KEY = "__sample_count__"


@dataclasses.dataclass
class Argument:
    """Value flowing between layers.

    value:   [B, ...] dense batch, or [B, T, ...] padded sequence batch.
    lengths: [B] integer valid lengths when `value` is a sequence batch.
    sub_lengths: [B, S] integer valid lengths of each subsequence when
             `value` is a nested [B, S, T, ...] batch."""

    value: torch.Tensor
    lengths: Optional[torch.Tensor] = None
    sub_lengths: Optional[torch.Tensor] = None

    @property
    def is_seq(self) -> bool:
        return self.lengths is not None

    @property
    def max_len(self) -> int:
        assert self.is_seq
        return self.value.shape[1]

    def mask(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """[B, T] validity mask from lengths."""
        assert self.lengths is not None
        steps = torch.arange(self.value.shape[1], device=self.value.device)
        return (steps[None, :] < self.lengths[:, None]).to(dtype)

    def with_value(self, value: torch.Tensor) -> "Argument":
        return Argument(value, self.lengths, self.sub_lengths)

    def as_non_seq(self) -> "Argument":
        return Argument(self.value)


@dataclasses.dataclass
class ParamAttr:
    """Per-parameter attributes: sharing name, init, lr scale, decay,
    staticness, clipping (the reference's ParameterConfig knobs). `momentum`,
    `is_sparse` and `sharding` are carried into the config's
    ParameterConfig and change nothing else here; `initializer(generator,
    shape)` replaces the layer's initializer."""

    name: Optional[str] = None  # set -> parameter shared under this name
    initializer: Optional[init_mod.Initializer] = None
    initial_std: Optional[float] = None  # set -> N(initial_mean, initial_std)
    initial_mean: float = 0.0
    learning_rate: float = 1.0
    momentum: Optional[float] = None
    l1_decay: Optional[float] = None
    l2_decay: Optional[float] = None
    is_static: bool = False
    is_sparse: bool = False
    gradient_clipping_threshold: Optional[float] = None
    # set -> U(initial_min, initial_max), winning over initial_std
    initial_min: Optional[float] = None
    initial_max: Optional[float] = None
    sharding: Optional[Tuple[Optional[str], ...]] = None
    # logical axis names resolved through parallel/rules.py's table
    logical_axes: Optional[Tuple[Optional[str], ...]] = None


class Context:
    """Threaded through one forward run. mode='init' creates parameters on
    first use (one generator per parameter, seeded from (seed, name), drawn
    on the CPU) and states from their initial values; mode='apply' reads
    both from the given dicts. State updates (batch norm's moving
    statistics, the functional form of the reference's mutable
    movingMean_/movingVar_) collect in `state_updates`; nothing given is
    changed in place. `train` selects batch statistics over moving ones;
    `policy` is the trace's dtype policy; `rng` the threefry key (a [2]
    tensor) that `next_rng` draws from, or a function giving it, called at
    the first draw (a graph without Dropout computes no key). `cache`
    holds what one run shares between layers: a recurrent group's unroll,
    which every output of the group reads, and a step layer's auxiliary
    outputs.

    Under a mesh (`mesh`, with this rank's `rank` of `world`) the batch is
    this rank's rows of the global batch: `sample_mask` holds a padded
    batch's [B] row weights and `sample_count` the global real row count;
    `param_resolver(name, stored)` turns a stored parameter into the full
    view a layer reads (ZeRO-3's on-demand gather), once per run."""

    def __init__(self, mode: str, params: Params, seed: int = 0,
                 device: Optional[torch.device] = None,
                 states: Optional[Params] = None, train: bool = False,
                 policy: Optional[dtypes.Policy] = None,
                 rng: Union[None, torch.Tensor, Callable[[], torch.Tensor]] = None):
        assert mode in ("init", "apply")
        self.mode = mode
        self.params = params
        self.seed = seed
        self.device = device
        self.states: Params = {} if states is None else states
        self.train = train
        self.policy = policy or dtypes.current()
        self.rng = rng
        self.rng_count = 0
        self.state_updates: Params = {}
        self.cache: Dict[Any, Any] = {}
        self.param_attrs: Dict[str, ParamAttr] = {}
        # (layer name, slot) -> parameter name; a shared name binds to every
        # layer that uses it (the config dump reads this)
        self.param_owners: Dict[tuple, str] = {}
        self.sample_mask: Optional[torch.Tensor] = None
        self.sample_count: Optional[torch.Tensor] = None
        self.mesh: Any = None
        self.rank = 0
        self.world = 1
        self.param_resolver: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None
        self._resolved: Params = {}

    def next_rng(self, tag: str) -> torch.Tensor:
        """A fresh key for one draw: fold_in(fold_in(rng, hash(tag)), n),
        n counting this context's draws from 1."""
        if self.rng is None:
            raise ValueError("no rng available in this context (pass rng= to apply)")
        if callable(self.rng):
            self.rng = self.rng()
        self.rng_count += 1
        return prng.fold_in(prng.fold_in(self.rng, _stable_hash(tag)), self.rng_count)

    def param(self, layer: "Layer", pname: str, shape: Sequence[int],
              init: init_mod.Initializer,
              attr: Optional[ParamAttr] = None) -> torch.Tensor:
        attr = attr or ParamAttr()
        full = attr.name or f"{layer.name}.{pname}"
        self.param_owners.setdefault((layer.name, pname), full)
        if self.mode == "init" and full not in self.params:
            initializer = attr.initializer or init
            if attr.initializer is None and attr.initial_max is not None:
                lo = attr.initial_min if attr.initial_min is not None else -attr.initial_max
                initializer = init_mod.uniform(lo, attr.initial_max)
            elif attr.initializer is None and attr.initial_std is not None:
                initializer = init_mod.normal(attr.initial_std, attr.initial_mean)
            elif attr.initializer is None and _param_default.get("initial_std") is not None:
                initializer = init_mod.normal(_param_default["initial_std"],
                                              _param_default.get("initial_mean", 0.0))
            g = torch.Generator().manual_seed(
                init_mod.param_seed(self.seed, _stable_hash(full)))
            self.params[full] = initializer(g, tuple(shape)).to(self.device)
            self.param_attrs[full] = attr
        if full not in self.params:
            raise KeyError(f"parameter {full!r} of layer {layer.name!r} missing")
        value = self.params[full]
        if self.param_resolver is not None:
            if full not in self._resolved:  # a shared parameter resolves once
                self._resolved[full] = self.param_resolver(full, value)
            value = self._resolved[full]
        got = tuple(value.shape)
        if got != tuple(shape):
            raise ValueError(
                f"parameter {full!r} shape mismatch: {got} vs {tuple(shape)}")
        return value

    def state(self, layer: "Layer", sname: str, shape: Sequence[int],
              init_value: float = 0.0) -> torch.Tensor:
        """A non-trainable f32 state `f"{layer.name}.{sname}"`, created at
        `init_value` in init mode."""
        full = f"{layer.name}.{sname}"
        if self.mode == "init" and full not in self.states:
            self.states[full] = torch.full(tuple(shape), float(init_value),
                                           dtype=torch.float32, device=self.device)
        if full not in self.states:
            raise KeyError(f"state {full!r} of layer {layer.name!r} missing")
        return self.states[full]

    def update_state(self, layer: "Layer", sname: str, value: torch.Tensor) -> None:
        self.state_updates[f"{layer.name}.{sname}"] = value


def batch_rows(ctx: Any, draw: Callable[[Tuple[int, ...]], torch.Tensor],
               shape: Sequence[int]) -> torch.Tensor:
    """`draw(shape)` for a draw whose leading axis is the batch: under a mesh
    of `ctx.world` ranks it draws the global batch's shape and keeps this
    rank's rows, so every rank's bits are the unsharded batch's."""
    shape = tuple(shape)
    world = getattr(ctx, "world", 1)
    if world == 1:
        return draw(shape)
    b, r = shape[0], ctx.rank
    return draw((b * world,) + shape[1:])[r * b:(r + 1) * b]


def _stable_hash(s: str) -> int:
    h = 2166136261
    for ch in s.encode():
        h = ((h ^ ch) * 16777619) & 0x7FFFFFFF
    return h


_name_lock = threading.Lock()
_name_counters: Dict[str, int] = {}

# the config scripts' default parameter init (config_parser's
# default_initial_std / default_initial_mean), read by Context.param for a
# parameter with no init of its own
_param_default: Dict[str, float] = {}


def _auto_name(type_name: str) -> str:
    with _name_lock:
        idx = _name_counters.get(type_name, 0)
        _name_counters[type_name] = idx + 1
    return f"__{type_name}_{idx}__"


def reset_name_scope() -> None:
    """Reset auto-name counters and the config's default init (call between
    independently built graphs)."""
    _param_default.clear()
    with _name_lock:
        _name_counters.clear()


_record_tls = threading.local()


@contextlib.contextmanager
def record_layers(sink: List["Layer"]):
    """Collect every Layer constructed inside the block into `sink`: a
    config's layers that no output reaches stay in its config, as the
    reference's do."""
    old = getattr(_record_tls, "sink", None)
    _record_tls.sink = sink
    try:
        yield sink
    finally:
        _record_tls.sink = old


class Layer:
    """A pure layer spec. Subclasses implement `forward(ctx, ins)`; autograd
    is the backward."""

    type_name: str = "layer"
    is_cost: bool = False

    def __init__(self, inputs: Union[None, "Layer", Sequence["Layer"]] = None,
                 name: Optional[str] = None):
        if inputs is None:
            inputs = []
        elif isinstance(inputs, Layer):
            inputs = [inputs]
        inputs = list(inputs)
        for i, layer in enumerate(inputs):
            if not isinstance(layer, Layer):
                raise TypeError(
                    f"{type(self).__name__} input {i} is "
                    f"{type(layer).__name__}, not a Layer")
        self.inputs: List[Layer] = inputs
        self.name = name or _auto_name(self.type_name)
        sink = getattr(_record_tls, "sink", None)
        if sink is not None:
            sink.append(self)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name}>"


class Network:
    """A layer DAG with `init` (create parameters from a sample batch) and
    `apply` (forward over a batch)."""

    def __init__(self, outputs: Union[Layer, Sequence[Layer]]):
        self.outputs: List[Layer] = [outputs] if isinstance(outputs, Layer) else list(outputs)
        self.layer_order = _topo_sort(self.outputs)
        self.layers_by_name: Dict[str, Layer] = {}
        for layer in self.layer_order:
            if self.layers_by_name.setdefault(layer.name, layer) is not layer:
                raise ValueError(f"duplicate layer name {layer.name!r}")
        self.param_attrs: Dict[str, ParamAttr] = {}

    def init(self, batch: Mapping[str, Any], seed: int = 0,
             device: DeviceLike = None, *, policy: Optional[dtypes.Policy] = None,
             with_states: bool = False):
        """Create the parameters (and the states: batch norm's moving
        statistics) by running the forward once on `batch` in train mode,
        without autograd. Returns {name: f32 tensor on `device`}, or
        (params, states) with `with_states=True`."""
        dev = resolve_device(device)
        params: Params = {}
        states: Params = {}
        policy = policy or dtypes.current()
        ctx = Context("init", params, seed, dev, states=states, train=True,
                      policy=policy, rng=prng.PRNGKey(seed, dev))
        with torch.no_grad(), dtypes.policy_scope(policy):
            self._run(ctx, batch, dev)
        self.param_attrs = dict(ctx.param_attrs)
        return (params, states) if with_states else params

    def apply(self, params: Params, batch: Mapping[str, Any],
              states: Optional[Params] = None, *, train: bool = False,
              policy: Optional[dtypes.Policy] = None,
              rng: Union[None, torch.Tensor, Callable[[], torch.Tensor]] = None,
              remat: Optional[str] = None, mesh: Any = None,
              param_resolver: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None):
        """Forward over `batch` (moved to the parameters' device) ->
        {output layer name: Argument}; with `states` given, ->
        (outputs, new states), the updated ones replacing their entries in
        a new dict. `train` selects batch statistics (and state updates)
        over the moving ones; `rng` is the key Dropout draws from (or a
        function giving it at the first draw); `remat`
        ("dots" | "conv_only" | "full") checkpoints segments of layers
        under that policy (`core/remat.py`). `mesh` (a `parallel.Mesh`):
        `batch` is this rank's rows of the global batch (see the module
        docstring); `param_resolver(name, stored)` gives the full view of a
        stored parameter (ZeRO-3)."""
        known = next(iter(params.values()), None)
        if known is None and states:
            known = next(iter(states.values()))
        if known is None:
            raise ValueError("apply needs a parameter or a state to take the "
                             "device from")
        dev = known.device
        policy = policy or dtypes.current()
        ctx = Context("apply", params, device=dev,
                      states={} if states is None else states, train=train,
                      policy=policy, rng=rng)
        if mesh is not None:
            ctx.mesh, ctx.rank, ctx.world = mesh, mesh.rank, mesh.size
        ctx.param_resolver = param_resolver
        with dtypes.policy_scope(policy):
            values = self._run(ctx, batch, dev, remat_mod.resolve(remat))
        outs = {l.name: values[l.name] for l in self.outputs}
        if states is None:
            return outs
        return outs, {**states, **ctx.state_updates}

    def _run(self, ctx: Context, batch: Mapping[str, Any], device: torch.device,
             remat: Optional[str] = None, keep_all: bool = False) -> Dict[str, Argument]:
        """Every layer's output, each dropped once its last consumer ran
        (the outputs stay; with `keep_all` nothing is dropped). With
        `remat`, the layers run in segments that each end at a conv or fc
        layer, every segment under
        `core/remat.checkpoint`: what a segment takes from earlier ones (a
        conv's or fc's output, a residual branch) stays for the backward,
        everything inside it is recomputed there unless the policy saves
        it."""
        if SAMPLE_MASK_KEY in batch or SAMPLE_COUNT_KEY in batch:
            # the padded batch's reserved slots feed the cost layers'
            # masking through the context, never a data layer
            if SAMPLE_MASK_KEY in batch:
                ctx.sample_mask = _to_tensor(batch[SAMPLE_MASK_KEY], device)
            if SAMPLE_COUNT_KEY in batch:
                ctx.sample_count = _to_tensor(batch[SAMPLE_COUNT_KEY], device).reshape(())
            batch = {k: v for k, v in batch.items()
                     if k not in (SAMPLE_MASK_KEY, SAMPLE_COUNT_KEY)}
        values: Dict[str, Argument] = {}
        order = [layer for layer in self.layer_order if layer.type_name != "data"]
        last_use: Dict[str, int] = {}  # name -> position of its last consumer
        for i, layer in enumerate(order):
            for dep in layer.inputs:
                last_use[dep.name] = i
        for layer in self.outputs if not keep_all else self.layer_order:
            last_use[layer.name] = len(order)
        for layer in self.layer_order:
            if layer.type_name == "data":
                values[layer.name] = _feed_to_argument(batch, layer, device)
        done = 0
        for segment in _segments(order, remat is not None):
            if remat is None:
                (layer,) = segment
                values[layer.name] = _forward(layer, ctx,
                                              [values[d.name] for d in layer.inputs])
            else:
                values.update(remat_mod.checkpoint(_segment_run(segment, ctx, values), remat))
            done += len(segment)
            for layer in segment:
                for name in [layer.name] + [d.name for d in layer.inputs]:
                    if last_use.get(name, -1) < done:
                        values.pop(name, None)
        return values


def _segments(order: List[Layer], remat: bool) -> List[List[Layer]]:
    """The layers in order, one a segment, or with remat in runs that each
    end at a conv or fc layer."""
    if not remat:
        return [[layer] for layer in order]
    segments: List[List[Layer]] = [[]]
    for layer in order:
        segments[-1].append(layer)
        if layer.type_name in _SEGMENT_ENDS:
            segments.append([])
    return [seg for seg in segments if seg]


_SEGMENT_ENDS = ("conv", "fc")


# torch.utils.checkpoint ends a recompute early by raising through the
# layers: control flow, not a layer's failure
_PASS_THROUGH = (stack_trace.LayerError,) + tuple(
    getattr(torch.utils.checkpoint, n) for n in ("_StopRecomputationError",)
    if hasattr(torch.utils.checkpoint, n))


def _forward(layer: Layer, ctx: Context, ins: List[Argument]) -> Argument:
    # layer-name crash context (CustomStackTrace parity,
    # NeuralNetwork.cpp:259-261), as the JAX package's Network._run keeps it
    with stack_trace.layer_frame(layer.name):
        try:
            out = layer.forward(ctx, ins)
        except _PASS_THROUGH:
            raise
        except Exception as e:
            raise stack_trace.LayerError(layer.name, stack_trace.current_stack(), e) from e
    if not isinstance(out, Argument):
        raise TypeError(f"layer {layer.name} forward returned {type(out).__name__}")
    return out


def _segment_run(segment: List[Layer], ctx: Context, values: Dict[str, Argument]):
    """A function running `segment`'s layers on the values it takes from
    earlier segments -> {layer name: output}. It rewinds ctx's draw count
    to where it is now, so the backward's recompute draws the keys the
    forward drew."""
    start = ctx.rng_count
    inputs = {d.name: values[d.name] for layer in segment for d in layer.inputs
              if d.name in values}

    def run() -> Dict[str, Argument]:
        ctx.rng_count = start
        local = dict(inputs)
        for layer in segment:
            local[layer.name] = _forward(layer, ctx, [local[d.name] for d in layer.inputs])
        return {layer.name: local[layer.name] for layer in segment}
    return run


def _topo_sort(outputs: Sequence[Layer]) -> List[Layer]:
    order: List[Layer] = []
    seen: Dict[int, int] = {}  # id -> 0 visiting, 1 done

    def visit(layer: Layer) -> None:
        state = seen.get(id(layer))
        if state == 1:
            return
        if state == 0:
            raise ValueError(f"cycle in layer graph at {layer.name}")
        seen[id(layer)] = 0
        for dep in layer.inputs:
            visit(dep)
        seen[id(layer)] = 1
        order.append(layer)

    for out in outputs:
        visit(out)
    return order


def _to_tensor(v: Any, device: torch.device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.as_tensor(np.asarray(v)).to(device)


def _feed_to_argument(batch: Mapping[str, Any], layer: Layer,
                      device: torch.device) -> Argument:
    if layer.name not in batch:
        raise KeyError(f"data layer {layer.name!r} missing from batch; got {sorted(batch)}")
    v = batch[layer.name]
    if isinstance(v, Argument):
        return v
    lengths_key = layer.name + ".lengths"
    if lengths_key not in batch:
        return Argument(_to_tensor(v, device))
    sub_key = layer.name + ".sub_lengths"
    sub = _to_tensor(batch[sub_key], device) if sub_key in batch else None
    return Argument(_to_tensor(v, device), _to_tensor(batch[lengths_key], device), sub)
