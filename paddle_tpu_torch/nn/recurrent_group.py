"""recurrent_group / memory — the v1 dynamic-unroll API (counterpart of
`paddle_tpu/nn/recurrent_group.py`).

Parity with RecurrentGradientMachine (gserver/gradientmachines/
RecurrentGradientMachine.h:32: a sub-network run once a time step, with
memory links between steps) and the trainer_config_helpers surface
(`recurrent_group`, `memory`, `StaticInput`, `SubsequenceInput`,
`GeneratedInput`, `beam_search`, `get_output_layer` — layers.py).

The user's `step` function is called ONCE, when the group is built, on
placeholder nodes: what it returns is a static sub-graph (the step net).
At run time the group walks the padded time axis in a Python loop, one
evaluation of the step net a step, where the JAX package runs one
`lax.scan`. The step index is a Python int, so every slice is static; the
validity of a step (`t < lengths`) stays a [B] tensor on the device, and a
memory keeps its old value on a padded step. No value is read back to the
host, so the whole unroll can be captured in the training step's CUDA
graph. Every output of a group comes from one unroll, shared through the
run's cache (`Context.cache`). In init mode one eager step creates the
parameters and its outputs are tiled over time, as in the JAX package.

A nested group (`SubsequenceInput`, a [B, S, T, ...] input with
`sub_lengths`) walks the subsequence axis, each step feeding the step net
one subsequence as a level-1 sequence; an inner group in that step net is
the inner loop.

Generation (`beam_search`, `BeamSearchLayer`) runs the same step net once
a generated step over B*K rows, the batch's rows each tiled over the K
beams: a `GeneratedInput` placeholder takes the embedding of the tokens
chosen at the step before, the step's first output is the probability of
the next token, and `nn/beam_core.beam_search_scan` keeps the K best
beams, the memories following them. It runs eagerly, `max_length` steps,
with no read back to the host inside the loop. An outer group whose step
beam-searches (nested generation) stacks the generated lengths of each
outer step into the output's `sub_lengths`.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch

from paddle_tpu_torch.nn import init as init_mod
from paddle_tpu_torch.nn.beam_core import beam_search_scan
from paddle_tpu_torch.nn.graph import (
    Argument,
    Context,
    Layer,
    ParamAttr,
    _topo_sort,
    record_layers,
)
from paddle_tpu_torch.ops import sequence as seq_ops

# ---------------------------------------------------------------------------
# step-net placeholders
# ---------------------------------------------------------------------------


class _Placeholder(Layer):
    """A node whose value the owning group injects at every step."""

    type_name = "step_input"

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        raise RuntimeError(f"placeholder {self.name} evaluated outside its recurrent group")


class MemoryLayer(_Placeholder):
    """`memory(name=X, size=...)`: the value of step layer X at t-1
    (SubModelConfig memory links, ModelConfig.proto:608)."""

    type_name = "memory"

    def __init__(self, link_name: str, size: int, boot_layer: Optional[Layer] = None,
                 boot_bias: bool = False, is_seq: bool = False,
                 name: Optional[str] = None):
        super().__init__(None, name=name)
        self.link_name = link_name
        self.size = size
        self.boot_layer = boot_layer
        self.boot_bias = boot_bias

    def set_input(self, layer: Layer) -> None:
        """Deferred link (layers.py memory().set_input): point this memory
        at a step layer chosen after construction."""
        self.link_name = layer.name


class StaticInput:
    """Marks an outer layer fed unchanged to every step (layers.py
    StaticInput); is_seq=True feeds the whole padded sequence, the
    encoder-outputs-for-attention idiom."""

    def __init__(self, input: Layer, is_seq: bool = False, size: Optional[int] = None):
        self.input = input
        self.is_seq = is_seq
        self.size = size


class GeneratedInput:
    """Generation-time input: the embedding of the token generated at the
    step before (layers.py GeneratedInput). The table is the parameter
    `embedding_name`, so a model trained with an embedding_layer of that
    name generates from its trained table."""

    def __init__(self, size: int, embedding_name: str, embedding_size: int):
        self.size = size  # vocabulary size
        self.embedding_name = embedding_name
        self.embedding_size = embedding_size


class SubsequenceInput:
    """Marks a nested-sequence input iterated one subsequence a step
    (layers.py SubsequenceInput; RecurrentGradientMachine.h:32 over
    Argument.subSequenceStartPositions). The wrapped layer's Argument is a
    padded [B, S, T, ...] with `lengths` the valid subsequences [B] and
    `sub_lengths` [B, S] the valid steps of each."""

    def __init__(self, input: Layer):
        self.input = input


SubSequenceInput = SubsequenceInput  # both spellings appear in reference configs


# ---------------------------------------------------------------------------
# group build context: memory() must know the group being built
# ---------------------------------------------------------------------------


class _BuildCtx:
    def __init__(self):
        self.memories: List[MemoryLayer] = []


_tls = threading.local()


@contextlib.contextmanager
def _building(bctx: _BuildCtx):
    old = getattr(_tls, "bctx", None)
    _tls.bctx = bctx
    try:
        yield
    finally:
        _tls.bctx = old


def memory(name: str, size: int, boot_layer: Optional[Layer] = None,
           boot_bias: bool = False, is_seq: bool = False, **_compat) -> MemoryLayer:
    bctx = getattr(_tls, "bctx", None)
    if bctx is None:
        raise RuntimeError("memory() must be called inside a recurrent_group step")
    m = MemoryLayer(name, size, boot_layer, boot_bias, is_seq)
    m.user_named = name is not None
    bctx.memories.append(m)
    return m


# ---------------------------------------------------------------------------
# step-net evaluation
# ---------------------------------------------------------------------------


def _eval_subnet(order: List[Layer], ctx: Context,
                 seeded: Dict[str, Argument]) -> Dict[str, Argument]:
    """One step of the step net. What its layers put in the run's cache
    (an inner group's unroll, a step layer's auxiliary output) belongs to
    this step only and is dropped after it."""
    values = dict(seeded)
    keys0 = set(ctx.cache)
    for layer in order:
        if layer.name in values:
            continue
        if isinstance(layer, _Placeholder):
            raise RuntimeError(f"unseeded placeholder {layer.name} in step net")
        values[layer.name] = layer.forward(ctx, [values[l.name] for l in layer.inputs])
    for k in list(ctx.cache):
        if k not in keys0:
            del ctx.cache[k]
    return values


def _carry_value(link_arg: Argument, old: torch.Tensor) -> torch.Tensor:
    """The value a memory carries from its link's output: a non-sequence
    memory of a sequence-valued step layer carries the last valid instance
    (RecurrentGradientMachine's scatter of the frame's last agent state)."""
    new = link_arg.value
    if new.ndim == old.ndim + 1 and link_arg.is_seq:
        new = seq_ops.seq_last(new, link_arg.lengths)
    return new


def _masked(valid: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    return torch.where(valid.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)


class _GroupCore:
    """What one group's nodes share: the traced step net and its links."""

    def __init__(self, step: Callable, inputs: Sequence[Union[Layer, StaticInput]],
                 reverse: bool = False):
        self.reverse = reverse
        self.seq_inputs: List[Layer] = []
        self.sub_seq_flags: List[bool] = []  # parallel to seq_inputs
        self.static_inputs: List[StaticInput] = []
        self.generated: Optional[GeneratedInput] = None
        self.gen_placeholder: Optional[_Placeholder] = None

        bctx = _BuildCtx()
        step_args: List[Any] = []
        self.placeholders: List[_Placeholder] = []
        created: List[Layer] = []
        with _building(bctx), record_layers(created):
            for item in inputs if isinstance(inputs, (list, tuple)) else [inputs]:
                if isinstance(item, StaticInput):
                    ph = _Placeholder(None)
                    ph.static = item
                    ph._v1_size = getattr(item.input, "_v1_size", None)
                    ph.src_layer = item.input
                    self.static_inputs.append(item)
                elif isinstance(item, GeneratedInput):
                    ph = _Placeholder(None)
                    ph.static = None
                    self.generated = item
                    self.gen_placeholder = ph
                elif isinstance(item, (SubsequenceInput, Layer)):
                    src = item.input if isinstance(item, SubsequenceInput) else item
                    ph = _Placeholder(None)
                    ph.static = None
                    ph._v1_size = getattr(src, "_v1_size", None)
                    ph.src_layer = src
                    self.seq_inputs.append(src)
                    self.sub_seq_flags.append(isinstance(item, SubsequenceInput))
                else:
                    raise TypeError(f"bad recurrent_group input: {item!r}")
                self.placeholders.append(ph)
                step_args.append(ph)
            outs = step(*step_args)
        self.memories: List[MemoryLayer] = bctx.memories
        # SubsequenceInput forces nesting; a nested Argument at run time
        # also does (the reference reads nesting from the provider's slot
        # types, not from the config's wrapper)
        self.is_nested = any(self.sub_seq_flags)
        self.multi_out = not isinstance(outs, Layer)
        self.out_layers: List[Layer] = [outs] if isinstance(outs, Layer) else list(outs)

        # memory links: the step layer whose output feeds t+1. Any layer
        # built inside the step counts, not only the outputs' ancestors (a
        # last_seq that only carries state across outer steps of a nested
        # group), as the reference looks frames up by name
        roots = list(self.out_layers)
        created_by_name = {l.name: l for l in created}
        for m in self.memories:
            extra = created_by_name.get(m.link_name)
            if extra is not None and extra not in roots:
                roots.append(extra)
        self.order = _topo_sort(roots)
        by_name = {l.name: l for l in self.order}
        self.links: Dict[str, Layer] = {}
        for m in self.memories:
            link = by_name.get(m.link_name)
            if link is None:
                raise ValueError(
                    f"memory links to {m.link_name!r} but no step layer has that name "
                    f"(step outputs: {[l.name for l in self.out_layers]})")
            self.links[m.name] = link
        self._seq_deps: Optional[Dict[str, set]] = None

    def outer_inputs(self) -> List[Layer]:
        outer = list(self.seq_inputs) + [s.input for s in self.static_inputs]
        outer += [m.boot_layer for m in self.memories if m.boot_layer is not None]
        return outer

    def split_outer(self, ins: List[Argument]):
        n_seq, n_static = len(self.seq_inputs), len(self.static_inputs)
        seq = ins[:n_seq]
        static = ins[n_seq:n_seq + n_static]
        boots = iter(ins[n_seq + n_static:])
        boot_map = {m.name: next(boots) for m in self.memories if m.boot_layer is not None}
        return seq, static, boot_map

    def seq_phs(self) -> List[_Placeholder]:
        return [ph for ph in self.placeholders if ph.static is None]

    def seq_deps(self) -> Dict[str, set]:
        """layer name -> indices of the iterated inputs in its step-net
        ancestry, memories included through their links (a fixpoint). It
        gives each output and memory the lengths of its own inputs when the
        iterated inputs' lengths differ (RecurrentGradientMachine's
        unequal-length contract)."""
        if self._seq_deps is not None:
            return self._seq_deps
        ph_idx = {ph.name: i for i, ph in enumerate(self.seq_phs())}
        dep: Dict[str, set] = {}

        def of(layer) -> set:
            n = layer.name
            if n in dep:
                return dep[n]
            if n in ph_idx:
                dep[n] = {ph_idx[n]}
            else:
                dep[n] = set()  # a memory's is filled by the fixpoint below
                if not isinstance(layer, MemoryLayer):
                    for inp in layer.inputs:
                        dep[n] = dep[n] | of(inp)
            return dep[n]

        for l in self.order:
            of(l)
        for _ in range(len(self.memories) + 1):
            changed = False
            for m in self.memories:
                link = self.links.get(m.name)
                add = dep.get(link.name, set()) - dep.get(m.name, set())
                if add:
                    dep[m.name] = dep.get(m.name, set()) | add
                    changed = True
                    for l in self.order:  # propagate downstream
                        for inp in l.inputs:
                            miss = dep.get(inp.name, set()) - dep.get(l.name, set())
                            if miss:
                                dep[l.name] = dep.get(l.name, set()) | miss
            if not changed:
                break
        self._seq_deps = dep
        return dep

    def seed_static(self, seeded: Dict[str, Argument], static_vals: List[Argument]):
        vals = iter(static_vals)
        for ph in self.placeholders:
            if ph.static is not None:
                arg = next(vals)
                # a StaticInput of a sequence keeps its sequence structure
                # even without is_seq=True (the reference passes the Argument
                # whole; is_seq only governs per-step expansion)
                keep_seq = ph.static.is_seq or arg.lengths is not None
                seeded[ph.name] = arg if keep_seq else arg.as_non_seq()

    def init_carry(self, ctx: Context, batch: int, device: torch.device,
                   boot_map: Dict[str, Argument]) -> Dict[str, torch.Tensor]:
        carry: Dict[str, torch.Tensor] = {}
        for m in self.memories:
            if m.name in boot_map:
                v = boot_map[m.name].value
            else:
                v = torch.zeros((batch, m.size), dtype=torch.float32, device=device)
            if m.boot_bias:
                v = v + ctx.param(m, "boot_b", (m.size,), init_mod.zeros, ParamAttr())
            carry[m.name] = v
        return carry


def _is_nested_arg(a: Argument) -> bool:
    return a.sub_lengths is not None and a.value.ndim > 2


# ---------------------------------------------------------------------------
# the group node
# ---------------------------------------------------------------------------


class RecurrentGroup(Layer):
    type_name = "recurrent_layer_group"

    def __init__(self, core: _GroupCore, out_index: int, name: Optional[str] = None):
        super().__init__(core.outer_inputs(), name=name)
        self.core = core
        self.out_index = out_index

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        key = (id(self.core), "train")
        if key not in ctx.cache:
            ctx.cache[key] = self._run_group(ctx, ins)
        return ctx.cache[key][self.core.out_layers[self.out_index].name]

    def _run_group(self, ctx: Context, ins: List[Argument]) -> Dict[str, Argument]:
        core = self.core
        seq, static, boot_map = core.split_outer(ins)
        if not seq:
            raise ValueError("recurrent_group needs at least one sequence input")
        if core.is_nested or any(_is_nested_arg(a) for a in seq):
            return self._run_nested(ctx, seq, static, boot_map)
        anchor = next((a for a in seq if a.lengths is not None), None)
        if anchor is None:
            raise ValueError("recurrent_group inputs must be sequences")
        lengths = anchor.lengths
        batch = anchor.value.shape[0]
        # iterated inputs may have different lengths: the loop covers the
        # longest (a static shape), each memory and output masked by the
        # lengths of its own inputs
        t_max = max(a.value.shape[1] for a in seq if a.lengths is not None)
        deps = core.seq_deps()

        def dep_lengths(name: str) -> torch.Tensor:
            idxs = [i for i in deps.get(name, set()) if seq[i].lengths is not None]
            if not idxs:
                return lengths
            out = seq[idxs[0]].lengths
            for i in idxs[1:]:
                out = torch.maximum(out, seq[i].lengths)
            return out

        seeded_static: Dict[str, Argument] = {}
        core.seed_static(seeded_static, static)
        carry = core.init_carry(ctx, batch, anchor.value.device, boot_map)
        seq_phs = core.seq_phs()

        def seeded_at(t: int) -> Dict[str, Argument]:
            # a non-sequence iterated input repeats every step (the reference
            # broadcasts NO_SEQUENCE args); a shorter input holds its last
            # step (masking freezes what depends on it)
            seeded = dict(seeded_static)
            for ph, a in zip(seq_phs, seq):
                seeded[ph.name] = Argument(
                    a.value if a.lengths is None else a.value[:, min(t, a.value.shape[1] - 1)])
            for m in core.memories:
                seeded[m.name] = Argument(carry[m.name])
            return seeded

        out_names = [l.name for l in core.out_layers]
        if ctx.mode == "init":
            # one eager step creates every parameter; tile it over time
            values = _eval_subnet(core.order, ctx, seeded_at(0))
            return {n: Argument(_tile(values[n].value, t_max), lengths) for n in out_names}

        mem_lengths = {m.name: dep_lengths(m.name) for m in core.memories}
        keys0 = set(ctx.state_updates)
        stacked: Dict[str, List[torch.Tensor]] = {n: [] for n in out_names}
        for t in (range(t_max - 1, -1, -1) if core.reverse else range(t_max)):
            values = _eval_subnet(core.order, ctx, seeded_at(t))
            new_carry = {}
            for m in core.memories:
                new = _carry_value(values[core.links[m.name].name], carry[m.name])
                new_carry[m.name] = _masked(t < mem_lengths[m.name], new, carry[m.name])
            carry = new_carry
            for n in out_names:
                stacked[n].append(values[n].value)
        # state updates made inside a step are dropped, as the JAX package
        # drops them (stateful layers do not run in recurrent layer groups)
        for k in list(ctx.state_updates):
            if k not in keys0:
                del ctx.state_updates[k]
        outs: Dict[str, Argument] = {}
        for n, ys in stacked.items():
            if core.reverse:
                ys = ys[::-1]
            outs[n] = Argument(torch.stack(ys, dim=1), dep_lengths(n))
        return outs

    def _run_nested(self, ctx: Context, seq: List[Argument], static: List[Argument],
                    boot_map: Dict[str, Argument]) -> Dict[str, Argument]:
        """Hierarchical unroll (SubsequenceInput): the outer loop walks the
        subsequence axis of [B, S, T, ...] inputs, each step feeding the step
        net a level-1 sequence; an inner recurrent_group in the step net is
        the inner loop (sequence_nest_rnn.conf)."""
        core = self.core
        anchor = next((a for a in seq if _is_nested_arg(a)), None)
        if anchor is None:
            raise ValueError(f"{self.name}: SubsequenceInput needs a nested [B, S, T, ...] "
                             "Argument with sub_lengths [B, S]")
        outer_len = anchor.lengths  # [B] valid subsequence counts
        sub_lengths = anchor.sub_lengths  # [B, S]
        batch, s_max = anchor.value.shape[:2]

        seeded_static: Dict[str, Argument] = {}
        core.seed_static(seeded_static, static)
        carry = core.init_carry(ctx, batch, anchor.value.device, boot_map)
        seq_phs = core.seq_phs()
        out_names = [l.name for l in core.out_layers]

        def slice_s(a: Argument, s: int) -> Argument:
            # per-input sequence matching (RecurrentGradientMachine): a
            # nested input gives its s-th subsequence as a level-1 sequence,
            # a flat sequence its s-th step, a non-sequence itself
            if _is_nested_arg(a):
                return Argument(a.value[:, s], a.sub_lengths[:, s])
            if a.lengths is not None:
                return Argument(a.value[:, s])
            return a

        def seeded_at(s: int) -> Dict[str, Argument]:
            seeded = dict(seeded_static)
            for ph, a in zip(seq_phs, seq):
                seeded[ph.name] = slice_s(a, s)
            for m in core.memories:
                seeded[m.name] = Argument(carry[m.name])
            return seeded

        if ctx.mode == "init":
            values = _eval_subnet(core.order, ctx, seeded_at(0))
            outs: Dict[str, Argument] = {}
            for n in out_names:
                v = values[n]
                tiled = _tile(v.value, s_max)
                # a sequence-valued step output stacks to [B, S, T, ...]; a
                # flat one to a level-1 sequence [B, S, D] over s
                outs[n] = (Argument(tiled, outer_len, sub_lengths) if v.is_seq
                           else Argument(tiled, outer_len))
            return outs

        # a generating step (beam_search) computes the lengths of what it
        # returns: those stack into the output's sub_lengths (the reference
        # concatenates the generated inner results,
        # RecurrentGradientMachine.cpp:536)
        gen_outs = {l.name for l in core.out_layers if isinstance(l, BeamSearchLayer)}
        keys0 = set(ctx.state_updates)
        stacked: Dict[str, List[torch.Tensor]] = {n: [] for n in out_names}
        gen_lengths: Dict[str, List[torch.Tensor]] = {n: [] for n in gen_outs}
        out_is_seq: Dict[str, bool] = {}
        for s in (range(s_max - 1, -1, -1) if core.reverse else range(s_max)):
            values = _eval_subnet(core.order, ctx, seeded_at(s))
            valid = s < outer_len
            carry = {m.name: _masked(valid, _carry_value(values[core.links[m.name].name],
                                                         carry[m.name]), carry[m.name])
                     for m in core.memories}
            for n in out_names:
                out_is_seq[n] = values[n].is_seq
                stacked[n].append(values[n].value)
            for n in gen_outs:
                gen_lengths[n].append(values[n].lengths)
        for k in list(ctx.state_updates):
            if k not in keys0:
                del ctx.state_updates[k]

        deps = core.seq_deps()

        def dep_sub_lengths(name: str) -> torch.Tensor:
            # inner lengths follow the nested inputs in the output's ancestry
            idxs = [i for i in deps.get(name, set()) if _is_nested_arg(seq[i])]
            if not idxs:
                return sub_lengths
            out = seq[idxs[0]].sub_lengths
            for i in idxs[1:]:
                out = torch.maximum(out, seq[i].sub_lengths)
            return out

        outs = {}
        for n, ys in stacked.items():
            if core.reverse:
                ys = ys[::-1]
            ys = torch.stack(ys, dim=1)
            # a sequence-valued step output (an inner group's unroll) stacks
            # to a nested [B, S, T, ...]; a flat one to a level-1 sequence
            if not out_is_seq[n]:
                outs[n] = Argument(ys, outer_len)
                continue
            if n in gen_outs:
                ls = gen_lengths[n][::-1] if core.reverse else gen_lengths[n]
                sub = torch.stack(ls, dim=1)
            else:
                sub = dep_sub_lengths(n)
            outs[n] = Argument(ys, outer_len, sub)
        return outs


def _tile(v: torch.Tensor, n: int) -> torch.Tensor:
    """[B, ...] -> [B, n, ...], a copy of v at every step."""
    return v.unsqueeze(1).expand(v.shape[0], n, *v.shape[1:]).contiguous()


def recurrent_group(step: Callable, input: Union[Layer, StaticInput, Sequence],
                    reverse: bool = False, name: Optional[str] = None,
                    **_compat) -> Union[Layer, tuple]:
    """Build the group. A step returning one layer gives one node; a step
    returning a tuple or list gives a tuple of nodes (the reference's
    multi-output contract, `a, b = recurrent_group(...)`). Every step output
    is also reachable through get_output_layer."""
    core = _GroupCore(step, input, reverse=reverse)
    if core.generated is not None:
        raise ValueError("GeneratedInput is only valid under beam_search")
    node = RecurrentGroup(core, 0, name=name)
    node._group_core = core
    if core.multi_out:
        extra = []
        for i in range(1, len(core.out_layers)):
            n = RecurrentGroup(core, i, name=f"{node.name}.out{i}")
            n._group_core = core
            extra.append(n)
        return tuple([node] + extra)
    return node


def get_output_layer(group: Layer, out_name: str, name: Optional[str] = None) -> Layer:
    """Another step-net output of a recurrent_group (GetOutputLayer)."""
    core = getattr(group, "_group_core", None) or getattr(group, "core", None)
    if core is None:
        raise TypeError(f"{group!r} is not a recurrent_group output")
    names = [l.name for l in core.out_layers]
    if out_name not in names:
        raise ValueError(f"step net has outputs {names}, not {out_name!r}")
    node = RecurrentGroup(core, names.index(out_name), name=name)
    node._group_core = core
    return node


# ---------------------------------------------------------------------------
# generation: beam search over a step net
# ---------------------------------------------------------------------------


class BeamSearchLayer(Layer):
    """v1 beam_search(): generate with the step net.

    Output Argument: value [B, max_length] int32, the best beam's token
    ids, lengths [B] (up to and including EOS). The run's cache holds every
    beam under ("beam", name) (history [B, K, L], scores [B, K], lengths
    [B, K], num_results, eos_id) for the sequence printer, and the scores
    under (id(core), "beam_scores")."""

    type_name = "beam_search"

    def __init__(self, core: _GroupCore, bos_id: int, eos_id: int, beam_size: int,
                 max_length: int, num_results_per_sample: int = 1,
                 name: Optional[str] = None):
        super().__init__(core.outer_inputs(), name=name)
        self.core = core
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.beam_size = beam_size
        self.max_length = max_length
        self.num_results_per_sample = min(num_results_per_sample, beam_size)

    def _embed(self, ctx: Context, tokens: torch.Tensor) -> torch.Tensor:
        gen = self.core.generated
        table = ctx.param(self, "emb", (gen.size, gen.embedding_size), init_mod.normal(0.01),
                          ParamAttr(name=gen.embedding_name))
        return table[tokens.long()]

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        core = self.core
        if core.generated is None:
            raise ValueError("beam_search step needs a GeneratedInput")
        seq, static, boot_map = core.split_outer(ins)
        if seq:
            raise ValueError("beam_search inputs must be StaticInput/GeneratedInput only")
        if static:
            anchor = static[0].value
        elif boot_map:
            anchor = next(iter(boot_map.values())).value
        else:
            raise ValueError("beam_search needs a static or boot input for batch size")
        batch, dev = anchor.shape[0], anchor.device
        k, max_len = self.beam_size, self.max_length
        carry0 = core.init_carry(ctx, batch, dev, boot_map)
        gen_name = core.gen_placeholder.name

        if ctx.mode == "init":
            # one step from BOS creates every parameter of the step net
            seeded: Dict[str, Argument] = {}
            core.seed_static(seeded, static)
            bos = torch.full((batch,), self.bos_id, dtype=torch.int32, device=dev)
            seeded[gen_name] = Argument(self._embed(ctx, bos))
            for m in core.memories:
                seeded[m.name] = Argument(carry0[m.name])
            _eval_subnet(core.order, ctx, seeded)
            return Argument(torch.zeros((batch, max_len), dtype=torch.int32, device=dev),
                            torch.ones((batch,), dtype=torch.int32, device=dev))

        # static inputs and memories tiled over the beams: batch axis B*K
        def tile(x: torch.Tensor) -> torch.Tensor:
            return x.repeat_interleave(k, dim=0)

        static_args: Dict[str, Argument] = {}
        core.seed_static(static_args, static)
        static_tiled = {n: Argument(tile(a.value), None if a.lengths is None else tile(a.lengths))
                        for n, a in static_args.items()}
        prob_layer = core.out_layers[0].name

        def step_fn(tokens: torch.Tensor, carry: Dict[str, torch.Tensor], t: int):
            seeded = dict(static_tiled)
            seeded[gen_name] = Argument(self._embed(ctx, tokens))
            for m in core.memories:
                seeded[m.name] = Argument(carry[m.name])
            values = _eval_subnet(core.order, ctx, seeded)
            probs = values[prob_layer].value.float()
            new_carry = {m.name: values[core.links[m.name].name].value for m in core.memories}
            return torch.clamp_min(probs, 1e-20).log(), new_carry

        keys0 = set(ctx.state_updates)
        res = beam_search_scan(step_fn, {n: tile(v) for n, v in carry0.items()}, batch=batch,
                               vocab=core.generated.size, bos_id=self.bos_id,
                               eos_id=self.eos_id, beam_size=k, max_len=max_len, device=dev)
        for key in list(ctx.state_updates):
            if key not in keys0:
                del ctx.state_updates[key]
        # beams arrive sorted best first from the engine; the whole result
        # stays for the printer (fillGenOutputs packs [len, ids..., -1] a
        # beam and a probability matrix, RecurrentGradientMachine.cpp:
        # 1301-1345; the arrays are kept instead)
        ctx.cache[(id(core), "beam_scores")] = res.scores
        ctx.cache[("beam", self.name)] = {
            "history": res.history, "scores": res.scores, "lengths": res.lengths,
            "num_results": self.num_results_per_sample, "eos_id": self.eos_id,
        }
        return Argument(res.history[:, 0], res.lengths[:, 0])


def beam_search(step: Callable, input: Sequence, bos_id: int, eos_id: int,
                beam_size: int = 4, max_length: int = 50, num_results_per_sample: int = 1,
                name: Optional[str] = None, **_compat) -> Layer:
    core = _GroupCore(step, input)
    node = BeamSearchLayer(core, bos_id, eos_id, beam_size, max_length,
                           num_results_per_sample=num_results_per_sample, name=name)
    node._group_core = core
    return node
