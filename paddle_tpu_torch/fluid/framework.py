"""The fluid program representation (counterpart of
`paddle_tpu/fluid/framework.py`; the reference's framework.proto and
python/paddle/v2/framework/framework.py): ProgramDesc -> blocks ->
OpDesc / VarDesc, the Program / Block / Variable handles and the Scope.

Plain Python over the descs, copied from the JAX package so that a program
built here prints the same `to_string` text and prunes to the same ops.
The Executor (`executor.py`) interprets a block op by op on torch tensors;
on the card it captures a whole run as one CUDA graph per feed signature,
while the desc layer keeps the reference's introspectable graph."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


@dataclass
class VarDesc:
    name: str
    shape: Optional[Sequence[int]] = None  # None -> inferred at first write
    dtype: Any = np.float32
    persistable: bool = False  # parameters & optimizer slots
    # False for optimizer slots (moments/lr) and BN moving stats: persistable
    # state that must not receive gradients. An explicit registry: gradient
    # filtering never relies on name-substring heuristics.
    trainable: bool = True
    is_data: bool = False
    lod_level: int = 0  # kept for LoDTensor parity (ragged inputs)
    initializer: Optional[Any] = None  # ("uniform", lo, hi) | ("constant", v) | ndarray


@dataclass
class OpDesc:
    type: str
    inputs: Dict[str, List[str]] = field(default_factory=dict)
    outputs: Dict[str, List[str]] = field(default_factory=dict)
    attrs: Dict[str, Any] = field(default_factory=dict)


@dataclass
class BlockDesc:
    idx: int
    parent_idx: int = -1
    vars: Dict[str, VarDesc] = field(default_factory=dict)
    ops: List[OpDesc] = field(default_factory=list)


class Variable:
    """Python handle to a VarDesc inside a block (framework.py Variable)."""

    def __init__(self, block: "Block", desc: VarDesc):
        self.block = block
        self.desc = desc

    @property
    def name(self) -> str:
        return self.desc.name

    @property
    def shape(self):
        return tuple(self.desc.shape) if self.desc.shape is not None else None

    @property
    def dtype(self):
        return self.desc.dtype

    @property
    def persistable(self) -> bool:
        return self.desc.persistable

    def __repr__(self):
        return f"<Variable {self.name} shape={self.desc.shape}>"


class Block:
    def __init__(self, program: "Program", desc: BlockDesc):
        self.program = program
        self.desc = desc
        self.vars: Dict[str, Variable] = {}

    @property
    def idx(self) -> int:
        return self.desc.idx

    def create_var(self, name: Optional[str] = None, **kw) -> Variable:
        name = name or self.program.unique_name("tmp")
        if name in self.vars:
            return self.vars[name]
        desc = VarDesc(name=name, **kw)
        self.desc.vars[name] = desc
        v = Variable(self, desc)
        self.vars[name] = v
        return v

    def create_parameter(self, name: Optional[str] = None, **kw) -> Variable:
        kw.setdefault("persistable", True)
        name = name or self.program.unique_name("param")
        return self.create_var(name, **kw)

    def var(self, name: str) -> Variable:
        b: Optional[Block] = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = (
                self.program.blocks[b.desc.parent_idx]
                if b.desc.parent_idx >= 0
                else None
            )
        raise KeyError(f"variable {name!r} not found in block {self.idx}")

    def append_op(
        self,
        type: str,  # noqa: A002
        inputs: Optional[Dict[str, Any]] = None,
        outputs: Optional[Dict[str, Any]] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ) -> OpDesc:
        def names(d):
            out = {}
            for k, v in (d or {}).items():
                vs = v if isinstance(v, (list, tuple)) else [v]
                out[k] = [x.name if isinstance(x, Variable) else str(x) for x in vs]
            return out

        op = OpDesc(type=type, inputs=names(inputs), outputs=names(outputs),
                    attrs=dict(attrs or {}))
        self.desc.ops.append(op)
        return op


class Program:
    """ProgramDesc handle (framework/program_desc.h; framework.py Program)."""

    def __init__(self):
        self.blocks: List[Block] = []
        self._counter = 0
        root = BlockDesc(idx=0)
        self.blocks.append(Block(self, root))
        self._current = 0

    def unique_name(self, prefix: str) -> str:
        self._counter += 1
        return f"{prefix}_{self._counter}"

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self._current]

    def create_block(self) -> Block:
        desc = BlockDesc(idx=len(self.blocks), parent_idx=self._current)
        b = Block(self, desc)
        self.blocks.append(b)
        self._current = b.idx
        return b

    def rollback(self) -> None:
        if self._current == 0:
            raise RuntimeError("rollback() on the root block")
        self._current = self.blocks[self._current].desc.parent_idx

    # -- introspection -------------------------------------------------------
    def parameters(self) -> List[Variable]:
        return [v for v in self.global_block().vars.values() if v.persistable]

    def prune(self, targets: Sequence[Any]) -> "Program":
        """Inference-program extraction (framework/prune.cc Prune): keep only
        the ops whose outputs (transitively) feed `targets` (variable names
        or Variables), walking each block backwards; sub-blocks referenced by
        surviving control-flow ops survive whole."""
        want = {
            t.name if isinstance(t, Variable) else str(t) for t in targets
        }
        keep_blocks: Dict[int, List] = {}

        def prune_block(idx: int, needed: set) -> None:
            block = self.blocks[idx]
            kept = []
            for op in reversed(block.desc.ops):
                outs = {n for ns in op.outputs.values() for n in ns}
                if outs & needed or op.type in ("feed", "print"):
                    kept.append(op)
                    for ns in op.inputs.values():
                        needed.update(ns)
                    subs = [op.attrs.get(k) for k in
                            ("sub_block", "true_block", "false_block")]
                    for sb in subs:
                        bidx = getattr(sb, "idx", sb)
                        if isinstance(bidx, int) and bidx not in keep_blocks:
                            inner_needed = {
                                n for ns in op.inputs.values() for n in ns
                            } | needed
                            prune_block(bidx, set(inner_needed))
            kept.reverse()
            keep_blocks[idx] = kept

        prune_block(0, set(want))

        pruned = Program.__new__(Program)
        pruned.blocks = []
        pruned._counter = self._counter
        pruned._current = 0
        for b in self.blocks:
            desc = BlockDesc(idx=b.idx, parent_idx=b.desc.parent_idx)
            desc.vars = dict(b.desc.vars)
            desc.ops = list(keep_blocks.get(b.idx, b.desc.ops))
            nb = Block(pruned, desc)
            nb.vars = dict(b.vars)
            pruned.blocks.append(nb)
        return pruned

    def to_string(self) -> str:
        lines = []
        for b in self.blocks:
            lines.append(f"block {b.idx} (parent {b.desc.parent_idx}):")
            for name, vd in b.desc.vars.items():
                tag = " param" if vd.persistable else (" data" if vd.is_data else "")
                lines.append(f"  var {name} shape={vd.shape}{tag}")
            for op in b.desc.ops:
                lines.append(
                    f"  op {op.type}({op.inputs}) -> {op.outputs} {op.attrs}"
                )
        return "\n".join(lines)


class Scope:
    """Name -> value store with parent chain (framework/scope.h:38). The
    Executor keeps torch tensors here; `numpy()` reads them back by name."""

    def __init__(self, parent: Optional["Scope"] = None):
        self.parent = parent
        self.values: Dict[str, Any] = {}

    def find(self, name: str) -> Any:
        s: Optional[Scope] = self
        while s is not None:
            if name in s.values:
                return s.values[name]
            s = s.parent
        raise KeyError(f"variable {name!r} not in scope")

    def has(self, name: str) -> bool:
        try:
            self.find(name)
            return True
        except KeyError:
            return False

    def set(self, name: str, value: Any) -> None:
        self.values[name] = value

    def new_child(self) -> "Scope":
        return Scope(parent=self)

    def numpy(self) -> Dict[str, np.ndarray]:
        """This scope's own values as host arrays, by name (a copy)."""
        return {k: v.detach().cpu().numpy().copy() if hasattr(v, "detach") else np.array(v)
                for k, v in self.values.items()}
