"""What a run may not load, compared by whole top-level module names (the
part before the first dot): JAX, its libraries and the JAX package. The
port, `paddle_tpu_torch`, begins with the JAX package's name and is not
the JAX package."""

from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Iterable, List, Set

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "paddle_tpu"})
PROGRAM = "paddle_tpu_torch"


def top(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_modules(modules: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among `modules` (sys.modules)."""
    names = sys.modules if modules is None else modules
    return sorted({top(m) for m in names} & FORBIDDEN)


def imported_tops(path: Path) -> Set[str]:
    """Top-level names of every module a Python file imports (absolute
    imports; a relative one is the benchmark's own)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(top(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(top(node.module))
    return out
