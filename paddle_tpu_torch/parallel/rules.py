"""Named sharding rules: logical array axes -> mesh axes (counterpart of
`paddle_tpu/parallel/rules.py`).

Arrays declare LOGICAL axis names once (`ParamAttr(logical_axes=("embed",
"mlp"))`), and ONE rules table maps logical names to mesh axes for the
deployment at hand, so the same model moves between a data-only training
mesh and a tensor-parallel mesh by a table edit, not a model edit.

Resolution, as in the JAX package:

  * a logical name maps through the table to a mesh axis (or None =
    replicated);
  * a resolved mesh axis NOT present in the target mesh resolves to
    replicated, which lets a model that declares ``heads: "model"`` (or
    ResNet's conv and batch-norm axes, or seq2seq's ("vocab", "embed")) run
    unchanged on the data-only mesh;
  * a name in neither the table nor the mesh axes raises, naming the
    parameter: a typo must not silently replicate;
  * legacy ``ParamAttr.sharding`` tuples (mesh-axis names used directly)
    resolve through the table's identity shim, with one DeprecationWarning
    per process.

A resolved spec is a tuple of mesh-axis names or None, one per array
dimension: the port has no `PartitionSpec`. `make_tp_mesh` (the 2-D data
x model mesh) is ROADMAP.md §1 item 8b and raises."""

from __future__ import annotations

import warnings
from typing import Dict, Optional, Sequence, Tuple

from paddle_tpu_torch.parallel.mesh import _ITEM8B, AXES, Mesh

Spec = Tuple[Optional[str], ...]

_legacy_sharding_warned = False


def warn_legacy_sharding(param: str) -> None:
    """One DeprecationWarning per process for raw mesh-axis ParamAttr.sharding
    tuples (they still resolve through the rules table's identity shim)."""
    global _legacy_sharding_warned
    if _legacy_sharding_warned:
        return
    _legacy_sharding_warned = True
    warnings.warn(
        f"ParamAttr(sharding=...) mesh-axis tuples are deprecated (first seen on "
        f"{param!r}): declare ParamAttr(logical_axes=...) and let the rules table "
        f"(parallel/rules.py DEFAULT_RULES) map logical axes to mesh axes",
        DeprecationWarning, stacklevel=3)


# the one serving + training sharding vocabulary; values are mesh axis names
# or None (replicated)
DEFAULT_RULES: Dict[str, Optional[str]] = {
    "batch": "data",      # batch rows over the data axis
    "heads": "model",     # attention query heads (column-parallel qkv)
    "kv_heads": "model",  # KV heads: the paged KV pool shards this too
    "mlp": "model",       # MLP hidden (column-parallel w1 / row-parallel w2)
    "vocab": "model",     # embed rows / unembed columns
    "embed": None,        # d_model stays replicated
    "length": None,       # sequence positions
    "expert": "expert",   # row-sharded embedding tables
    "pipeline": None,     # reserved for a pipeline-parallel axis
}


class ShardingRules:
    """A logical-axis -> mesh-axis table with validated resolution;
    `spec_for` is the one resolution seam (`DataParallel.param_sharding`
    and the ZeRO updaters' flat geometry both call it)."""

    def __init__(self, rules: Optional[Dict[str, Optional[str]]] = None):
        self.table: Dict[str, Optional[str]] = dict(DEFAULT_RULES if rules is None else rules)

    def with_overrides(self, **overrides: Optional[str]) -> "ShardingRules":
        return ShardingRules({**self.table, **overrides})

    def mesh_axis(self, logical: Optional[str], mesh: Optional[Mesh] = None,
                  param: str = "<array>") -> Optional[str]:
        """One logical name -> the mesh axis it shards over (None =
        replicated). Unknown names that are not mesh axes raise, naming the
        parameter; known names whose axis the mesh lacks resolve to None."""
        if logical is None:
            return None
        if logical in self.table:
            axis = self.table[logical]
        elif logical in AXES or (mesh is not None and logical in mesh.axis_names):
            axis = logical  # the legacy shim: a mesh-axis name is its own logical name
        else:
            raise KeyError(
                f"unknown logical sharding axis {logical!r} for {param!r}: not in the "
                f"rules table {sorted(self.table)} and not a mesh axis — add a rules "
                "entry or fix the axis name")
        if axis is not None and mesh is not None and (
                axis not in mesh.axis_names or mesh.shape[axis] == 1):
            # the axis does not bite on this mesh (absent, or extent 1)
            return None
        return axis

    def spec_for(self, logical_axes: Sequence[Optional[str]], mesh: Optional[Mesh] = None,
                 ndim: Optional[int] = None, param: str = "<array>") -> Spec:
        """A logical-axes tuple -> one mesh axis (or None) per dimension. A
        spec longer than the array's rank raises; a shorter one pads with
        None (trailing dimensions replicated)."""
        axes = tuple(logical_axes)
        if ndim is not None:
            if len(axes) > ndim:
                raise ValueError(
                    f"sharding spec {axes} for {param!r} names {len(axes)} axes but the "
                    f"array has rank {ndim} — rank-mismatched specs are rejected")
            axes = axes + (None,) * (ndim - len(axes))
        return tuple(self.mesh_axis(a, mesh, param) for a in axes)


def make_tp_mesh(tp: int, data: int = 1, group=None):
    """The 2-D ("data", "model") mesh of tensor-parallel serving and
    training: ROADMAP.md §1 item 8b, not ported yet."""
    tp = int(tp)
    if tp < 1:
        raise ValueError(f"tensor-parallel size must be >= 1, got {tp}")
    raise NotImplementedError(_ITEM8B.format(axis="model"))
