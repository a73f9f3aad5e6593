"""Row-sharded embedding tables over the mesh's `expert` axis (counterpart
of `paddle_tpu/parallel/embedding.py`): the EP ancestor in the reference,
SparseRemoteParameterUpdater's row-sharded pserver tables.

Each rank of the axis holds rows [i*V/n, (i+1)*V/n) of a [V, D] table
(`shard_table`). A lookup (`sharded_lookup`) gathers the ids that fall in
this rank's rows, writes zero rows for the others, and one all-reduce over
the axis combines the parts: exact, since exactly one rank adds a nonzero
row for each id. The backward (`_ShardedLookup.backward`) is the row-sparse
scatter-add of the output's gradient into the owning shard's rows, the
gradient the JAX package's autodiff of its masked gather gives and the
pserver protocol implements by hand."""

from __future__ import annotations

import torch

from paddle_tpu_torch.parallel.mesh import Mesh


def shard_table(table: torch.Tensor, mesh: Mesh, axis: str = "expert") -> torch.Tensor:
    """This rank's rows of a [V, D] table split over `axis` (V must divide
    evenly), on the mesh's device."""
    n = mesh.extent(axis)
    if table.shape[0] % n != 0:
        raise ValueError(f"vocab {table.shape[0]} not divisible by mesh axis {axis!r} ({n})")
    rows = table.shape[0] // n
    lo = mesh.index(axis) * rows
    return table[lo:lo + rows].detach().to(mesh.device).clone()


class _ShardedLookup(torch.autograd.Function):
    """ids -> [..., D]: the masked local gather, summed over the axis; its
    backward scatters the output's gradient into this rank's rows."""

    @staticmethod
    def forward(ctx, local, ids, mesh, axis):
        rows = local.shape[0]
        off = ids.long() - mesh.index(axis) * rows
        mine = (off >= 0) & (off < rows)
        safe = off.clamp(0, rows - 1)
        part = torch.where(mine[..., None], local[safe], local.new_zeros(()))
        mesh.all_reduce_(part, axis)
        ctx.save_for_backward(safe, mine)
        ctx.rows = rows
        return part

    @staticmethod
    def backward(ctx, d_out):
        safe, mine = ctx.saved_tensors
        d_local = d_out.new_zeros((ctx.rows, d_out.shape[-1]))
        d_local.index_add_(0, safe[mine], d_out[mine])
        return d_local, None, None, None


def sharded_lookup(table: torch.Tensor, ids: torch.Tensor, mesh: Mesh,
                   axis: str = "expert") -> torch.Tensor:
    """ids [...] (the same on every rank of `axis`) -> [..., D] from the
    table whose rows this rank holds (`shard_table`): each rank serves its
    own row range and one all-reduce combines them."""
    ids = torch.as_tensor(ids, device=table.device)
    return _ShardedLookup.apply(table, ids, mesh, axis)


class ShardedEmbeddingState:
    """Bundles this rank's rows of a table with its mesh and axis for the
    layer seam."""

    def __init__(self, table: torch.Tensor, mesh: Mesh, axis: str = "expert"):
        self.mesh = mesh
        self.axis = axis
        self.table = shard_table(table, mesh, axis)

    def __call__(self, ids: torch.Tensor) -> torch.Tensor:
        return sharded_lookup(self.table, ids, self.mesh, self.axis)
