"""Collectives over the named axes of a ``DeviceMesh``, and the autograd
functions that place them in the forward pass.

GSPMD partitions a global program and inserts its collectives itself;
PyTorch runs each rank's local program as written.  So the port states
them: each rank holds local shards, and the model calls these functions
where the partitioner would have put a collective.  An operation over
several axes runs one axis after the other (a sum or a max over the
product group is a sum or a max over each axis in turn; a gather over
``("data", "model")`` gathers ``model``, the minor axis, first), so no
flattened group is needed.

The autograd functions act on one axis (the tensor-parallel one):

- ``copy_to``: identity forward, sum backward.  A replicated tensor fed to
  rank-specific work (column-parallel products, a replicated weight used
  for this rank's heads only).
- ``reduce_from``: sum forward, identity backward.  Partial sums out of
  row-parallel products, vocabulary-parallel reductions.
- ``gather_from(dim, partial=)``: all-gather forward; backward the sum of
  the ranks' gradients (``partial``: the consumer is rank-specific) or this
  rank's slice (the consumer is replicated).
- ``scatter_to(dim)``: this rank's slice forward, all-gather backward.
- ``reduce_scatter_to(dim)``: sum then this rank's slice forward,
  all-gather backward (Megatron sequence parallelism after a row-parallel
  product).
"""
from __future__ import annotations

import warnings

import torch
import torch.distributed as dist


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` in a ``DeviceMesh`` or an ``AbstractMesh`` (1
    for an axis the mesh lacks)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape)).get(axis, 1)


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 for an axis the mesh lacks)."""
    if axis not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(axis)


def axes_index(mesh, axes) -> tuple[int, int]:
    """(this rank's index, the count) along ``axes`` taken together, the
    first axis major, as a dimension sharded over them is laid out."""
    idx, n = 0, 1
    for a in axes:
        size = axis_size(mesh, a)
        idx, n = idx * size + axis_index(mesh, a), n * size
    return idx, n


def _quiet(fn, *args, **kw):
    # torch >= 2.12 renames the *_tensor collectives (a FutureWarning per
    # call); the card's torch has only the old names
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return fn(*args, **kw)


def all_reduce(x: torch.Tensor, mesh, axes, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """``x`` reduced over ``axes``, in place (a contiguous ``x``); returns
    it.  Not differentiable."""
    for a in axes:
        if a in mesh.mesh_dim_names:
            dist.all_reduce(x, op=op, group=mesh.get_group(a))
    return x


def _along(out: torch.Tensor, dim: int) -> torch.Tensor:
    """A collective's result, gathered or scattered along its leading dim,
    moved to ``dim`` and laid out whole: the kernels take contiguous rows
    (RMSNorm) and a contiguous last dim (flash attention), and a view with
    ``dim`` moved would give them neither."""
    return out if dim == 0 else out.movedim(0, dim).contiguous()


def _gather_one(x: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    n = axis_size(mesh, axis)
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    _quiet(dist.all_gather_into_tensor, out, src, group=mesh.get_group(axis))
    return _along(out, dim)


def all_gather(x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """The full tensor from each rank's shard of dim ``dim`` over
    ``axes`` (first axis major).  Not differentiable."""
    for a in reversed(tuple(axes)):
        if a in mesh.mesh_dim_names:
            x = _gather_one(x, dim, mesh, a)
    return x


def reduce_scatter(x: torch.Tensor, dim: int, mesh, axis: str
                   ) -> torch.Tensor:
    """The sum over ``axis``, this rank's slice of dim ``dim``."""
    n = axis_size(mesh, axis)
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    _quiet(dist.reduce_scatter_tensor, out, src, group=mesh.get_group(axis))
    return _along(out, dim)


def local_slice(x: torch.Tensor, dim: int, index: int, count: int
                ) -> torch.Tensor:
    n = x.shape[dim] // count
    return x.narrow(dim, index * n, n)


# ---------------------------------------------------------------------------
# autograd functions over one axis
# ---------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.mesh, (ctx.axis,)), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x.contiguous().clone(), mesh, (axis,))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axis, partial):
        ctx.args = dim, mesh, axis, partial
        return all_gather(x, dim, mesh, (axis,))

    @staticmethod
    def backward(ctx, g):
        dim, mesh, axis, partial = ctx.args
        if partial:
            g = reduce_scatter(g, dim, mesh, axis)
        else:
            g = local_slice(g, dim, axis_index(mesh, axis),
                            axis_size(mesh, axis))
        return g, None, None, None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axis):
        ctx.args = dim, mesh, axis
        return local_slice(x, dim, axis_index(mesh, axis),
                           axis_size(mesh, axis)).contiguous()

    @staticmethod
    def backward(ctx, g):
        dim, mesh, axis = ctx.args
        return all_gather(g, dim, mesh, (axis,)), None, None, None


class _ReduceScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axis):
        ctx.args = dim, mesh, axis
        return reduce_scatter(x, dim, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        dim, mesh, axis = ctx.args
        return all_gather(g, dim, mesh, (axis,)), None, None, None


def copy_to(x, mesh, axis):
    return _CopyTo.apply(x, mesh, axis)


def reduce_from(x, mesh, axis):
    return _ReduceFrom.apply(x, mesh, axis)


def gather_from(x, dim, mesh, axis, *, partial: bool):
    return _GatherFrom.apply(x, dim, mesh, axis, partial)


def scatter_to(x, dim, mesh, axis):
    return _ScatterTo.apply(x, dim, mesh, axis)


def reduce_scatter_to(x, dim, mesh, axis):
    return _ReduceScatterTo.apply(x, dim, mesh, axis)
