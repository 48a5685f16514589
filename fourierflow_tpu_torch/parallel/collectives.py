"""The collectives of the parallel layers (the port's own module: in the JAX
package GSPMD inserts them, ``fourierflow_tpu/parallel/mesh.py``'s
docstring).

An ``Axis`` is one mesh axis as a layer sees it: its process group, its size
and this rank's index on it. The autograd Functions here each have the
adjoint collective as their backward:

- ``copy_to`` (identity forward, all-reduce backward) and ``reduce_from``
  (all-reduce forward, identity backward): Megatron's f and g around a
  tensor-parallel region, whose input is replicated over ``model`` and
  whose output is a partial sum;
- ``gather`` (all-gather forward, this rank's block backward) and
  ``scatter`` (the reverse), along any dim: the channels of a column-split
  spectral mix, the slices of a replicated bias;
- ``on_first_rank``: a replicated tensor on the axis's rank 0 and zeros on
  the others, the gradient passed through (the feed-forward's output bias,
  added once to a partial sum).

``all_reduce`` and ``all_gather`` are the plain collectives, for what no
gradient flows through (statistics, metrics, features). ``y_split`` and
``x_split`` are the all-to-all over ``spatial`` that turns ``[B, X/sp, Y,
C]`` into ``[B, X, Y/sp, C]``, and its inverse: each is the other's
adjoint, and the spatially split mix (``models/ffno_grid_2d.py``) calls
both in its forward and its backward. A collective that fails raises;
nothing here falls back.
"""

from dataclasses import dataclass

import torch
import torch.distributed as dist

__all__ = ["Axis", "mesh_axis", "all_reduce", "all_gather", "y_split", "x_split", "copy_to",
           "reduce_from", "gather", "scatter", "on_first_rank"]


@dataclass(frozen=True, eq=False)
class Axis:
    """One axis of a device mesh: its name, process group, size and this
    rank's index on it."""

    name: str
    group: object
    size: int
    rank: int


def mesh_axis(mesh, name: str):
    """The ``Axis`` named ``name`` of a ``DeviceMesh``; None without a mesh
    or where the mesh has no such axis."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return None
    dim = mesh.mesh_dim_names.index(name)
    return Axis(name, mesh.get_group(name), mesh.size(dim), mesh.get_local_rank(name))


def all_reduce(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of ``t`` over the axis's ranks, in a new tensor."""
    out = t.contiguous().clone()
    dist.all_reduce(out, group=axis.group)
    return out


def all_gather(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in rank order."""
    parts = [torch.empty_like(t, memory_format=torch.contiguous_format) for _ in range(axis.size)]
    dist.all_gather(parts, t.contiguous(), group=axis.group)
    return torch.cat(parts, dim=dim)


def _block(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim``, which the axis must divide."""
    n = t.shape[dim]
    if n % axis.size:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not divide the '{axis.name}' axis "
                         f"of {axis.size}")
    k = n // axis.size
    return t.narrow(dim, axis.rank * k, k).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.axis, ctx.dim), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _block(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.axis, ctx.dim), None, None


class _OnFirstRank(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return x.clone() if axis.rank == 0 else torch.zeros_like(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _all_to_all(send: torch.Tensor, axis: Axis) -> torch.Tensor:
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=axis.group)
    return recv


def y_split(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``[B, X/sp, Y, C]`` -> ``[B, X, Y/sp, C]``: rank j gets the j-th Y
    block of every rank's X rows, stacked in rank order."""
    b, xl, y, c = x.shape
    if y % axis.size:
        raise ValueError(f"the grid's Y ({y}) does not divide the '{axis.name}' axis of "
                         f"{axis.size}")
    yl = y // axis.size
    send = x.reshape(b, xl, axis.size, yl, c).permute(2, 0, 1, 3, 4).contiguous()
    return _all_to_all(send, axis).permute(1, 0, 2, 3, 4).reshape(b, axis.size * xl, yl, c)


def x_split(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``[B, X, Y/sp, C]`` -> ``[B, X/sp, Y, C]``, the inverse of ``y_split``."""
    b, xg, yl, c = x.shape
    xl = xg // axis.size
    send = x.reshape(b, axis.size, xl, yl, c).permute(1, 0, 2, 3, 4).contiguous()
    return _all_to_all(send, axis).permute(1, 2, 0, 3, 4).reshape(b, xl, axis.size * yl, c)


def copy_to(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x`` as it is; its gradient summed over the axis (a replicated input
    of a region whose ranks each give part of the gradient)."""
    return _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of the ranks' ``x``; the gradient passed through (it is the
    same on every rank of the axis)."""
    return _ReduceFrom.apply(x, axis)


def gather(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The ranks' blocks concatenated along ``dim``; the gradient's block of
    this rank flows back."""
    return _Gather.apply(x, axis, dim)


def scatter(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """This rank's block of a replicated ``x`` along ``dim``; the gradient is
    the ranks' blocks' gradients gathered."""
    return _Scatter.apply(x, axis, dim)


def on_first_rank(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x`` on the axis's rank 0 and zeros on its other ranks, so that a sum
    over the axis adds it once. The gradient passes through unchanged on
    every rank: it is the gradient of the one ``x`` in that sum, which every
    rank of the axis computes alike."""
    return _OnFirstRank.apply(x, axis)
