"""The "model" axis's operators: Megatron's conjugate pair and a gather.

The reference splits each product over the mesh's "model" axis by GSPMD,
which inserts the collectives.  Here the tensor-parallel forward
(``launch/tp_model.py``) calls them itself, through the operators below:

  * ``copy_to_model``: identity forward; its backward SUM-reduces the
    gradient over the group.  It enters a split region (a column-split
    product), so the replicated input's gradient comes back whole.
  * ``reduce_from_model``: SUM ``all_reduce`` forward; identity backward.
    It leaves a split region (a row-split product's partial sums).
  * ``gather_from_model``: all-gather along one dim; the backward takes
    this rank's slice of the (whole, replicated) gradient.
  * ``all_reduce``: a plain in-place reduction (SUM, MAX or MIN) with no
    gradient, for the statistics of the vocab-parallel loss and of a
    split-K decode.
  * ``batch_mean``: the mean over a data-parallel group of a statistic of
    each rank's rows (a MoE's load-balance means), made one of the whole
    batch; identity backward: each rank's loss holds the whole-batch term
    and the data-parallel mean of the gradients then averages it.

A group is an :class:`AxisGroup`: its size, this rank's index in it and
its process group.  On a one-rank group every operator returns its input
with no copy and no call, so a (1, 1) mesh runs the one-process op
sequence.  A group with no process group is a stand-in for a production
group that does not exist in this process (the meta dry run's 16 x 16
mesh): its collectives are recorded and not issued, on ``meta`` tensors
only.  Every collective is recorded through ``_collectives.note`` (kind,
result bytes, group size) for ``roofline.collect.record_collectives``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from .. import _collectives
from .mesh import mesh_axes

__all__ = ["AxisGroup", "axis_group", "all_reduce", "copy_to_model", "reduce_from_model",
           "gather_from_model", "batch_mean"]


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """One rank's group along some mesh axes: its ``size``, the rank's
    ``index`` in it, and its ``group`` (a process group; None for a
    stand-in, whose collectives are recorded and not issued)."""

    size: int
    index: int = 0
    group: Any = None


def axis_group(mesh, axes) -> AxisGroup:
    """The rank's group along ``axes`` (a name or a tuple of names, in mesh
    order) of ``mesh``: over several axes, one group spanning them all (a
    flattened ``DeviceMesh`` dim).  On a mesh with no devices (an
    ``AbstractMesh``) a stand-in of the same size, at index 0."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    sizes = mesh_axes(mesh)
    size = math.prod(sizes[a] for a in names)
    if getattr(mesh, "mesh_dim_names", None) is None or not names:
        return AxisGroup(size)
    if len(names) == 1:
        return AxisGroup(size, mesh.get_local_rank(names[0]), mesh.get_group(names[0]))
    sub = mesh[names]._flatten()
    return AxisGroup(size, sub.get_local_rank(), sub.get_group())


_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def _issued(g: AxisGroup, t: torch.Tensor) -> bool:
    """Whether a collective on ``t`` over ``g`` is issued: a stand-in group
    only records it, and only on ``meta`` tensors."""
    if g.group is not None:
        return True
    if t.device.type != "meta":
        raise ValueError(f"a stand-in group of {g.size} ranks records collectives on meta "
                         f"tensors only, not on {t.device}")
    return False


def all_reduce(t: torch.Tensor, g: AxisGroup, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over ``g`` in place (SUM, MAX or MIN), and returned; on
    a one-rank group ``t`` untouched."""
    if g.size == 1:
        return t
    _collectives.note("all-reduce", t.numel() * t.element_size(), size=g.size)
    if not _issued(g, t):
        return t
    import torch.distributed as dist

    dist.all_reduce(t, op=getattr(dist.ReduceOp, _OPS[op]), group=g.group)
    return t


def _all_gather(x: torch.Tensor, g: AxisGroup, dim: int) -> torch.Tensor:
    shape = list(x.shape)
    shape[dim] *= g.size
    _collectives.note("all-gather", math.prod(shape) * x.element_size(), size=g.size)
    if not _issued(g, x):
        return x.new_empty(shape)
    import torch.distributed as dist

    parts = [torch.empty_like(x, memory_format=torch.contiguous_format) for _ in range(g.size)]
    dist.all_gather(parts, x.contiguous(), group=g.group)
    return torch.cat(parts, dim=dim)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x

    @staticmethod
    def backward(ctx, dy):
        return all_reduce(dy.clone(), ctx.g), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return all_reduce(x.clone(), g)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _BatchMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return all_reduce(x.clone(), g).div_(g.size)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim, ctx.n = g, dim, x.shape[dim]
        return _all_gather(x, g, dim)

    @staticmethod
    def backward(ctx, dy):
        return dy.narrow(ctx.dim, ctx.g.index * ctx.n, ctx.n), None, None


def copy_to_model(x: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """Identity; the gradient is summed over ``g``."""
    return x if g.size == 1 else _CopyToModel.apply(x, g)


def reduce_from_model(x: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """``x`` summed over ``g``; the gradient passes unchanged."""
    return x if g.size == 1 else _ReduceFromModel.apply(x, g)


def batch_mean(x: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """``x`` averaged over ``g``; the gradient passes unchanged."""
    return x if g.size == 1 else _BatchMean.apply(x, g)


def gather_from_model(x: torch.Tensor, g: AxisGroup, dim: int = -1) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group order; the
    gradient is this rank's slice."""
    return x if g.size == 1 else _GatherFromModel.apply(x, g, dim % x.dim())
