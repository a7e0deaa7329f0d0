"""GPipe-style pipeline parallelism over a "pipe" process group.

Counterpart of ``repro.launch.pipeline``.  Stages hold contiguous layer
blocks; microbatches stream from stage to stage.  Schedule: plain GPipe
fill-drain — T = n_micro + stages - 1 ticks; at tick t stage s processes
microbatch (t - s).  Bubble fraction = (S-1)/T.

The reference's ``lax.ppermute`` to the next stage is here a neighbour
send / receive that autograd differentiates: :class:`_Shift`'s backward
sends the gradient to the previous stage.  Every rank's backward meets the
shifts in reverse tick order (each tick's input depends on the shift of
the tick before), so the ranks' sends and receives pair up.  The masked
``psum`` that brings the last stage's outputs to every rank is a SUM
``all_reduce`` whose backward passes the gradient through, the output
being used whole on every rank.

Each rank runs one stage: ``stage_params`` is the stacked tree of every
stage (leading axis n_stages, ``stack_stages``), as the reference takes
it, and only this rank's stage slice takes part in its autograd graph.
"""

from __future__ import annotations

from typing import Callable

import torch

from .. import _collectives
from .._tree import tree_map

__all__ = ["pipeline_apply", "stack_stages", "make_pipe_mesh"]


def _exchange(t: torch.Tensor, group, me: int, n: int, ahead: bool) -> torch.Tensor:
    """Send ``t`` one stage on (``ahead``) or back, and receive the
    neighbour's from the other side; an end stage receives zeros."""
    import torch.distributed as dist

    dst, src = (me + 1, me - 1) if ahead else (me - 1, me + 1)
    t = t.contiguous()
    out = torch.zeros_like(t)
    reqs = []
    if 0 <= dst < n:
        reqs.append(dist.isend(t, dist.get_global_rank(group, dst), group=group))
    if 0 <= src < n:
        reqs.append(dist.irecv(out, dist.get_global_rank(group, src), group=group))
    for r in reqs:
        r.wait()
    if reqs:
        _collectives.note("collective-permute", t.numel() * t.element_size(), size=n)
    return out


class _Shift(torch.autograd.Function):
    """``lax.ppermute`` over the pairs (i, i+1), differentiable."""

    @staticmethod
    def forward(ctx, h, group, me, n):
        ctx.group, ctx.me, ctx.n = group, me, n
        return _exchange(h, group, me, n, ahead=True)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group, ctx.me, ctx.n, ahead=False), None, None, None


class _Broadcast(torch.autograd.Function):
    """The masked-sum broadcast of the last stage's output: forward a SUM
    ``all_reduce``; the output is used whole on every rank, so the
    gradient of each rank's masked input is the output's gradient."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        out = x.clone()
        dist.all_reduce(out, group=group)
        _collectives.note("all-reduce", out.numel() * out.element_size(), group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def pipeline_apply(
    stage_fn: Callable[[dict, torch.Tensor], torch.Tensor],
    stage_params: dict,
    x_micro: torch.Tensor,  # (n_micro, mb, ...) microbatched input
    mesh,
    axis: str = "pipe",
) -> torch.Tensor:
    """Run ``stage_fn`` as a pipeline over ``mesh``'s ``axis`` (a
    ``DeviceMesh``) or over a process group passed as ``mesh``.

    Returns the last stage's outputs as (n_micro, mb, ...) on every rank.
    """
    import torch.distributed as dist

    group = mesh.get_group(axis) if hasattr(mesh, "get_group") else mesh
    n_stages = dist.get_world_size(group)
    sid = dist.get_rank(group)
    n_micro = x_micro.shape[0]
    ticks = n_micro + n_stages - 1
    stage_params = tree_map(lambda p: p[sid], stage_params)  # this rank's stage (a view)
    zero = torch.zeros_like(x_micro[0])
    is_first = torch.tensor(sid == 0, device=x_micro.device)

    carry = zero
    outs = []
    for t in range(ticks):
        inject = x_micro[t] if t < n_micro else zero
        # both branches stay in the graph, so every rank's backward meets
        # every shift (the reference's jnp.where)
        h_in = torch.where(is_first, inject, carry)
        h_out = stage_fn(stage_params, h_in)
        if t >= n_stages - 1:
            outs.append(h_out)
        if t < ticks - 1:  # the last tick's shift feeds nothing
            carry = _Shift.apply(h_out, group, sid, n_stages)
    result = torch.stack(outs)
    mine = torch.where(torch.tensor(sid == n_stages - 1, device=result.device),
                       result, torch.zeros_like(result))
    if n_stages == 1:
        return mine
    return _Broadcast.apply(mine, group)


def stack_stages(layer_params: dict, n_stages: int) -> dict:
    """Reshape (L, ...) layer-stacked params into (n_stages, L/n_stages, ...)."""
    def r(x):
        l = x.shape[0]
        if l % n_stages:
            raise ValueError(f"{l} layers not divisible by {n_stages} stages")
        return x.reshape(n_stages, l // n_stages, *x.shape[1:])

    return tree_map(r, layer_params)


def make_pipe_mesh(n_stages: int, device: str = "cuda"):
    """A 1-D ("pipe",) ``DeviceMesh`` over the first ``n_stages`` ranks of
    the default process group (its world size must be ``n_stages``)."""
    from .mesh import _device_mesh

    return _device_mesh((n_stages,), ("pipe",), device)
