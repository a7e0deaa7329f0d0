"""The rule-placed data-parallel train step.

``repro.train``'s step runs under GSPMD: ``jax.jit`` with the shardings of
``launch.sharding`` places every leaf and inserts the collectives.  Here
the placement is explicit.  :func:`place_state` keeps each parameter and
optimizer leaf as a ``torch.distributed.tensor.DTensor`` placed by
``params_shardings`` / ``opt_shardings`` on a ``DeviceMesh``: the "model"
axis splits storage as the rules say, FSDP configs add their "data" axis,
and ZeRO-1 (``cfg.zero1``) splits the m/v leaves over "data".  The step
(:func:`make_placed_train_step`):

  1. takes this rank's rows of the global batch by ``batch_shardings``;
  2. gathers each leaf at use (a leaf whose split axes all have size 1 is
     its own local tensor, with no copy);
  3. runs the loss and its backward on the local rows (``train.step``'s
     ``accumulate``);
  4. averages the gradients over the data-parallel ranks: a float32 SUM
     ``all_reduce`` per leaf, as the reference's GSPMD step reduces, or
     ``optim.compressed_psum`` of the flat gradient when a
     ``CompressionConfig`` is given (its error buffer is the step's
     ``error`` attribute);
  5. updates each rank's m/v shard with ``optim``'s AdamW, leaf by leaf,
     and all-gathers a ZeRO-1 parameter's updated pieces over "data".

The state is updated in place, as the reference's loop donates it.  The
"model" axis places storage only: every rank of a "model" group computes
the whole product; a tensor-parallel forward is not built.  Sequence
(SP) placement of the batch has no meaning for a data-parallel step and
raises.  Each collective is recorded for ``roofline.collect``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from .. import _collectives, _obs_hooks
from .._tree import leaves, tree_map, unflatten_like
from ..models.config import ModelConfig
from ..optim import AdamWConfig, CompressionConfig, OptState, compressed_psum
from ..optim.adamw import step_scalars, update_leaf
from ..train.step import accumulate, make_loss_fn
from .mesh import mesh_axes
from .sharding import batch_shardings, opt_shardings, params_shardings, to_placements

__all__ = ["place", "place_state", "gather", "make_placed_train_step"]


def _region(shape, placements, mesh) -> tuple[slice, ...]:
    """This rank's block of a tensor of ``shape`` under ``placements``:
    a tensor dim split over several mesh dims takes them in mesh order,
    the first the slowest."""
    sizes = list(mesh_axes(mesh).values())
    coord = mesh.get_coordinate()
    out = []
    for d, n in enumerate(shape):
        idx, parts = 0, 1
        for i, pl in enumerate(placements):
            if pl.is_shard(d):
                idx, parts = idx * sizes[i] + coord[i], parts * sizes[i]
        if n % parts:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split into {parts}")
        step = n // parts
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def _whole(region, shape) -> bool:
    return all(r.start == 0 and r.stop == n for r, n in zip(region, shape))


def place(t: torch.Tensor, sharding):
    """``t`` (whole, on every rank) as a DTensor placed by ``sharding``; a
    block smaller than ``t`` is copied out so ``t`` can be freed, a whole
    one is ``t`` itself."""
    from torch.distributed.tensor import DTensor

    mesh, placements = sharding.mesh, sharding.placements()
    region = _region(t.shape, placements, mesh)
    local = t if _whole(region, t.shape) else t[region].clone()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=torch.empty(t.shape, device="meta").stride())


def place_state(cfg: ModelConfig, mesh, params: Any, opt_state: OptState) -> tuple[Any, OptState]:
    """Params and optimizer state (whole tensors, the same on every rank)
    as DTensor trees placed by the rules."""
    p_sh = params_shardings(cfg, mesh, params, mode="train")
    o_sh = opt_shardings(cfg, mesh, opt_state, params)
    placed = tree_map(place, params, p_sh)
    return placed, OptState(step=place(opt_state.step, o_sh.step),
                            m=tree_map(place, opt_state.m, o_sh.m),
                            v=tree_map(place, opt_state.v, o_sh.v))


def _split_mesh_dims(dt) -> list[int]:
    sizes = list(mesh_axes(dt.device_mesh).values())
    return [i for i, pl in enumerate(dt.placements) if pl.is_shard() and sizes[i] > 1]


def gather(dt) -> torch.Tensor:
    """The whole tensor of a DTensor: its local tensor when no split axis
    has more than one rank, else an all-gather (recorded)."""
    split = _split_mesh_dims(dt)
    if not split:
        return dt.to_local()
    full = dt.full_tensor()
    _collectives.note("all-gather", full.numel() * full.element_size(),
                      size=_ranks(dt.device_mesh, split))
    return full


def _ranks(mesh, dims: list[int]) -> int:
    out = 1
    for i in dims:
        out *= mesh.size(i)
    return out


def _sum_over(t: torch.Tensor, mesh, axes: tuple[str, ...]) -> torch.Tensor:
    """``t`` summed in place over each named mesh axis, one SUM
    ``all_reduce`` per axis (over a one-rank axis, the identity)."""
    import torch.distributed as dist

    for a in axes:
        group = mesh.get_group(a)
        dist.all_reduce(t, group=group)
        _collectives.note("all-reduce", t.numel() * t.element_size(), group)
    return t


def make_placed_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    mesh,
    compression: Optional[CompressionConfig] = None,
) -> Callable:
    """The train step over ``mesh``: ``(params, opt_state, batch) ->
    (params, opt_state, metrics)`` with the state from :func:`place_state`
    (updated in place) and the whole global ``batch`` on every rank."""
    loss_fn = make_loss_fn(cfg)
    axes = mesh_axes(mesh)

    def train_step(params, opt_state: OptState, batch: dict):
        b_sh = batch_shardings(cfg, mesh, batch)
        local = {}
        for k, v in batch.items():
            spec = b_sh[k].spec
            if any(e is not None for e in spec[1:]):
                raise ValueError(f"batch {k!r} {tuple(v.shape)}: the rules split dims {spec}, "
                                 f"not the batch's rows; the placed step is data-parallel only")
            local[k] = v[_region(v.shape, to_placements(spec, mesh), mesh)]
        dp = b_sh["labels" if "labels" in b_sh else next(iter(b_sh))].spec[0] or ()
        dp = dp if isinstance(dp, tuple) else (dp,)
        n = 1
        for a in dp:
            n *= axes[a]

        with torch.no_grad():
            whole = tree_map(gather, params)
        loss, grads = accumulate(loss_fn, whole, local)
        del whole
        _obs_hooks.tap("train.grads", grads=grads)
        with torch.no_grad():
            if compression is None:
                for g in leaves(grads):
                    _sum_over(g, mesh, dp)
                    if n > 1:
                        g.div_(n)
            else:
                grads = _compressed_mean(grads, dp, n)
            loss = _sum_over(loss.detach().clone(), mesh, dp) / n
            s = step_scalars(opt_cfg, grads, opt_state._replace(step=opt_state.step.to_local()))
            for p, g, m, v in zip(leaves(params), leaves(grads), leaves(opt_state.m),
                                  leaves(opt_state.v)):
                _update(opt_cfg, s, p, g, m, v)
            del grads
        step = _place_like(s["step"], opt_state.step)
        return params, OptState(step=step, m=opt_state.m, v=opt_state.v), {
            "loss": loss, "grad_norm": s["grad_norm"], "lr": s["lr"]}

    def _compressed_mean(grads, dp: tuple[str, ...], n: int):
        split = [a for a in dp if axes[a] > 1]
        if len(split) > 1:
            raise ValueError(f"compressed_psum takes one group; data-parallel axes {split}")
        group = mesh.get_group((split or list(dp))[0]) if dp else None
        flat = torch.cat([g.reshape(-1) for g in leaves(grads)])
        if train_step.error is None:
            train_step.error = torch.zeros_like(flat)
        out, train_step.error = compressed_psum(flat, train_step.error, compression, group)
        del flat
        if n > 1:
            out.div_(n)
        at, parts = 0, []
        for g in leaves(grads):
            parts.append(out[at: at + g.numel()].view(g.shape))
            at += g.numel()
        return unflatten_like(grads, parts)

    train_step.error = None
    return train_step


def _place_like(t: torch.Tensor, like):
    """``t`` (whole, on every rank) placed as the DTensor ``like`` is."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, like.device_mesh, like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())


def _update(opt_cfg: AdamWConfig, s: dict, p, g: torch.Tensor, m, v) -> None:
    """One leaf's AdamW on this rank's m/v block, in place; a parameter
    split more coarsely than its moments (ZeRO-1) gathers the updated
    blocks over the extra axes."""
    from torch.distributed.tensor import DTensor

    shape = tuple(g.shape)
    mv_region = _region(shape, m.placements, m.device_mesh)
    p_region = _region(shape, p.placements, p.device_mesh)
    rel = tuple(slice(a.start - b.start, a.stop - b.start) for a, b in zip(mv_region, p_region))
    p_loc = p.to_local()
    piece = p_loc[rel]
    update_leaf(opt_cfg, s, piece, g[mv_region], m.to_local(), v.to_local(), donate=True)
    extra = _extra_split(m, p)
    if extra:
        blocks = DTensor.from_local(piece.contiguous(), m.device_mesh, m.placements,
                                    run_check=False, shape=p.shape, stride=p.stride())
        whole = blocks.redistribute(p.device_mesh, p.placements).to_local()
        p_loc.copy_(whole)
        _collectives.note("all-gather", whole.numel() * whole.element_size(),
                          size=_ranks(m.device_mesh, extra))


def _extra_split(m, p) -> list[int]:
    """The mesh dims with more than one rank that split m/v and not the
    parameter."""
    sizes = list(mesh_axes(m.device_mesh).values())
    return [i for i, (a, b) in enumerate(zip(m.placements, p.placements))
            if a.is_shard() and not b.is_shard() and sizes[i] > 1]
