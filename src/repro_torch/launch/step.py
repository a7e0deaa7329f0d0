"""The rule-placed train step, tensor-parallel over "model".

``repro.train``'s step runs under GSPMD: ``jax.jit`` with the shardings of
``launch.sharding`` places every leaf, splits the products over "model"
and inserts the collectives.  Here the placement is explicit.
:func:`place_state` keeps each parameter and optimizer leaf as a
``torch.distributed.tensor.DTensor`` placed by ``params_shardings`` /
``opt_shardings`` on a ``DeviceMesh``: "model" splits as the rules say,
FSDP configs add their "data" axis, and ZeRO-1 (``cfg.zero1``) splits the
m/v leaves over "data".  It builds the state leaf by leaf from whole
tensors or the JAX package's numpy arrays, and makes m / v at block
shape, so no rank holds the whole state.  The step
(:func:`make_placed_train_step`):

  1. takes this rank's rows of the global batch by ``batch_shardings``
     (an encoder-decoder's ``frames`` and a vlm's ``patches`` too, by their
     rows);
  2. takes each leaf's block for the compute: a dense, vlm, MoE, ssm, hybrid
     or encoder-decoder config keeps its "model" split (``tp_model.py`` runs
     each product on the block: attention on its heads or on its
     contraction, the encoder's and the decoder's self- and
     cross-attention on their heads, a MoE's experts on the rank's range
     of experts, the SSD projections on their contraction and the SSM core
     on the rank's heads); an FSDP config (internvl2-26b's and
     qwen3-moe-30b-a3b's, with more than one "data" rank) keeps its "data"
     blocks too, which the forward all-gathers a layer at a time at use,
     the embedding and the head once, and whose gradients its backward
     reduce-scatters (``tp_model.Plan.fsdp``, ``tp.gather_from_data``);
     where ``tp_model.unsupported`` names a reason (experts split on their
     ``d_ff``, shared experts, an encoder-decoder's attention on its
     contraction, FSDP outside the dense, vlm and MoE families) it gathers
     every axis before the forward, so every rank of a "model" group
     computes the whole product;
  3. runs the loss (with a MoE's load-balance loss, as ``train.step``'s,
     its means taken over the data-parallel ranks as over the reference's
     global batch) and its backward on the local rows (``train.step``'s
     ``accumulate``, in ``microbatches`` strided splits), the
     tensor-parallel forward's collectives inside;
  4. sums over "model" the gradient of each replicated leaf whose use is
     split across the group (``tp_model.Plan.partial``); every other
     gradient is already this rank's block, or whole;
  5. averages the gradients over the data-parallel ranks through one group
     spanning the data-parallel axes ("data", or "pod" and "data" as one
     flattened mesh dim): a float32 SUM ``all_reduce`` per leaf, as the
     reference's GSPMD step reduces, or ``optim.compressed_psum`` of the
     flat gradient when a ``CompressionConfig`` is given (its error buffer
     is the step's ``error`` attribute; not with FSDP).  An FSDP leaf's
     gradient left the backward as its block already summed over "data":
     it is summed over "pod" only (where there is one) and divided;
  6. takes the global norm (a block's squares summed over each axis that
     splits it: "model", and "data" under FSDP), updates each rank's m/v
     block with ``optim``'s AdamW, leaf by leaf, and all-gathers a ZeRO-1
     parameter's updated pieces over "data".

The state is updated in place, as the reference's loop donates it.  A
collective over a one-rank group is skipped, so on a (1, 1) mesh the step
runs ``train.step``'s op sequence.  Sequence (SP) placement of the batch
has no meaning for a data-parallel step and raises.  Each collective is
recorded for ``roofline.collect``; :func:`reduce_gradients` (steps 3-6's
collectives) also runs on ``meta`` tensors over stand-in groups, which is
how the meta dry run records a step's collectives.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from .. import _collectives, _obs_hooks
from .._tree import leaves, leaves_with_path, tree_map, unflatten_like
from ..convert import _tensor_from_numpy
from ..models.config import ModelConfig
from ..optim import AdamWConfig, CompressionConfig, OptState, compressed_psum
from ..optim.adamw import global_norm, step_scalars, update_leaf
from ..train.step import accumulate, make_loss_fn
from . import tp_model
from .mesh import mesh_axes
from .sharding import batch_shardings, opt_shardings, params_shardings, to_placements
from .tp import AxisGroup, all_reduce, axis_group

__all__ = ["block", "place", "place_state", "gather", "make_placed_train_step",
           "reduce_gradients", "mean_gradients", "zero1_gather"]


def _region(shape, placements, mesh) -> tuple[slice, ...]:
    """This rank's block of a tensor of ``shape`` under ``placements``:
    a tensor dim split over several mesh dims takes them in mesh order,
    the first the slowest.  On a mesh with no devices (an
    ``AbstractMesh``), the block of the rank at coordinate 0."""
    sizes = list(mesh_axes(mesh).values())
    coord = mesh.get_coordinate() if hasattr(mesh, "get_coordinate") else [0] * len(sizes)
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


def block(t: torch.Tensor, sharding) -> torch.Tensor:
    """This rank's block of ``t`` (whole, on every rank) under ``sharding``:
    ``t`` itself when the block is whole, else a copy, so ``t`` can be
    freed (on ``meta``, a shape)."""
    region = _region(t.shape, sharding.placements(), sharding.mesh)
    return t if _whole(region, t.shape) else t[region].clone()


def place(t: torch.Tensor, sharding):
    """``t`` (whole, on every rank) as a DTensor placed by ``sharding``."""
    return _from_local(block(t, sharding), sharding, t.shape)


def _from_local(local: torch.Tensor, sharding, shape) -> Any:
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, sharding.mesh, sharding.placements(), run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(tuple(shape), device="meta").stride())


def _leaf_block(x, sharding) -> torch.Tensor:
    """This rank's block of the whole leaf ``x``: a tensor's on its device
    (``x`` itself when the block is whole, as :func:`block`), a numpy
    array's on the CPU (always a copy, so the caller's array is never
    updated)."""
    array = not isinstance(x, torch.Tensor)
    t = _tensor_from_numpy(np.asarray(x), torch.device("cpu")) if array else x
    region = _region(t.shape, sharding.placements(), sharding.mesh)
    if not array and _whole(region, t.shape):
        return t
    return t[region].clone()


def place_state(cfg: ModelConfig, mesh, params: Any) -> tuple[Any, OptState]:
    """Params as a DTensor tree placed by the rules and a fresh optimizer
    state (``optim.init``'s zeros) placed by them too, built leaf by leaf:
    ``params`` are whole leaves, the same on every rank, tensors or numpy
    arrays (the JAX package's, as ``convert.params_from_numpy`` takes
    them), each cut to this rank's block (:func:`_leaf_block`); the m / v
    zeros are made at block shape, so no rank holds a whole moment."""
    p_sh = params_shardings(cfg, mesh, params, mode="train")
    o_sh = opt_shardings(cfg, mesh, OptState(step=None, m=None, v=None), params)
    placed = tree_map(lambda x, sh: _from_local(_leaf_block(x, sh), sh, x.shape), params, p_sh)

    def zeros(p, sh):
        region = _region(p.shape, sh.placements(), sh.mesh)
        return _from_local(torch.zeros(tuple(r.stop - r.start for r in region),
                                       dtype=torch.float32, device=p.to_local().device),
                           sh, p.shape)

    step = torch.zeros((), dtype=torch.int32, device=leaves(placed)[0].to_local().device)
    return placed, OptState(step=_from_local(step, o_sh.step, ()),
                            m=tree_map(zeros, placed, o_sh.m), v=tree_map(zeros, placed, o_sh.v))


def _split_mesh_dims(dt) -> list[int]:
    sizes = list(mesh_axes(dt.device_mesh).values())
    return [i for i, pl in enumerate(dt.placements) if pl.is_shard() and sizes[i] > 1]


def gather(dt, keep: tuple[int, ...] = ()) -> torch.Tensor:
    """A placed leaf's tensor, whole but along the mesh dims ``keep`` (this
    rank's block there: "model" under a tensor-parallel plan, and "data"
    too under FSDP): its local tensor when no other split mesh dim has more
    than one rank, else an all-gather over them (recorded)."""
    from torch.distributed.tensor import Replicate

    split = [i for i in _split_mesh_dims(dt) if i not in keep]
    if not split:
        return dt.to_local()
    target = tuple(Replicate() if i in split else pl for i, pl in enumerate(dt.placements))
    out = dt.redistribute(dt.device_mesh, target).to_local()
    _collectives.note("all-gather", out.numel() * out.element_size(),
                      size=_ranks(dt.device_mesh, split))
    return out


def _ranks(mesh, dims: list[int]) -> int:
    out = 1
    for i in dims:
        out *= mesh.size(i)
    return out


def reduce_gradients(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    plan: Optional[tp_model.Plan],
    dp: AxisGroup,
    params: Any,
    batch: dict,
    step: torch.Tensor,
    compression: Optional[CompressionConfig] = None,
    error: Optional[torch.Tensor] = None,
    microbatches: int = 1,
) -> tuple:
    """Steps 3-6 of the placed step up to the update, on one rank's compute
    tensors: the loss and its backward (tensor-parallel under ``plan``,
    over ``microbatches`` strided splits of the rank's rows), the partial
    gradients summed over "model", the mean over ``dp`` (or
    ``compressed_psum`` with ``error``, its buffer) and the step's scalars.
    An FSDP leaf's gradient is already its block summed over "data" (the
    reduce-scatter of its gather's backward): it is summed over the other
    data-parallel axes only, then divided as the others.  Returns (loss,
    gradients, scalars, error)."""
    loss_fn = make_loss_fn(cfg) if plan is None else tp_model.make_loss_fn(plan)
    fsdp = plan.fsdp if plan is not None else {}
    if fsdp and compression is not None:
        raise ValueError(f"{cfg.name}: compressed_psum of FSDP's gradient blocks is not "
                         f"supported; their sum over 'data' is the gather's reduce-scatter")
    loss, grads = accumulate(loss_fn, params, batch, microbatches)
    _obs_hooks.tap("train.grads", grads=grads)
    return mean_gradients(opt_cfg, plan, dp, loss, grads, step, compression, error)


def mean_gradients(
    opt_cfg: AdamWConfig,
    plan: Optional[tp_model.Plan],
    dp: AxisGroup,
    loss: torch.Tensor,
    grads: Any,
    step: torch.Tensor,
    compression: Optional[CompressionConfig] = None,
    error: Optional[torch.Tensor] = None,
) -> tuple:
    """The collectives of :func:`reduce_gradients` after the backward, on the
    rank's gradient blocks ``grads`` (updated in place) and ``loss``:
    (loss, gradients, scalars, error)."""
    fsdp = plan.fsdp if plan is not None else {}
    with torch.no_grad():
        if plan is not None:
            for path, g in leaves_with_path(grads):
                if path in plan.partial:
                    all_reduce(g, plan.model)
        if compression is None:
            for path, g in leaves_with_path(grads):
                all_reduce(g, plan.fsdp_rest if path in fsdp else dp)
                if dp.size > 1:
                    g.div_(dp.size)
        else:
            grads, error = _compressed_mean(grads, dp, compression, error)
        loss = all_reduce(loss.detach().clone(), dp) / dp.size
        s = step_scalars(opt_cfg, grads, OptState(step=step, m=None, v=None),
                         gnorm=_global_norm(grads, plan))
    return loss, grads, s, error


def _global_norm(grads, plan: Optional[tp_model.Plan]) -> torch.Tensor:
    """The norm of the whole gradient: a block's squares are summed over
    each axis that splits it ("model", and "data" under FSDP), a replicated
    leaf's counted once."""
    if plan is None or (plan.model.size == 1 and not plan.fsdp):
        return global_norm(grads)
    if not plan.fsdp:
        sq = {False: [], True: []}
        for path, g in leaves_with_path(grads):
            sq[path in plan.split].append(torch.sum(torch.square(g.to(torch.float32))))
        split = all_reduce(torch.stack(sq[True]).sum(), plan.model)
        return torch.sqrt(split + torch.stack(sq[False]).sum())
    # keyed by (split over "model", split over "data"); two summed pairs
    sq = {(a, b): [] for a in (False, True) for b in (False, True)}
    for path, g in leaves_with_path(grads):
        sq[path in plan.split, path in plan.fsdp].append(
            torch.sum(torch.square(g.to(torch.float32))))
    zero = torch.zeros((), dtype=torch.float32, device=leaves(grads)[0].device)
    s = {k: torch.stack(v).sum() if v else zero for k, v in sq.items()}
    over_model = all_reduce(torch.stack([s[True, True], s[True, False]]), plan.model)
    over_data = all_reduce(torch.stack([over_model[0], s[False, True]]), plan.fsdp_group)
    return torch.sqrt(over_data.sum() + over_model[1] + s[False, False])


def _compressed_mean(grads, dp: AxisGroup, compression: CompressionConfig, error):
    """The gradients' mean over ``dp`` through ``compressed_psum`` of their
    flat concatenation; returns (gradients, new error buffer)."""
    flat = torch.cat([g.reshape(-1) for g in leaves(grads)])
    if error is None:
        error = torch.zeros_like(flat)
    out, error = compressed_psum(flat, error, compression, dp.group)
    del flat
    if dp.size > 1:
        out.div_(dp.size)
    at, parts = 0, []
    for g in leaves(grads):
        parts.append(out[at: at + g.numel()].view(g.shape))
        at += g.numel()
    return unflatten_like(grads, parts), error


def make_placed_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    mesh,
    compression: Optional[CompressionConfig] = None,
    microbatches: int = 1,
) -> Callable:
    """The train step over ``mesh``: ``(params, opt_state, batch) ->
    (params, opt_state, metrics)`` with the state from :func:`place_state`
    (updated in place) and the whole global ``batch`` on every rank, each
    rank's rows taken in ``microbatches`` strided splits (``train.step``'s
    ``accumulate``).  A dense, vlm, MoE, ssm, hybrid or encoder-decoder
    config runs tensor-parallel over "model"; an FSDP config of the dense,
    vlm or MoE family keeps its "data" blocks too, gathered a layer at a
    time in the forward."""
    # the forward on "model" blocks (and FSDP's "data" blocks) where it runs
    # the rules' splits; else every leaf gathered at use
    plan = tp_model.make_plan(cfg, mesh) if tp_model.unsupported(cfg, mesh) is None else None
    names = list(mesh_axes(mesh))
    keep = () if plan is None else tuple(
        names.index(a) for a in (("data", "model") if plan.fsdp else ("model",)))
    groups: dict[tuple, AxisGroup] = {}

    def train_step(params, opt_state: OptState, batch: dict):
        b_sh = batch_shardings(cfg, mesh, batch)
        local = {}
        for k, v in batch.items():
            spec = b_sh[k].spec
            if any(e is not None for e in spec[1:]):
                raise ValueError(f"batch {k!r} {tuple(v.shape)}: the rules split dims {spec}, "
                                 f"not the batch's rows; the placed step is data-parallel only")
            local[k] = v[_region(v.shape, to_placements(spec, mesh), mesh)]
        names = b_sh["labels" if "labels" in b_sh else next(iter(b_sh))].spec[0] or ()
        names = names if isinstance(names, tuple) else (names,)
        if names not in groups:
            groups[names] = axis_group(mesh, names)

        with torch.no_grad():
            blocks = tree_map(lambda t: gather(t, keep), params)
        loss, grads, s, train_step.error = reduce_gradients(
            cfg, opt_cfg, plan, groups[names], blocks, local, opt_state.step.to_local(),
            compression, train_step.error, microbatches)
        del blocks
        with torch.no_grad():
            for p, g, m, v in zip(leaves(params), leaves(grads), leaves(opt_state.m),
                                  leaves(opt_state.v)):
                _update(opt_cfg, s, p, g, m, v, keep)
            del grads
        step = _place_like(s["step"], opt_state.step)
        return params, OptState(step=step, m=opt_state.m, v=opt_state.v), {
            "loss": loss, "grad_norm": s["grad_norm"], "lr": s["lr"]}

    train_step.error = None
    return train_step


def _place_like(t: torch.Tensor, like):
    """``t`` (whole, on every rank) placed as the DTensor ``like`` is."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, like.device_mesh, like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())


def _rel(inner, outer) -> tuple[slice, ...]:
    """Block ``inner`` in the coordinates of the block ``outer`` holding it."""
    return tuple(slice(a.start - b.start, a.stop - b.start) for a, b in zip(inner, outer))


def _update(opt_cfg: AdamWConfig, s: dict, p, g: torch.Tensor, m, v,
            keep: tuple[int, ...]) -> None:
    """One leaf's AdamW on this rank's m/v block, in place; ``g`` is the
    gradient of the leaf's block along the mesh dims ``keep`` (whole along
    the others).  A parameter split more coarsely than its moments (ZeRO-1)
    gathers the updated blocks over the extra axes."""
    from torch.distributed.tensor import DTensor, Replicate

    shape, mesh = tuple(p.shape), p.device_mesh
    g_region = _region(shape, tuple(pl if i in keep else Replicate()
                                    for i, pl in enumerate(p.placements)), mesh)
    mv_region = _region(shape, m.placements, m.device_mesh)
    p_loc = p.to_local()
    piece = p_loc[_rel(mv_region, _region(shape, p.placements, mesh))]
    update_leaf(opt_cfg, s, piece, g[_rel(mv_region, g_region)], m.to_local(), v.to_local(),
                donate=True)
    gathered = zero1_gather(p_loc, p.placements, m.placements, mesh)
    if gathered:
        blocks = DTensor.from_local(piece.contiguous(), m.device_mesh, m.placements,
                                    run_check=False, shape=p.shape, stride=p.stride())
        p_loc.copy_(blocks.redistribute(p.device_mesh, p.placements).to_local())
        _collectives.note("all-gather", gathered[0], size=gathered[1])


def zero1_gather(p_block: torch.Tensor, p_placements, m_placements,
                 mesh) -> Optional[tuple[int, int]]:
    """ZeRO-1's gather after the update: a parameter whose m/v are split
    over mesh dims (with more than one rank) that do not split it rebuilds
    its block ``p_block`` from the updated pieces by an all-gather over
    them.  Returns (its bytes, its group's size), or None when there is
    none.  The placed step and the dry run both ask here."""
    sizes = list(mesh_axes(mesh).values())
    extra = [i for i, (a, b) in enumerate(zip(m_placements, p_placements))
             if a.is_shard() and not b.is_shard() and sizes[i] > 1]
    if not extra:
        return None
    return p_block.numel() * p_block.element_size(), math.prod(sizes[i] for i in extra)
