"""Mixture-of-Experts layer: top-k routing with grouped, capacity-bounded
dispatch (GShard-style).

Counterpart of ``repro.models.moe``, same op sequence: the dispatch and
combine one-hots are built in the compute dtype, each (token, choice)'s
slot in its expert's capacity buffer comes from a cumulative sum, and the
(G, gs*k, E, C) choice-level one-hot is never materialised.  Padded
experts (``pad_experts_to``) are masked to -1e30 in the router.

The block is four steps, each a function of its own: :func:`route` (the
routing), :func:`dispatch_combine` (the one-hots of a range of experts),
:func:`expert_ffn` (the experts on their buffers) and :func:`load_balance`
(the auxiliary loss).  The expert-parallel block of
``repro_torch.launch.tp_model`` runs the same four on one rank's range of
experts.

Top-k takes a stable descending sort, so tied router probabilities pick
the lower expert index first, as ``jax.lax.top_k`` does (``torch.topk``
promises no order among ties).

The ``moe.dispatch`` traffic tap fires with the gathered expert input
buffers: ``repro_torch.obs.capture_moe_dispatch`` records them, while
``repro_torch.serve`` mutes taps inside the model (the reference's jitted
serving functions see tracers there and record nothing).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from .. import _obs_hooks
from .config import ModelConfig
from .layers import dense_init

Params = Dict[str, Any]


def init_moe(gen, cfg: ModelConfig, lead: tuple = (), device=None) -> Params:
    m = cfg.moe
    pdt = cfg.param_dtype
    d, ff = cfg.d_model, m.d_ff_expert
    e = m.padded_experts
    p: Params = {
        "router": dense_init(gen, (*lead, d, e), d, pdt, device),
        "gate": dense_init(gen, (*lead, e, d, ff), d, pdt, device),
        "up": dense_init(gen, (*lead, e, d, ff), d, pdt, device),
        "down": dense_init(gen, (*lead, e, ff, d), ff, pdt, device),
    }
    if m.num_shared_experts:
        fs = ff * m.num_shared_experts
        p["shared_gate"] = dense_init(gen, (*lead, d, fs), d, pdt, device)
        p["shared_up"] = dense_init(gen, (*lead, d, fs), d, pdt, device)
        p["shared_down"] = dense_init(gen, (*lead, fs, d), ff, pdt, device)
    return p


def capacity(cfg: ModelConfig, group_size: int) -> int:
    m = cfg.moe
    return max(1, math.ceil(group_size * m.top_k * m.capacity_factor / m.num_experts))


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, ties to the
    lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives an all-zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


@dataclasses.dataclass(frozen=True)
class Routing:
    """One MoE block's routing of ``xg`` (G, gs, d): the router's
    probabilities (G, gs, E) float32, each token's ``top_k`` experts
    ``top_e`` and normalised weights ``top_p`` (G, gs, k), each choice's
    slot ``pos`` in its expert's capacity buffer and whether it is kept
    (``pos < capacity``)."""

    xg: torch.Tensor
    probs: torch.Tensor
    top_p: torch.Tensor
    top_e: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    capacity: int


def route(router: torch.Tensor, x: torch.Tensor, cfg: ModelConfig,
          dropless: bool = False) -> Routing:
    """The routing of x (B, S, d) by the whole ``router`` (d, E): logits,
    the padded-expert mask, softmax, top-k and the capacity positions.
    ``dropless=True`` sets capacity = group size (no token can ever be
    dropped); used on the decode path."""
    m = cfg.moe
    dt = x.dtype
    bsz, s, d = x.shape
    t = bsz * s
    gs = min(m.group_size, t)
    if t % gs:
        gs = t  # smoke-test fallback: one group
    g = t // gs
    c = gs if dropless else min(capacity(cfg, gs), gs)
    e = m.padded_experts
    xg = x.reshape(g, gs, d)

    logits = (xg @ router.to(dt)).to(torch.float32)  # (G,gs,E)
    if e > m.num_experts:  # mask padded experts
        pad_mask = torch.arange(e, device=x.device) >= m.num_experts
        logits = torch.where(pad_mask[None, None, :], -1e30, logits)
    probs_all = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k(probs_all, m.top_k)  # (G,gs,k)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)

    # position of each (token, choice) within its expert's capacity buffer
    flat_e = top_e.reshape(g, gs * m.top_k)
    oh = one_hot(flat_e, e, torch.int32)  # (G, gs*k, E)
    pos_all = torch.cumsum(oh, dim=1, dtype=torch.int32) - 1  # (G, gs*k, E)
    pos = torch.take_along_dim(pos_all, flat_e[..., None], dim=-1)[..., 0]
    pos = pos.reshape(g, gs, m.top_k)
    return Routing(xg, probs_all, top_p, top_e, pos, pos < c, c)


def load_balance(r: Routing, cfg: ModelConfig, batch_mean=None) -> torch.Tensor:
    """The Switch-style load-balance loss over the real experts: each
    expert's mean router probability times the share of tokens whose first
    choice it is, both means over the routed groups.  ``batch_mean`` (a
    function of the stacked pair of means) takes them over a wider batch:
    the data-parallel ranks' (``launch/tp_model.py``)."""
    m = cfg.moe
    e = m.padded_experts
    me = r.probs[..., : m.num_experts].mean(dim=(0, 1))  # mean router prob
    ce = one_hot(r.top_e[..., 0], e, torch.float32)[..., : m.num_experts].mean(dim=(0, 1))
    if batch_mean is not None:
        me, ce = batch_mean(torch.stack([me, ce])).unbind()
    aux = torch.sum(me * ce) * (m.num_experts**1) * m.router_aux_weight
    return aux.to(torch.float32)


def dispatch_combine(r: Routing, lo: int, hi: int, dt) -> tuple[torch.Tensor, torch.Tensor]:
    """The dispatch and combine one-hots (G, gs, hi - lo, C) of the experts
    [lo, hi), in ``dt``; the combine weighted by ``r.top_p``.  Accumulated
    per choice: the (G, gs*k, E, C) choice-level one-hot is never
    materialised."""
    g, gs, k = r.top_e.shape
    n, c = hi - lo, r.capacity
    dispatch = torch.zeros((g, gs, n, c), dtype=dt, device=r.xg.device)
    combine = torch.zeros((g, gs, n, c), dtype=dt, device=r.xg.device)
    for j in range(k):
        ohe = one_hot(r.top_e[:, :, j] - lo, n, dt)  # an expert outside [lo, hi): zeros
        ohc = one_hot(r.pos[:, :, j], c, dt)
        sel = (ohe[..., :, None] * ohc[..., None, :]) * r.keep[:, :, j, None, None].to(dt)
        dispatch = dispatch + sel
        combine = combine + sel * r.top_p[:, :, j, None, None].to(dt)
    return dispatch, combine


def expert_ffn(params: Params, expert_in: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU on their buffers (G, E, C, d) -> (G, E, C, d);
    ``params``' gate / up / down hold those experts."""
    dt = expert_in.dtype
    h = F.silu(torch.einsum("gecd,edf->gecf", expert_in, params["gate"].to(dt)))
    h = h * torch.einsum("gecd,edf->gecf", expert_in, params["up"].to(dt))
    return torch.einsum("gecf,efd->gecd", h, params["down"].to(dt))


def moe_block(
    params: Params, x: torch.Tensor, cfg: ModelConfig, dropless: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE.  x: (B, S, d) -> (y, aux_loss).

    ``dropless=True`` sets capacity = group size (no token can ever be
    dropped); used on the decode path.
    """
    r = route(params["router"], x, cfg, dropless)
    dispatch, combine = dispatch_combine(r, 0, cfg.moe.padded_experts, x.dtype)
    expert_in = torch.einsum("gsec,gsd->gecd", dispatch, r.xg)
    # traffic tap: expert_in is exactly the dispatch payload
    _obs_hooks.tap("moe.dispatch", expert_in=expert_in)
    y = torch.einsum("gsec,gecd->gsd", combine, expert_ffn(params, expert_in))

    if cfg.moe.num_shared_experts:
        dt, xg = x.dtype, r.xg
        sh = F.silu(xg @ params["shared_gate"].to(dt)) * (xg @ params["shared_up"].to(dt))
        y = y + sh @ params["shared_down"].to(dt)
    return y.reshape(x.shape), load_balance(r, cfg)
