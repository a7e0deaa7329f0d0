"""AdamW with global-norm clipping and a warmup-cosine schedule.

Counterpart of ``repro.optim.adamw``.  The optimizer state is a tree
mirroring the params (m, v, float32) plus an int32 step counter, in the
reference's ``OptState`` NamedTuple, so a checkpoint of
``{"params": ..., "opt": ...}`` carries across the packages
(``repro_torch.checkpoint``).  The update keeps the reference's float32 op
order: clip scale, bias corrections ``1 - b**step``, then
``mhat / (sqrt(vhat) + eps) + wd * p``.

It walks the tree leaf by leaf, so at full width the temporaries are a few
of the largest leaf's size.  ``donate=True`` writes the new params and
moments into the tensors passed in (the reference's training loop donates
them to its jitted step); by default the inputs are left as they were.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from .._tree import leaves, tree_map, unflatten_like

Params = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    m: Params
    v: Params


def lr_schedule(cfg: AdamWConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    def lr(step) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = step / max(cfg.warmup_steps, 1)
        decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
        frac = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * frac))
        mult = torch.where(step < cfg.warmup_steps, warm,
                           cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)
        return cfg.peak_lr * mult

    return lr


def init(params: Params) -> OptState:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    dev = leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev), m=zeros,
                    v=tree_map(torch.clone, zeros))


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves(tree)))


def step_scalars(cfg: AdamWConfig, grads: Params, state: OptState,
                 gnorm: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """The scalars one step shares across leaves: the global norm (of
    ``grads`` unless given: a tensor-parallel step's blocks do not hold the
    whole gradient), the clip scale, the new step, its learning rate and the
    bias corrections."""
    if gnorm is None:
        gnorm = global_norm(grads)
    step = state.step + 1
    return {
        "grad_norm": gnorm,
        "scale": torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0),
        "step": step,
        "lr": lr_schedule(cfg)(step),
        "bc1": 1 - torch.pow(cfg.b1, step.to(torch.float32)),
        "bc2": 1 - torch.pow(cfg.b2, step.to(torch.float32)),
    }


@torch.no_grad()
def update_leaf(cfg: AdamWConfig, s: dict, p, g, m, v, donate: bool = False):
    """One leaf's AdamW update under the step's scalars ``s``: (p, m, v),
    written into the tensors passed in with ``donate``.  Every product and
    sum is rounded as the reference's out-of-place expression is."""
    if not donate:
        p, m, v = p.clone(), m.clone(), v.clone()
    g = g.to(torch.float32) * s["scale"]
    m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
    v.mul_(cfg.b2).add_(torch.square(g).mul_(1 - cfg.b2))
    del g
    den = (v / s["bc2"]).sqrt_().add_(cfg.eps)
    delta = (m / s["bc1"]).div_(den)
    del den
    delta.add_(p.to(torch.float32) * cfg.weight_decay)
    if p.dtype == torch.float32:
        p.sub_(delta.mul_(s["lr"]))
    else:
        p.copy_((p.to(torch.float32) - s["lr"] * delta).to(p.dtype))
    return p, m, v


@torch.no_grad()
def update(
    cfg: AdamWConfig, grads: Params, state: OptState, params: Params, donate: bool = False
) -> tuple[Params, OptState, dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (new_params, new_state, metrics); with
    ``donate`` the new params and moments are the tensors passed in,
    updated in place."""
    s = step_scalars(cfg, grads, state)
    out = [update_leaf(cfg, s, p, g, m, v, donate) for p, g, m, v in zip(
        leaves(params), leaves(grads), leaves(state.m), leaves(state.v))]
    new_p, new_m, new_v = (unflatten_like(params, [o[i] for o in out]) for i in range(3))
    metrics = {"grad_norm": s["grad_norm"], "lr": s["lr"]}
    return new_p, OptState(step=s["step"], m=new_m, v=new_v), metrics
