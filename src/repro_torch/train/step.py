"""Train-step construction: loss, gradients, optimizer update, microbatching.

Counterpart of ``repro.train.step``.  ``make_train_step`` returns a function
``(params, opt_state, batch) -> (params, opt_state, metrics)`` that runs
eagerly on the tensors' device: the loss's backward is autograd's, over a
detached, gradient-tracking view of every parameter leaf (no copy).

Gradient accumulation (``microbatches > 1``) loops over a STRIDED split of
the batch (row i goes to microbatch i mod mb), the reference's split,
summing float32 gradients and losses and dividing by mb at the end.

The reference's ``train.grads`` tap fires with concrete gradients while
every tap inside its loss (``moe.dispatch``) sees JVP tracers and records
nothing.  Here the loss and its backward run inside ``_obs_hooks.muted()``
and ``train.grads`` fires outside it, so a captured train step records the
reference's streams: ``train_allreduce/grads`` only.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from .. import _obs_hooks
from .._tree import leaves, tree_map
from ..models import encdec_forward, forward, lm_loss
from ..models.config import ModelConfig
from ..models.transformer import STACKED
from ..optim import AdamWConfig, OptState, update

Params = Any
Batch = Dict[str, torch.Tensor]


def make_loss_fn(cfg: ModelConfig) -> Callable[[Params, Batch], torch.Tensor]:
    fam = cfg.family

    def loss_fn(params: Params, batch: Batch) -> torch.Tensor:
        if fam in ("encdec", "audio"):
            h, aux = encdec_forward(params, cfg, batch["frames"], batch["tokens"])
        elif fam == "vlm":
            h, aux = forward(params, cfg, tokens=batch["tokens"], inputs_embeds=batch["patches"])
        else:
            h, aux = forward(params, cfg, tokens=batch["tokens"])
        return lm_loss(params, cfg, h, batch["labels"]) + aux

    return loss_fn


def value_and_grad(loss_fn: Callable, params: Params, batch: Batch) -> tuple[torch.Tensor, Params]:
    """(loss, gradient tree of ``params``' structure), with every tap inside
    the loss and its backward muted.  A leaf the loss does not reach gets a
    zero gradient, as ``jax.grad`` gives it.

    A layer-stacked leaf enters the loss as the tuple of its layers, each
    its own autograd leaf (views, no copy), and its gradient is stacked
    once afterwards.  Taken as one leaf, each layer's ``v[i]`` would give
    back a zero-filled gradient of the whole stack, summed over the
    layers: L times the leaf's bytes, twice, for L layers."""
    with torch.enable_grad(), _obs_hooks.muted():
        live = {k: tree_map(_layer_leaves if k in STACKED else _leaf, params[k])
                for k in sorted(params)}
        loss = loss_fn(live, batch)
        flat = leaves(live)
        grads = list(torch.autograd.grad(loss, flat, allow_unused=True))
    at = iter(range(len(flat)))

    def take():
        i = next(at)
        g, grads[i] = grads[i], None  # each layer's gradient freed once stacked
        return torch.zeros_like(flat[i]) if g is None else g

    out = {k: tree_map((lambda p: torch.stack([take() for _ in range(p.shape[0])]))
                       if k in STACKED else (lambda p: take()), params[k])
           for k in sorted(params)}
    return loss.detach(), out


def _leaf(p: torch.Tensor) -> torch.Tensor:
    return p.detach().requires_grad_(True)


def _layer_leaves(p: torch.Tensor) -> tuple:
    return tuple(x.requires_grad_(True) for x in p.detach().unbind(0))


def accumulate(loss_fn: Callable, params: Params, batch: Batch,
               microbatches: int = 1) -> tuple[torch.Tensor, Params]:
    """(loss, gradients) of ``batch``; with ``microbatches > 1`` summed over
    the strided split (row i -> microbatch i mod mb) in float32 and divided
    by mb."""
    if microbatches <= 1:
        return value_and_grad(loss_fn, params, batch)
    grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    loss = torch.zeros((), dtype=torch.float32, device=leaves(params)[0].device)
    for j in range(microbatches):
        mbatch = {k: v[j::microbatches] for k, v in batch.items()}
        l, g = value_and_grad(loss_fn, params, mbatch)
        for a, b in zip(leaves(grads), leaves(g)):
            a.add_(b)
        loss = loss + l
        del g
    return loss / microbatches, tree_map(lambda g: g / microbatches, grads)


def make_train_step(
    cfg: ModelConfig, opt_cfg: AdamWConfig, microbatches: int = 1, donate: bool = False
) -> Callable[[Params, OptState, Batch], tuple[Params, OptState, dict]]:
    """The train step.  With ``donate`` the params and optimizer state
    passed in are updated in place (``repro_torch.optim.update``), as the
    reference's loop donates them to its jitted step."""
    loss_fn = make_loss_fn(cfg)

    def train_step(params: Params, opt_state: OptState, batch: Batch):
        loss, grads = accumulate(loss_fn, params, batch, microbatches)
        # traffic tap: the gradient tree is exactly the ring all-reduce
        # payload
        _obs_hooks.tap("train.grads", grads=grads)
        new_params, new_opt, metrics = update(opt_cfg, grads, opt_state, params, donate=donate)
        return new_params, new_opt, {"loss": loss, **metrics}

    return train_step
