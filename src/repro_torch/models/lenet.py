"""A tiny LeNet-5 trained in-repo, so captured conv weights are honest.

Counterpart of ``repro.models.lenet``.  The paper's Table I measures the
sorting unit on LeNet conv traffic; ``benchmarks/datagen.py`` stands in
with synthetic Gaussian weight bytes, and this module trains a real (if
small) LeNet with SGD + momentum + weight decay on a deterministic
synthetic classification task, so its int8 weight image has a trained,
zero-clustered distribution.

The parameter tree and its layouts are the reference's: conv kernels HWIO
``(5, 5, 1, 6)`` / ``(5, 5, 6, 16)``, images NHWC ``(B, 32, 32, 1)``, fully
connected weights ``(in, out)``.  ``lenet_forward`` permutes to OIHW / NCHW
for ``conv2d`` inside and flattens the pooled map in NHWC order, so the
``lenet.conv`` tap records the reference's bytes and a checkpoint (through
``repro_torch.checkpoint``) crosses the packages.  Pooling is a max over
2 x 2 windows at stride 2, unpadded.  ``conv2d`` and ``@`` are library
calls: the reference computes them outside any Pallas kernel.

Draws come from a ``torch.Generator`` (``init_lenet``, ``synth_batch``),
so a LeNet trained here differs from the reference's; parity goes through
carried weights (``repro_torch.convert.lenet_params_from_reference``).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from .. import _obs_hooks
from .._tree import leaves, tree_map
from ..kernels.backend import resolve_device

__all__ = [
    "NUM_CLASSES",
    "init_lenet",
    "lenet_forward",
    "synth_batch",
    "train_lenet",
]

NUM_CLASSES = 10

Params = Dict[str, Any]


def init_lenet(gen: torch.Generator | None, device: str | torch.device | None = None) -> Params:
    """LeNet-5 shapes: 32x32x1 -> conv 6@5x5 -> pool -> conv 16@5x5 ->
    pool -> fc 120 -> 84 -> 10 (all float32), drawn from ``gen`` on its
    device and placed on ``device`` (``cuda`` unless named; ``meta`` gives
    the shapes alone)."""
    dev = resolve_device(device)

    def w(shape, fan_in):
        if dev.type == "meta":
            return torch.empty(shape, dtype=torch.float32, device=dev)
        return (torch.randn(shape, generator=gen, device=gen.device) / math.sqrt(fan_in)).to(dev)

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=dev)

    return {
        "conv1": {"w": w((5, 5, 1, 6), 25), "b": zeros(6)},
        "conv2": {"w": w((5, 5, 6, 16), 150), "b": zeros(16)},
        "fc1": {"w": w((400, 120), 400), "b": zeros(120)},
        "fc2": {"w": w((120, 84), 120), "b": zeros(84)},
        "fc3": {"w": w((84, NUM_CLASSES), 84), "b": zeros(NUM_CLASSES)},
    }


def _conv(x: torch.Tensor, layer: Params) -> torch.Tensor:
    """VALID conv of an NCHW map with an HWIO kernel, plus the bias."""
    y = F.conv2d(x, layer["w"].permute(3, 2, 0, 1))
    return y + layer["b"][None, :, None, None]


def lenet_forward(params: Params, images: torch.Tensor) -> torch.Tensor:
    """Logits for a (B, 32, 32, 1) float batch."""
    # traffic tap: the conv kernels are the Table-I weight stream and the
    # batch the input stream
    _obs_hooks.tap(
        "lenet.conv",
        conv1=params["conv1"]["w"],
        conv2=params["conv2"]["w"],
        inputs=images,
    )
    x = images.permute(0, 3, 1, 2)  # NHWC -> NCHW
    x = F.max_pool2d(torch.tanh(_conv(x, params["conv1"])), 2, 2)
    x = F.max_pool2d(torch.tanh(_conv(x, params["conv2"])), 2, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (B, 400) in NHWC order
    x = torch.tanh(x @ params["fc1"]["w"] + params["fc1"]["b"])
    x = torch.tanh(x @ params["fc2"]["w"] + params["fc2"]["b"])
    return x @ params["fc3"]["w"] + params["fc3"]["b"]


@functools.lru_cache(maxsize=8)
def _templates(seed: int) -> np.ndarray:
    """One deterministic smooth 32x32 template per class (box-filtered
    noise, the ``benchmarks/datagen`` recipe) — a separable-by-construction
    10-way task so a few hundred SGD steps visibly learn it."""
    rng = np.random.default_rng(seed)
    raw = rng.normal(size=(NUM_CLASSES, 40, 40)).astype(np.float32)
    k = np.ones((9, 9), np.float32) / 81.0
    out = np.empty((NUM_CLASSES, 32, 32), np.float32)
    for c in range(NUM_CLASSES):
        acc = np.zeros((32, 32), np.float32)
        for i in range(9):
            for j in range(9):
                acc += k[i, j] * raw[c, i : i + 32, j : j + 32]
        out[c] = acc / max(np.abs(acc).max(), 1e-6)
    return out


def synth_batch(
    gen: torch.Generator, batch: int = 64, seed: int = 0, noise: float = 0.3,
    device: str | torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(images (B,32,32,1), labels (B,)) — class template + fresh noise,
    drawn from ``gen`` and placed on ``device`` (``cuda`` unless named)."""
    dev = resolve_device(device)
    tpl = torch.from_numpy(_templates(seed)).to(dev)
    labels = torch.randint(0, NUM_CLASSES, (batch,), generator=gen, device=gen.device).to(dev)
    noise_img = torch.randn((batch, 32, 32), generator=gen, device=gen.device).to(dev)
    imgs = tpl[labels] + noise * noise_img
    return imgs[..., None], labels


def _loss(params: Params, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = lenet_forward(params, images)
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.take_along_dim(lp, labels[:, None].long(), dim=-1).mean()


def _sgd_step(params, vel, images, labels, lr, momentum, weight_decay):
    """One SGD step with momentum and weight decay, in place on params and
    vel; returns the loss before the step."""
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = _loss(live, images, labels)
        grads = torch.autograd.grad(loss, leaves(live))
    with torch.no_grad():
        for p, v, g in zip(leaves(params), leaves(vel), grads):
            v.mul_(momentum).add_(g)  # vel = momentum * vel + g
            p.sub_((v + weight_decay * p).mul_(lr))  # p - lr * (vel + wd * p)
    return loss.detach()


def train_lenet(
    steps: int = 300,
    batch: int = 64,
    lr: float = 0.05,
    momentum: float = 0.9,
    weight_decay: float = 1e-3,
    seed: int = 0,
    ckpt_dir: str | None = None,
    device: str | torch.device | None = None,
) -> tuple[Params, dict]:
    """Train (or restore) the LeNet on ``device`` (``cuda`` unless named);
    returns (params, info).

    With ``ckpt_dir`` set and a checkpoint present the training loop is
    skipped entirely and the stored weights come back
    (``info["restored"] is True``); a checkpoint written by the reference's
    ``train_lenet`` restores too.  SGD + momentum + weight decay: the decay
    term is what makes the int8 weight image cluster around zero.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_lenet(gen, dev)

    manager = None
    if ckpt_dir is not None:
        from ..checkpoint import CheckpointManager, restore_resharded

        manager = CheckpointManager(ckpt_dir, keep=1)
        if manager.latest_step() is not None:
            tree, extra, step = manager.restore(params)
            return restore_resharded(tree, dev), {
                "restored": True,
                "steps": step,
                "final_loss": extra.get("final_loss"),
            }

    vel = tree_map(torch.zeros_like, params)
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    for _ in range(steps):
        images, labels = synth_batch(gen, batch=batch, seed=seed, device=dev)
        loss = _sgd_step(params, vel, images, labels, lr, momentum, weight_decay)
    final_loss = float(loss)

    if manager is not None:
        manager.save(steps, params, extra={"final_loss": final_loss})
    return params, {"restored": False, "steps": steps, "final_loss": final_loss}
