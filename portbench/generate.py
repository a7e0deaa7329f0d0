"""The one traffic generator: a cell's input snapshots, made on the device
from ``--seed`` in a few large calls.

A snapshot is what one step measures: the flat float32 gradient of the
configuration's whole parameter tree and, where the mix asks for them,
the weights that fix the static egress permutation.  The gradient is
N(0, 1) scaled by one lognormal(0, sigma) factor per quantizer block, the
recipe of ``chip_smoke.py``'s ``full_gradient``: block scales that span
orders of magnitude, as real gradients' do.  The weights are each leaf of
the configuration drawn from N(mean, std) with the scales its file lists
under ``assumed.weight_init``.  The same seed on the same device gives the
same bytes.
"""

from __future__ import annotations

import math

import torch


def gradient_elements(config: dict) -> int:
    """Elements of the configuration's flat gradient: every leaf."""
    return sum(math.prod(shape) for shape in config["leaves"].values())


def gradient(m: int, block: int, sigma: float, gen: torch.Generator,
             device: torch.device) -> torch.Tensor:
    """N(0, 1) scaled by lognormal(0, sigma) per block of ``block`` values."""
    g = torch.randn(m, generator=gen, device=device)
    nb = m // block
    g[: nb * block].view(nb, block).mul_(
        torch.empty((nb, 1), device=device).log_normal_(0.0, sigma, generator=gen))
    return g


def weights(config: dict, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    """Every leaf, in the file's order, drawn into one flat float32 vector."""
    init = config["assumed"]["weight_init"]
    out = torch.empty(gradient_elements(config), device=device)
    a = 0
    for name, shape in config["leaves"].items():
        b = a + math.prod(shape)
        mean, std = init[name]["mean"], init[name]["std"]
        if std > 0:
            out[a:b].normal_(mean, std, generator=gen)
        else:
            out[a:b].fill_(mean)
        a = b
    return out


def snapshots(config: dict, mix: dict, seed: int, device: torch.device) -> list[dict]:
    """The mix's ``snapshots`` inputs: {"grad"} or {"grad", "weights"}."""
    gen = torch.Generator(device=device).manual_seed(seed)
    m = gradient_elements(config)
    out = []
    for _ in range(mix["snapshots"]):
        snap = {"grad": gradient(m, mix["quantizer_block"], mix["gradient_lognormal_sigma"],
                                 gen, device)}
        if mix["weights"]:
            snap["weights"] = weights(config, gen, device)
        out.append(snap)
    return out
