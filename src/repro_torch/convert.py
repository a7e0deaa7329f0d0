"""Carry state across from the JAX package.

The transmit path has no trained weights: its state is the configuration
plus the data.  :func:`from_reference` rebuilds the port's ``LinkSpec`` and
``LinkPowerModel`` from the reference's objects given as
``dataclasses.asdict`` dicts of Python scalars (so this module never
imports the reference), and :func:`packets_from_numpy` moves numpy packet
arrays — what ``benchmarks/datagen.py`` makes for both packages — onto a
device with their dtype unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels.backend import resolve_device
from .link.power import LinkPowerModel
from .link.spec import LinkSpec

__all__ = ["from_reference", "packets_from_numpy"]


def from_reference(spec_dict: dict, power_dict: dict | None = None):
    """(LinkSpec, LinkPowerModel) from the reference's dataclass dicts."""
    spec = LinkSpec(**spec_dict)
    power = LinkPowerModel(**power_dict) if power_dict is not None else LinkPowerModel()
    return spec, power


def packets_from_numpy(a: np.ndarray, device: str | torch.device | None = None) -> torch.Tensor:
    """A numpy packet array as a tensor of the same dtype and shape on
    ``device`` (``cuda`` unless named)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(resolve_device(device))
