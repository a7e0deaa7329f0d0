"""Carry state across from the JAX package.

The transmit path has no trained weights: its state is the configuration
plus the data.  :func:`from_reference` rebuilds the port's ``LinkSpec`` and
``LinkPowerModel`` from the reference's objects given as
``dataclasses.asdict`` dicts of Python scalars (so this module never
imports the reference), and :func:`packets_from_numpy` moves numpy packet
arrays — what ``benchmarks/datagen.py`` makes for both packages — onto a
device with their dtype unchanged.  For model traffic,
:func:`model_config_from_reference` rebuilds a ``ModelConfig`` from its
``asdict`` dict and :func:`params_from_numpy` carries a nested dict of
numpy weights (the reference's ``init_params`` tree, as numpy) across.
For the NoC and the design-space sweep, :func:`flows_from_reference`
builds ``noc.TrafficFlow``s from (name, src, dsts, inputs, weights) tuples
of numpy payloads and :func:`design_point_from_reference` rebuilds a
``dse.DesignPoint`` from its ``asdict`` dict.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels.backend import resolve_device
from .link.power import LinkPowerModel
from .link.spec import LinkSpec
from .dse.space import DesignPoint
from .models.config import ModelConfig, MoEConfig, SSMConfig
from .noc.simulate import TrafficFlow

__all__ = [
    "from_reference",
    "packets_from_numpy",
    "model_config_from_reference",
    "params_from_numpy",
    "flows_from_reference",
    "design_point_from_reference",
]


def from_reference(spec_dict: dict, power_dict: dict | None = None):
    """(LinkSpec, LinkPowerModel) from the reference's dataclass dicts."""
    spec = LinkSpec(**spec_dict)
    power = LinkPowerModel(**power_dict) if power_dict is not None else LinkPowerModel()
    return spec, power


def packets_from_numpy(a: np.ndarray, device: str | torch.device | None = None) -> torch.Tensor:
    """A numpy packet array as a tensor of the same dtype and shape on
    ``device`` (``cuda`` unless named)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(resolve_device(device))


def model_config_from_reference(config_dict: dict) -> ModelConfig:
    """The port's ``ModelConfig`` from the reference's ``asdict`` dict,
    its nested MoE / SSM dicts rebuilt as dataclasses."""
    fields = dict(config_dict)
    if fields.get("moe") is not None:
        fields["moe"] = MoEConfig(**fields["moe"])
    if fields.get("ssm") is not None:
        fields["ssm"] = SSMConfig(**fields["ssm"])
    return ModelConfig(**fields).validate()


def params_from_numpy(tree: dict, device: str | torch.device | None = None) -> dict:
    """A nested dict of numpy arrays as the same dict of tensors, dtypes
    and shapes unchanged, on ``device`` (``cuda`` unless named)."""
    dev = resolve_device(device)
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = params_from_numpy(v, dev)
        else:
            a = np.asarray(v)
            out[k] = packets_from_numpy(a if a.flags.writeable else a.copy(), dev)
    return out


def flows_from_reference(
    flows, device: str | torch.device | None = None
) -> list[TrafficFlow]:
    """The port's ``TrafficFlow``s from (name, src, dsts, inputs, weights)
    tuples: numpy payloads (``weights`` may be None) carried to ``device``
    (``cuda`` unless named) with their dtype unchanged."""
    dev = resolve_device(device)
    return [
        TrafficFlow(
            str(name), int(src), tuple(int(d) for d in dsts),
            packets_from_numpy(np.asarray(inputs), dev),
            None if weights is None else packets_from_numpy(np.asarray(weights), dev),
        )
        for name, src, dsts, inputs, weights in flows
    ]


def design_point_from_reference(point_dict: dict) -> DesignPoint:
    """The port's ``DesignPoint`` from the reference's ``asdict`` dict."""
    return DesignPoint(**point_dict)
