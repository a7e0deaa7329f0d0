"""Carry state across from the JAX package.

The transmit path has no trained weights: its state is the configuration
plus the data.  :func:`from_reference` rebuilds the port's ``LinkSpec`` and
``LinkPowerModel`` from the reference's objects given as
``dataclasses.asdict`` dicts of Python scalars (so this module never
imports the reference), and :func:`packets_from_numpy` moves numpy packet
arrays — what ``benchmarks/datagen.py`` makes for both packages — onto a
device with their dtype unchanged.  For model traffic,
:func:`model_config_from_reference` rebuilds a ``ModelConfig`` from its
``asdict`` dict, :func:`params_from_numpy` carries a nested dict of
numpy weights across (bfloat16 arrays included) and
:func:`params_from_reference` carries the reference's ``init_params``
tree, as numpy, into the port's tree, checked against the port's
``param_shapes``.
For the training path, :func:`lenet_params_from_reference` carries the
reference's LeNet tree (HWIO conv kernels, as numpy), checked against
``init_lenet``'s shapes, and :func:`opt_state_from_reference` its AdamW
``OptState`` (as numpy).
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
    "params_from_reference",
    "lenet_params_from_reference",
    "opt_state_from_reference",
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


def _tensor_from_numpy(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """``torch.from_numpy`` refuses ``ml_dtypes`` bfloat16: those arrays
    cross as their uint16 bits, viewed back as ``torch.bfloat16``."""
    a = a if a.flags.writeable else a.copy()
    if a.dtype.name == "bfloat16":
        return packets_from_numpy(a.view(np.uint16), dev).view(torch.bfloat16)
    return packets_from_numpy(a, dev)


def params_from_numpy(tree: dict, device: str | torch.device | None = None) -> dict:
    """A nested dict of numpy arrays as the same dict of tensors, dtypes
    (bfloat16 included) and shapes unchanged, on ``device`` (``cuda``
    unless named)."""
    dev = resolve_device(device)
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = params_from_numpy(v, dev)
        else:
            out[k] = _tensor_from_numpy(np.asarray(v), dev)
    return out


def _mismatches(got: dict, want: dict, path: str = "") -> list[str]:
    bad = [f"{path}{k}: missing" for k in want if k not in got]
    bad += [f"{path}{k}: not a parameter of this config" for k in got if k not in want]
    for k in want.keys() & got.keys():
        g, w = got[k], want[k]
        if isinstance(w, dict) != isinstance(g, dict):
            bad.append(f"{path}{k}: tree structure differs")
        elif isinstance(w, dict):
            bad += _mismatches(g, w, f"{path}{k}/")
        elif (tuple(g.shape), g.dtype) != (tuple(w.shape), w.dtype):
            bad.append(f"{path}{k}: {tuple(g.shape)} {g.dtype} != {tuple(w.shape)} {w.dtype}")
    return bad


def params_from_reference(
    tree: dict, cfg: ModelConfig, device: str | torch.device | None = None
) -> dict:
    """The reference's parameter tree (``repro.models.init_params``, as
    numpy arrays: ``jax.tree.map(np.asarray, params)``) as the port's
    tree on ``device`` (``cuda`` unless named).  Both packages stack layers
    on a leading axis with the same keys, so leaves carry across one to
    one; every path, shape and dtype is checked against the port's
    ``param_shapes(cfg)`` and a mismatch raises."""
    from .models.transformer import param_shapes  # deferred: the model zoo

    out = params_from_numpy(tree, device)
    bad = _mismatches(out, param_shapes(cfg))
    if bad:
        raise ValueError(f"{cfg.name}: reference parameters do not fit the port's tree: "
                         + "; ".join(sorted(bad)))
    return out


def lenet_params_from_reference(tree: dict, device: str | torch.device | None = None) -> dict:
    """The reference's LeNet tree (``repro.models.lenet.init_lenet`` /
    ``train_lenet``, as numpy: HWIO conv kernels, (in, out) dense weights)
    as the port's on ``device`` (``cuda`` unless named); every path, shape
    and dtype is checked against ``init_lenet``'s and a mismatch raises."""
    from .models.lenet import init_lenet  # deferred: the model zoo

    out = params_from_numpy(tree, device)
    bad = _mismatches(out, init_lenet(None, "meta"))
    if bad:
        raise ValueError("LeNet: reference parameters do not fit the port's tree: "
                         + "; ".join(sorted(bad)))
    return out


def opt_state_from_reference(state, device: str | torch.device | None = None):
    """The reference's AdamW ``OptState`` (step, m, v; as numpy:
    ``jax.tree.map(np.asarray, state)``) as the port's ``OptState`` on
    ``device`` (``cuda`` unless named), the step a 0-d int32 tensor."""
    from .optim import OptState  # deferred: the training path

    step, m, v = state
    dev = resolve_device(device)
    return OptState(step=torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=dev),
                    m=params_from_numpy(m, dev), v=params_from_numpy(v, dev))


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
