"""Production mesh construction (counterpart of ``repro.launch.mesh``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axis names, ``("data", "model")`` or ``("pod", "data",
"model")``, built over the default process group, which the caller starts
(``torch.distributed.init_process_group`` with its address, world size and
rank).  Building one needs a world of exactly the mesh's size: 256 ranks
for the pod, 512 with ``multi_pod``.

The rules (``sharding.py``) read only a mesh's axis names and sizes, so
they also take an :class:`AbstractMesh`, or any object with ``.shape``
(name -> size) and ``.axis_names``, as the reference's tests pass a
``SimpleNamespace``: the meta-tensor dry run (``dryrun.py``) places the
production cells on such a mesh with no process group at all.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

__all__ = ["AbstractMesh", "make_production_mesh", "make_smoke_mesh", "dp_axes",
           "axis_size", "mesh_axes"]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes with no devices behind them."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        out = 1
        for s in self.axis_sizes:
            out *= s
        return out


def _device_mesh(shape: tuple[int, ...], names: tuple[str, ...], device: str):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """16x16 = 256-rank pod ("data", "model"); multi_pod adds a leading
    2-wide "pod" axis (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(shape, axes, device)


def make_smoke_mesh(devices: int | None = None, device: str = "cuda"):
    """A (1, n) ("data", "model") mesh over the default process group's
    ranks (n = its world size unless given)."""
    import torch.distributed as dist

    n = devices or dist.get_world_size()
    return _device_mesh((1, n), ("data", "model"), device)


def mesh_axes(mesh) -> dict[str, int]:
    """Axis name -> size, in the mesh's axis order, of a ``DeviceMesh`` or
    of any object with ``.shape`` (a mapping) and ``.axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # a DeviceMesh: .shape is a tuple of sizes
        return dict(zip(names, tuple(mesh.shape)))
    shape: Mapping[str, int] = mesh.shape
    return {a: int(shape[a]) for a in mesh.axis_names}


def dp_axes(mesh) -> tuple[str, ...]:
    """Data-parallel axes: ("pod", "data") when the pod axis exists."""
    return tuple(a for a in mesh_axes(mesh) if a in ("pod", "data"))


def axis_size(mesh, *names: str) -> int:
    axes = mesh_axes(mesh)
    out = 1
    for n in names:
        if n in axes:
            out *= axes[n]
    return out
