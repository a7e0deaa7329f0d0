"""Device-decides dispatch for the kernel entry points.

Counterpart of ``repro.kernels.backend``, without its environment variable
and interpreter.  One rule for every wrapper:

  * a CUDA tensor launches the hand-written Hopper kernel;
  * a CPU tensor takes the plain PyTorch version;
  * an explicit ``backend="torch"`` runs the plain version on any device
    (how ``chip_smoke.py`` and the tests compare the two on the card).

Nothing falls back: a kernel that cannot be built or launched raises.
"""

from __future__ import annotations

import torch

__all__ = ["BACKENDS", "check_backend", "use_kernel", "resolve_device"]

BACKENDS = ("torch",)


def check_backend(backend: str | None) -> str | None:
    """Validate a ``backend=`` keyword (None = decided by the device)."""
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"unknown kernel backend {backend!r}; choose from {BACKENDS}")
    return backend


def use_kernel(t: torch.Tensor, backend: str | None) -> bool:
    """True when ``t`` goes through the CUDA kernel, False for the plain
    PyTorch version; raises for a combination that has neither."""
    check_backend(backend)
    if backend == "torch":
        return False
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no kernel path for tensors on {t.device}")
    return False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point builds its tensors on: ``cuda`` unless
    the caller names another."""
    return torch.device("cuda" if device is None else device)
