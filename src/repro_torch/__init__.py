"""PyTorch + CUDA port of the popcount-sorting link-power system.

The port mirrors the module tree of the JAX package ``repro`` so each
counterpart is easy to find (``repro_torch.core.popcount``,
``repro_torch.kernels.psu_sort``, ``repro_torch.link.TxPipeline``,
``repro_torch.obs.write_saif``, ...), but it imports ``torch`` and numpy
only — never JAX and nothing of ``repro``.

Dispatch is decided by the tensor's device (``kernels/backend.py``): a
CUDA tensor launches the hand-written Hopper kernel, a CPU tensor takes
the plain PyTorch version, and ``backend="torch"`` asks for the plain
version on any device.  Entry points that build tensors themselves
(``link.TxPipeline`` given numpy arrays) put them on ``cuda`` unless the
caller passes ``device="cpu"``.

Observability (``repro_torch.obs``) is off and free by default: the
probes in the kernels, link, codec, traffic and NoC modules are one
``None`` test each and never sync the device, until a
``repro_torch.obs.collect()``, ``tracing()`` or ``profiled()`` context
turns them on (``profiled()`` puts their spans in ``torch.profiler``'s
trace).
"""

from .kernels.backend import BACKENDS, resolve_device

__all__ = ["BACKENDS", "resolve_device"]
