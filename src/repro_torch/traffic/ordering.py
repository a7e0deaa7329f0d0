"""The int8 wire view of model tensors (part of ``repro.traffic.ordering``).

The rest of the reference module (row ordering, MLP / head permutations,
the gradient egress permutation, stream BT reports) is a later slice.
"""

from __future__ import annotations

import torch

__all__ = ["int8_view"]


def int8_view(w: torch.Tensor) -> torch.Tensor:
    """Symmetric per-tensor int8 quantization of a weight tensor (the wire
    / HBM-stream image used for BT accounting and ordering keys): float32
    division by max|w| / 127 and round-half-to-even, as the reference."""
    x = w.to(torch.float32)
    scale = (x.abs().max() / 127.0).clamp_min(1e-12)
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
