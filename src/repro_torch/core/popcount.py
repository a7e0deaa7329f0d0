"""Popcount ('1'-bit count) primitives — the paper's stage 1.

Counterpart of ``repro.core.popcount``.  PyTorch has no popcount op, so
:func:`popcount` is a SWAR bit count on int64 lanes (exact for widths up
to 32); :func:`popcount_lut4` keeps the hardware-faithful 4-bit LUT +
adder formulation (Fig. 1) as the circuit oracle.  Every function works
elementwise on integer tensors of any device and returns int32.
"""

from __future__ import annotations

import torch

__all__ = [
    "popcount",
    "popcount_lut4",
    "bucket_map",
    "bucket_boundaries",
    "num_bucket_bits",
]

_M1 = 0x5555555555555555
_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F


def _check_width(width: int) -> None:
    if width < 1 or width > 32:
        raise ValueError(f"width must be in [1, 32], got {width}")


def _low_bits(x: torch.Tensor, width: int) -> torch.Tensor:
    """The low ``width`` bits of each element as non-negative int64
    (two's-complement bits of signed inputs, as a uint32 view has)."""
    return x.to(torch.int64) & ((1 << width) - 1)


def popcount(x: torch.Tensor, width: int = 8) -> torch.Tensor:
    """Exact '1'-bit count of the low ``width`` bits of each element.

    Returns an int32 tensor of the same shape with values in [0, width].
    """
    _check_width(width)
    v = _low_bits(x, width)
    v = v - ((v >> 1) & _M1)
    v = (v & _M2) + ((v >> 2) & _M2)
    v = (v + (v >> 4)) & _M4
    v = v + (v >> 8)
    v = v + (v >> 16)
    return (v & 0x3F).to(torch.int32)


def popcount_lut4(x: torch.Tensor, width: int = 8) -> torch.Tensor:
    """Hardware-faithful popcount: 4-bit LUT lookups summed by adders.

    The W-bit input is split into ceil(W/4) nibbles, each nibble indexes a
    16-entry LUT of Hamming weights, and the LUT outputs are summed.
    Numerically identical to :func:`popcount`.
    """
    _check_width(width)
    lut = torch.tensor(
        [bin(i).count("1") for i in range(16)], dtype=torch.int32, device=x.device
    )
    ux = _low_bits(x, width)
    total = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for n in range((width + 3) // 4):
        total = total + lut[(ux >> (4 * n)) & 0xF]
    return total


def bucket_boundaries(width: int, k: int) -> list[int]:
    """Popcount value -> bucket index, as a list of length ``width + 1``.

    For W=8, k=4 this is the paper's {0,1,2}->0, {3,4}->1, {5,6}->2,
    {7,8}->3.
    """
    return [(p * k) // (width + 1) for p in range(width + 1)]


def bucket_map(p: torch.Tensor, width: int = 8, k: int = 4) -> torch.Tensor:
    """APP-PSU coarse bucket of each exact count: ``p * k // (W + 1)``."""
    if k < 1 or k > width + 1:
        raise ValueError(f"k must be in [1, width+1]; got k={k}, width={width}")
    return torch.div(p.to(torch.int32) * k, width + 1, rounding_mode="floor")


def num_bucket_bits(k: int) -> int:
    """Datapath width of the bucket index: ceil(log2(k)) bits (>= 1)."""
    return max(1, (k - 1).bit_length())
