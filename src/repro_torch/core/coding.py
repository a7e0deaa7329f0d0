"""Stateless wire byte recodes (gray, sign-magnitude) and the bus-invert
partition contract.

Counterpart of ``repro.core.coding``.  Every map works on the low 8 bits
of an integer tensor and returns the input dtype.
"""

from __future__ import annotations

import torch

__all__ = [
    "gray_encode_bytes",
    "gray_decode_bytes",
    "sign_magnitude_encode_bytes",
    "sign_magnitude_decode_bytes",
    "bus_invert_partitions",
]


def bus_invert_partitions(lanes: int, partition: int | None) -> tuple[int, int]:
    """(number of partitions, lanes per partition) of a bus-invert framing.

    ``partition=None`` is one invert line over the whole flit; otherwise it
    must divide the flit's lane count.
    """
    pw = lanes if partition is None else partition
    if pw < 1 or lanes % pw != 0:
        raise ValueError(
            f"bus-invert partition of {pw} lanes does not divide the "
            f"{lanes}-lane flit"
        )
    return lanes // pw, pw


def gray_encode_bytes(x: torch.Tensor) -> torch.Tensor:
    """Reflected-binary Gray code of each byte: g = b ^ (b >> 1)."""
    v = x.to(torch.int32) & 0xFF
    return ((v ^ (v >> 1)) & 0xFF).to(x.dtype)


def gray_decode_bytes(g: torch.Tensor) -> torch.Tensor:
    """Inverse Gray map per byte (prefix-XOR fold over the 8 bits)."""
    v = g.to(torch.int32) & 0xFF
    for s in (1, 2, 4):
        v = v ^ (v >> s)
    return (v & 0xFF).to(g.dtype)


def sign_magnitude_encode_bytes(x: torch.Tensor) -> torch.Tensor:
    """Two's-complement int8 byte patterns to sign|magnitude bytes
    (0x80, the lone -128 pattern, maps to 0x80)."""
    v = x.to(torch.int32) & 0xFF
    neg = v >= 0x80
    mag = torch.where(neg, (0x100 - v) & 0xFF, v)
    out = torch.where(neg, 0x80 | (mag & 0x7F), mag)
    return (out & 0xFF).to(x.dtype)


def sign_magnitude_decode_bytes(s: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`sign_magnitude_encode_bytes` per byte."""
    v = s.to(torch.int32) & 0xFF
    mag = v & 0x7F
    neg = v >= 0x80
    out = torch.where(neg, torch.where(mag == 0, 0x80, (0x100 - mag) & 0xFF), mag)
    return (out & 0xFF).to(s.dtype)
