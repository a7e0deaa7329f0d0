"""Bit-transition (BT) counting — the paper's evaluation metric.

Counterpart of ``repro.core.bt``.  BT of a (T, B) flit stream is the sum
of Hamming distances between consecutive flits.  Totals are int32 and wrap
modulo 2**32 exactly as the JAX package's int32 sums do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .popcount import popcount

__all__ = ["bit_transitions", "bt_per_flit", "BTReport", "bt_report", "wrap_int32"]


def wrap_int32(total: torch.Tensor) -> torch.Tensor:
    """An int64 total reduced to int32 with two's-complement wrap."""
    return (((total.to(torch.int64) + 2**31) % 2**32) - 2**31).to(torch.int32)


def bit_transitions(stream: torch.Tensor, width: int = 8) -> torch.Tensor:
    """Total bit transitions of a (T, B) stream: int32 scalar tensor."""
    a = stream.to(torch.int64)
    flips = a[1:] ^ a[:-1]
    return wrap_int32(popcount(flips, width).sum(dtype=torch.int64))


def bt_per_flit(stream: torch.Tensor, width: int = 8) -> torch.Tensor:
    """Average BT per transmitted flit (Table I's normalisation), float32."""
    t = stream.shape[0]
    return bit_transitions(stream, width) / max(t, 1)


class BTReport(NamedTuple):
    """Per-side BT accounting matching Table I columns."""

    input_bt_per_flit: torch.Tensor
    weight_bt_per_flit: torch.Tensor
    overall_bt_per_flit: torch.Tensor

    def reduction_vs(self, base: "BTReport") -> torch.Tensor:
        """Overall BT reduction relative to a baseline report (fraction)."""
        return 1.0 - self.overall_bt_per_flit / base.overall_bt_per_flit


def bt_report(stream: torch.Tensor, input_lanes: int, width: int = 8) -> BTReport:
    """Split BT between the input lanes [0, input_lanes) and the rest."""
    inp = bt_per_flit(stream[:, :input_lanes], width)
    wgt = bt_per_flit(stream[:, input_lanes:], width)
    return BTReport(inp, wgt, inp + wgt)
