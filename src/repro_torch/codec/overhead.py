"""Codec overhead accounting: extra wires, encoder area, energy.

Counterpart of ``repro.codec.overhead``.  Bus-invert adds one invert line
per partition, whose transitions cost switching energy and whose flop
widens the clocked register bank; every scheme adds encoder logic
(``repro_torch.core.area.codec_area``).  Comparisons are net of both.
"""

from __future__ import annotations

import dataclasses

from ..core.area import codec_area
from ..link.power import LinkPowerModel
from .schemes import Codec, codec_by_name

__all__ = ["CodecOverhead", "codec_overhead", "coded_energy_pj"]


@dataclasses.dataclass(frozen=True)
class CodecOverhead:
    """What one codec costs on an L-byte-lane link."""

    codec: str
    data_wires: int  # 8 * lanes: the wires the link had anyway
    extra_wires: int  # invert lines added beside them
    encoder_area_um2: float

    @property
    def wire_overhead(self) -> float:
        """Fractional widening of the physical link."""
        return self.extra_wires / self.data_wires


def _resolve(codec: Codec | str) -> Codec:
    return codec if isinstance(codec, Codec) else codec_by_name(codec)


def codec_overhead(codec: Codec | str, lanes: int) -> CodecOverhead:
    """Wire + encoder-area overhead of ``codec`` on a ``lanes``-byte flit."""
    c = _resolve(codec)
    return CodecOverhead(
        codec=c.name,
        data_wires=8 * lanes,
        extra_wires=c.extra_wires(lanes),
        encoder_area_um2=codec_area(c.scheme, lanes, c.partition),
    )


def coded_energy_pj(
    power: LinkPowerModel,
    codec: Codec | str,
    data_bt: float,
    aux_bt: float,
    num_flits: int,
    lanes: int,
) -> float:
    """Stream energy under ``power``, charging the codec's added lines."""
    ov = codec_overhead(codec, lanes)
    return power.coded_link_energy_pj(data_bt, aux_bt, num_flits, ov.data_wires, ov.extra_wires)
