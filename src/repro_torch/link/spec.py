"""`LinkSpec` — the one frozen dataclass that configures the TX pipeline.

Counterpart of ``repro.link.spec``: the framing of the physical link
(DESIGN.md §1: a 128-bit link carrying 4-flit packets, each flit split
between input and weight byte lanes) plus the stage selection — key,
encode, pack and the wire codec.  Field names, defaults and derived
properties are the reference's.
"""

from __future__ import annotations

import dataclasses

__all__ = ["LinkSpec"]


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """Framing + stage configuration of one transmit pipeline.

    Framing defaults reproduce the paper's Table-I setup.
    """

    # --- framing (physical link) ---
    width_bits: int = 128  # physical link width
    flits_per_packet: int = 4
    input_lanes: int = 8  # bytes of input data per flit
    weight_lanes: int = 8  # bytes of weight data per flit

    # --- stage selection ---
    key: str = "acc"  # repro_torch.link.stages.KEY_STAGES
    encode: str = "identity"  # repro_torch.link.stages.ENCODE_STAGES
    pack: str = "lane"  # repro_torch.link.stages.PACK_STAGES
    codec: str = "none"  # repro_torch.codec.CODECS (wire coding of the stream)

    # --- key-stage parameters ---
    width: int = 8  # element bit width W of the sort keys
    k: int = 4  # APP / row-bucket count
    descending: bool = False

    @property
    def bytes_per_flit(self) -> int:
        return self.width_bits // 8

    @property
    def elems_per_packet(self) -> int:
        """Input bytes carried per packet."""
        return self.flits_per_packet * self.input_lanes

    @property
    def weight_elems_per_packet(self) -> int:
        """Weight bytes carried per packet."""
        return self.flits_per_packet * self.weight_lanes

    @property
    def symmetric(self) -> bool:
        """Input/weight lanes match: (input, weight) pairs move together."""
        return self.input_lanes == self.weight_lanes

    def __post_init__(self) -> None:
        if self.input_lanes + self.weight_lanes != self.bytes_per_flit:
            raise ValueError(
                "input_lanes + weight_lanes must fill the flit: "
                f"{self.input_lanes}+{self.weight_lanes} != {self.bytes_per_flit}"
            )
        from . import stages

        for field, registry in (
            ("key", stages.KEY_STAGES),
            ("encode", stages.ENCODE_STAGES),
            ("pack", stages.PACK_STAGES),
        ):
            stages.lookup_stage(field, getattr(self, field), registry)
        if self.codec != "none":
            # deferred: repro_torch.codec builds on this package, so it is
            # imported only when a spec names a codec, never while
            # repro_torch.link itself initializes
            from ..codec.schemes import CODECS

            stages.lookup_stage("codec", self.codec, CODECS)
