"""Low-power link codecs: encode/decode pairs over flit streams.

Counterpart of ``repro.codec.schemes``.  Every codec is a bijective
transform of a (T, lanes) uint8 flit stream into the wire image the link
drives, with a decoder that recovers the data: ``decode(encode(x)) == x``.

  * ``none`` — identity.
  * ``gray`` / ``sign_magnitude`` — stateless per-byte recodes
    (``repro_torch.core.coding``).
  * ``transition`` — XOR transition signaling: wire_t = wire_{t-1} ^ data_t,
    a cumulative XOR over rows, so the stream BT is the popcount of the
    data flits after the first.
  * ``bus_invert`` — partitioned bus-invert: each ``partition``-lane group
    carries an invert line and is sent complemented iff that lowers its
    Hamming distance to the previous *wire* flit (ties uninverted).  The
    sequential rule is evaluated in closed form
    (``repro_torch.kernels.axes.bus_invert_lines``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional

import torch

from ..core.coding import (
    bus_invert_partitions,
    gray_decode_bytes,
    gray_encode_bytes,
    sign_magnitude_decode_bytes,
    sign_magnitude_encode_bytes,
)
from ..kernels.axes import CODEC_SCHEMES, bus_invert_lines
from ..kernels.psu import _popcount_bits

__all__ = [
    "CodedStream",
    "Codec",
    "CODECS",
    "SCHEMES",
    "codec_by_name",
    "make_bus_invert",
    "register_codec",
    "bus_invert_partitions",
    "invert_line_transitions",
]

# the static scheme ids the multi-axis measurement switches on
SCHEMES = CODEC_SCHEMES


class CodedStream(NamedTuple):
    """A codec's wire image: ``wire`` (T, lanes) uint8, and ``invert``
    (T, partitions) uint8 bus-invert line states or None."""

    wire: torch.Tensor
    invert: Optional[torch.Tensor] = None


def invert_line_transitions(invert: Optional[torch.Tensor]) -> torch.Tensor:
    """Total transitions of the invert lines themselves (int32 scalar)."""
    if invert is None or invert.shape[0] < 2:
        device = None if invert is None else invert.device
        return torch.zeros((), dtype=torch.int32, device=device)
    return (invert[1:] != invert[:-1]).sum().to(torch.int32)


@dataclasses.dataclass(frozen=True)
class Codec:
    """One registered link codec: a named encode/decode pair.

    ``scheme`` is the static id the measurement switches on; ``partition``
    the bus-invert group width in lanes (None = whole flit); ``stateful``
    codecs depend on flit order, so they code the assembled stream.
    """

    name: str
    scheme: str
    encode: Callable[[torch.Tensor], CodedStream]
    decode: Callable[[CodedStream], torch.Tensor]
    partition: int | None = None
    stateful: bool = False

    def extra_wires(self, lanes: int) -> int:
        """Invert lines added next to a ``lanes``-byte flit."""
        if self.scheme != "bus_invert":
            return 0
        return bus_invert_partitions(lanes, self.partition)[0]


def _stateless(fn: Callable[[torch.Tensor], torch.Tensor]):
    def encode(stream: torch.Tensor) -> CodedStream:
        return CodedStream(fn(stream.to(torch.uint8)), None)

    return encode


def _stateless_decode(fn: Callable[[torch.Tensor], torch.Tensor]):
    def decode(coded: CodedStream) -> torch.Tensor:
        return fn(coded.wire.to(torch.uint8))

    return decode


def transition_encode(stream: torch.Tensor) -> CodedStream:
    """wire_t = wire_{t-1} ^ data_t (wire_0 = data_0): a cumulative XOR
    over rows, by doubling steps."""
    wire = stream.to(torch.uint8).clone()
    step = 1
    while step < wire.shape[0]:
        wire[step:] = wire[step:] ^ wire[:-step]
        step *= 2
    return CodedStream(wire, None)


def transition_decode(coded: CodedStream) -> torch.Tensor:
    w = coded.wire.to(torch.uint8)
    return torch.cat([w[:1], w[1:] ^ w[:-1]], dim=0)


def bus_invert_encode(stream: torch.Tensor, partition: int | None = None) -> CodedStream:
    """Bus-invert over a flit stream: flit 0 uninverted; each later flit
    group complemented iff that strictly lowers its Hamming distance to
    the previous wire flit (ties uninverted)."""
    t, lanes = stream.shape
    npart, pw = bus_invert_partitions(lanes, partition)
    d = stream.to(torch.int32).reshape(t, npart, pw)
    hd = _popcount_bits(d[1:] ^ d[:-1], 8).sum(-1)
    entry = torch.zeros(npart, dtype=torch.int32, device=stream.device)
    inv = bus_invert_lines(hd, 8 * pw, entry)
    wire = (d ^ (inv[:, :, None] * 0xFF)).reshape(t, lanes)
    return CodedStream(wire.to(torch.uint8), inv.to(torch.uint8))


def bus_invert_decode(coded: CodedStream) -> torch.Tensor:
    t, lanes = coded.wire.shape
    npart = coded.invert.shape[-1]
    _, pw = bus_invert_partitions(lanes, lanes // npart)
    w = coded.wire.to(torch.int32).reshape(t, npart, pw)
    inv = coded.invert.to(torch.int32)
    return (w ^ (inv[:, :, None] * 0xFF)).reshape(t, lanes).to(torch.uint8)


CODECS: Dict[str, Codec] = {}


def register_codec(codec: Codec) -> Codec:
    if codec.scheme not in SCHEMES:
        raise ValueError(f"unknown codec scheme {codec.scheme!r}; choose from {SCHEMES}")
    CODECS[codec.name] = codec
    return codec


def make_bus_invert(partition: int | None = None, name: str | None = None) -> Codec:
    """A bus-invert codec with one invert line per ``partition`` lanes
    (None = a single line over the whole flit)."""
    if name is None:
        name = "bus_invert" if partition is None else f"bus_invert{partition}"
    return Codec(
        name=name,
        scheme="bus_invert",
        encode=lambda s, _p=partition: bus_invert_encode(s, _p),
        decode=bus_invert_decode,
        partition=partition,
        stateful=True,
    )


def codec_by_name(name: str) -> Codec:
    """Registry lookup; unknown names list every registered codec."""
    codec = CODECS.get(name)
    if codec is None:
        raise ValueError(
            f"unknown codec {name!r}; registered codecs: {', '.join(sorted(CODECS))}"
        )
    return codec


register_codec(Codec("none", "none", _stateless(lambda s: s), _stateless_decode(lambda s: s)))
register_codec(
    Codec("gray", "gray", _stateless(gray_encode_bytes), _stateless_decode(gray_decode_bytes))
)
register_codec(
    Codec(
        "sign_magnitude",
        "sign_magnitude",
        _stateless(sign_magnitude_encode_bytes),
        _stateless_decode(sign_magnitude_decode_bytes),
    )
)
register_codec(
    Codec("transition", "transition", transition_encode, transition_decode, stateful=True)
)
register_codec(make_bus_invert(None))
register_codec(make_bus_invert(4))
