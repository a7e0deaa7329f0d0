"""Analytical area model — reproduces the paper's Fig. 5 scaling claims.

A verbatim copy of ``repro.core.area`` (pure Python): the JAX package's
``__init__`` loads JAX, so the port keeps its own copy and the tests hold
the two equal.

We have no 22 nm EDA flow, so absolute um^2 are *modeled*; the model is
anchored so the paper's measured points hold exactly (DESIGN.md §6):

  * APP-PSU total area: 2193 um^2 @ N=25, 6928 um^2 @ N=49 (paper §IV-B.3)
  * overall APP vs ACC reduction @ N=25: 35.4 %
  * popcount-unit reduction: 24.9 %; sorting-unit reduction: 36.7 %

Structural form (W = input bit width, K = bucket count, N = sort width):

  popcount(N, out_bits) = A_PC * N * (1 + PRUNE * out_bits)
      -- 4-bit LUTs + adder tree; the approximate unit synthesizes only the
         bucket index, pruning the upper adder levels (out_bits 4 -> 2).
  sort(N, K) = C_NK * N * K  +  C_N2 * N^2 * (1 + BETA * K)
      -- one-hot encode / histogram / prefix-sum scale with N*K; the index
         mapping (scatter crossbar) contributes the N^2 wiring term whose
         control width grows with the one-hot bucket count (BETA).

Baselines for Fig. 5: Batcher bitonic (comparator network, N log^2 N
compare-exchange units) and CSN (constant-time, ~1.8x bitonic logic,
paper §II).  Gate-level constants are representative 22 nm equivalents.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = [
    "PSUArea",
    "psu_area",
    "bitonic_area",
    "csn_area",
    "codec_area",
    "AREA_ANCHORS",
    "PSUTiming",
    "psu_timing",
    "bitonic_timing",
]

# --- calibrated constants (closed-form solve, see DESIGN.md §6) -------------
A_PC = 373.0 / (25 * 1.992)  # popcount scale: 11 % of ACC-PSU total @ N=25
PRUNE = 0.248  # adder-level pruning per output bit (fits the 24.9 % claim)
C_NK = 5.155  # one-hot/histogram/prefix datapath, per element-bucket
C_N2 = 1.642  # scatter crossbar wiring, per element^2
BETA = 0.0904  # crossbar control-width growth per bucket

# gate-level constants for comparator baselines and the link-codec
# encoders (22 nm equivalents, um^2)
_FA_AREA = 1.0  # full adder / 1-bit comparator slice
_MUX_BIT = 0.55  # 2:1 mux per bit
_DFF_BIT = 1.1  # pipeline register per bit
_XOR_BIT = 0.75  # 2-input XOR per bit

AREA_ANCHORS = {
    ("app", 25): 2193.0,
    ("app", 49): 6928.0,
    ("acc", 25): 3394.0,  # derived: 2193 / (1 - 0.354)
}


@dataclasses.dataclass(frozen=True)
class PSUArea:
    """Area breakdown of one transmit-side unit (um^2, modeled).

    ``codec`` is the link-codec encoder sitting after the sorting unit
    (zero when the link is uncoded) — folded in here so any area-vs-BT
    comparison that adds a codec is automatically net of its hardware."""

    popcount: float
    sort: float
    codec: float = 0.0

    @property
    def total(self) -> float:
        return self.popcount + self.sort + self.codec


def psu_area(n: int, width: int = 8, k: int | None = None) -> PSUArea:
    """Area of an ACC-PSU (k=None) or APP-PSU (k buckets) sorting n elements.

    Args:
      n: sort window size (kernel size in the paper: 25 or 49).
      width: input element bit width W.
      k: bucket count for APP; ``None`` means exact (K = W + 1).
    """
    if k is None:
        buckets = width + 1
        out_bits = max(1, math.ceil(math.log2(width + 1)))
    else:
        if not 1 <= k <= width + 1:
            raise ValueError(f"k={k} out of range [1, {width + 1}]")
        buckets = k
        out_bits = max(1, math.ceil(math.log2(k)))
    pc = A_PC * n * (1.0 + PRUNE * out_bits)
    sort = C_NK * n * buckets + C_N2 * n * n * (1.0 + BETA * buckets)
    return PSUArea(popcount=pc, sort=sort)


def _sort_payload_bits(n: int, width: int) -> int:
    """Bits moved per element by a comparator network sorting (key, index)."""
    key_bits = max(1, math.ceil(math.log2(width + 1)))  # popcount key
    idx_bits = max(1, math.ceil(math.log2(n)))
    return key_bits + idx_bits


def bitonic_area(n: int, width: int = 8) -> PSUArea:
    """Batcher bitonic sorting network [10] on popcount keys.

    Compare-exchange count for n padded to a power of two:
    (n/4) * log2(n) * (log2(n)+1); each CE = key comparator + two payload
    muxes; pipeline registers at every stage (same pipeline depth as PSU
    per the paper's synthesis setup).
    """
    n_pad = 1 << max(1, math.ceil(math.log2(n)))
    stages = int(math.log2(n_pad))
    n_ce = n_pad * stages * (stages + 1) // 4
    bits = _sort_payload_bits(n, width)
    ce_area = _FA_AREA * bits + 2 * _MUX_BIT * bits
    reg_area = stages * (stages + 1) // 2 * n_pad * bits * _DFF_BIT * 0.5
    pc = A_PC * n * (1.0 + PRUNE * max(1, math.ceil(math.log2(width + 1))))
    return PSUArea(popcount=pc, sort=n_ce * ce_area + reg_area)


def csn_area(n: int, width: int = 8) -> PSUArea:
    """Competition Sorter Network [11][12]: O(1)-time, ~80 % more logic
    elements than bitonic (paper §II)."""
    b = bitonic_area(n, width)
    return PSUArea(popcount=b.popcount, sort=b.sort * 1.8)


def codec_area(scheme: str, lanes: int, partition: int | None = None) -> float:
    """Encoder area of one link codec over a ``lanes``-byte flit (um^2).

    Gate-count closed forms from the same 22 nm equivalents as the
    comparator baselines (DESIGN.md §11):

      * ``gray``           — 7 XOR per byte (top bit passes through).
      * ``sign_magnitude`` — conditional two's-complement negate per byte:
        an 8-bit ripple increment plus sign-controlled inversion muxes.
      * ``transition``     — XOR per wire bit plus the previous-flit
        register the feedback needs.
      * ``bus_invert``     — per partition of ``partition`` lanes (None =
        whole flit): popcount tree over the group bits (~1 FA/bit),
        majority comparator (log2 of the group width), inversion XORs and
        the previous-wire register, plus the invert-line driver flop.
    """
    bits = 8 * lanes
    if scheme == "none":
        return 0.0
    if scheme == "gray":
        return 7.0 * lanes * _XOR_BIT
    if scheme == "sign_magnitude":
        return lanes * (8 * _FA_AREA + 8 * _MUX_BIT)
    if scheme == "transition":
        return bits * (_XOR_BIT + _DFF_BIT)
    if scheme == "bus_invert":
        from .coding import bus_invert_partitions  # the one partition home

        npart, pw = bus_invert_partitions(lanes, partition)
        group_bits = 8 * pw
        per_group = (
            group_bits * (_FA_AREA + _XOR_BIT + _DFF_BIT)  # tree+inv+reg
            + math.ceil(math.log2(group_bits)) * _FA_AREA  # majority cmp
            + _DFF_BIT  # invert-line flop
        )
        return npart * per_group
    raise ValueError(f"unknown codec scheme {scheme!r} for the area model")


# --------------------------------------------------------------------------
# timing model (paper targets 500 MHz, "same pipeline depth" for all designs)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PSUTiming:
    """Pipelined sorting-unit timing at the paper's 500 MHz clock."""

    latency_cycles: int  # input-to-first-index latency
    throughput_elems_per_cycle: float
    clock_mhz: float = 500.0

    @property
    def latency_ns(self) -> float:
        return self.latency_cycles / self.clock_mhz * 1e3

    def sort_time_ns(self, n: int) -> float:
        return (self.latency_cycles + n / self.throughput_elems_per_cycle) \
            / self.clock_mhz * 1e3


def psu_timing(n: int, width: int = 8, k: int | None = None) -> PSUTiming:
    """Comparison-free PSU: O(N) single-pass — popcount (1 cycle), one-hot +
    histogram accumulate (streamed, 1 elem/cycle), prefix sum over K buckets
    (log2 K cycles), scatter (streamed).  APP's narrower bucket index
    shortens the prefix stage (k=4: 2 cycles vs 4 for exact W=8)."""
    buckets = (width + 1) if k is None else k
    prefix = max(1, math.ceil(math.log2(buckets)))
    # stages: popcount(1) + encode(1) + prefix(log2 K) + scatter(1)
    return PSUTiming(latency_cycles=3 + prefix, throughput_elems_per_cycle=1.0)


def bitonic_timing(n: int) -> PSUTiming:
    """Batcher network: log2(n)*(log2(n)+1)/2 pipelined compare stages."""
    n_pad = 1 << max(1, math.ceil(math.log2(n)))
    s = int(math.log2(n_pad))
    return PSUTiming(latency_cycles=s * (s + 1) // 2, throughput_elems_per_cycle=float(n))
