"""Link framing: packing packet payloads into flit streams (DESIGN.md §1).

Counterpart of ``repro.link.framing``.  The paper's platform sends packets
over a 128-bit link: 4 flits per packet, each flit 8 input bytes and 8
paired weight bytes.  Asymmetric framings (``input_lanes !=
weight_lanes``) frame the weight side in its native order.
"""

from __future__ import annotations

import torch

from ..core.bt import BTReport, bt_report
from .spec import LinkSpec
from .stages import PACK_STAGES, lookup_stage, make_order

__all__ = [
    "pack_to_flits",
    "unpack_from_flits",
    "assemble_stream",
    "paired_stream",
    "measure",
]

def pack_to_flits(values: torch.Tensor, lanes: int, pack: str = "lane") -> torch.Tensor:
    """Pack (P, N) packet payloads into (P, flits, lanes) flit halves.

    ``pack="lane"`` puts element e of a packet at flit e % F, lane e // F
    (the PSU's packing, paper Fig. 2); ``pack="row"`` is row-major.
    """
    stage = lookup_stage("pack", pack, PACK_STAGES)
    if stage.per_packet is None:
        raise ValueError(
            f"pack stage {pack!r} is a stream-only layout; per-packet "
            "framing uses 'row' or 'lane'"
        )
    return stage.per_packet(values, lanes)


def unpack_from_flits(flits: torch.Tensor, pack: str = "lane") -> torch.Tensor:
    """Inverse of :func:`pack_to_flits`: (P, F, lanes) back to (P, N)."""
    lookup_stage("pack", pack, PACK_STAGES)
    p, f, lanes = flits.shape
    if pack == "row":
        return flits.reshape(p, f * lanes)
    if pack == "lane":
        return flits.transpose(1, 2).reshape(p, f * lanes)
    raise ValueError(
        f"pack stage {pack!r} is a stream-only layout; per-packet "
        "framing uses 'row' or 'lane'"
    )


def _validate_paired(inputs: torch.Tensor, weights: torch.Tensor, cfg: LinkSpec) -> None:
    if inputs.shape[-1] != cfg.elems_per_packet:
        raise ValueError(
            f"packet payload {inputs.shape[-1]} != "
            f"flits*input_lanes = {cfg.elems_per_packet}"
        )
    if inputs.shape[:-1] != weights.shape[:-1]:
        raise ValueError(
            f"paired batch shapes differ: {tuple(inputs.shape)} vs {tuple(weights.shape)}"
        )
    if weights.shape[-1] != cfg.weight_elems_per_packet:
        raise ValueError(
            f"weight payload {weights.shape[-1]} != "
            f"flits*weight_lanes = {cfg.weight_elems_per_packet} "
            f"(input_lanes={cfg.input_lanes}, weight_lanes={cfg.weight_lanes})"
        )


def assemble_stream(
    inputs: torch.Tensor,
    weights: torch.Tensor | None,
    cfg: LinkSpec,
    order: torch.Tensor | None,
    pack: str = "lane",
) -> torch.Tensor:
    """Apply ``order``, pack both halves per flit, flatten to (T, bytes) uint8.

    The input-derived order moves the weights along only for the symmetric
    framing (same element count per side).
    """
    idx = None if order is None else order.to(torch.int64)
    inp = inputs if idx is None else torch.gather(inputs, -1, idx)
    fi = pack_to_flits(inp, cfg.input_lanes, pack)
    if weights is None or cfg.weight_lanes == 0:
        return fi.reshape(-1, cfg.input_lanes).to(torch.uint8)
    if idx is not None and weights.shape == inputs.shape:
        weights = torch.gather(weights, -1, idx)
    fw = pack_to_flits(weights, cfg.weight_lanes, pack)
    flits = torch.cat([fi.to(torch.uint8), fw.to(torch.uint8)], dim=-1)
    return flits.reshape(-1, cfg.bytes_per_flit)


def paired_stream(
    inputs: torch.Tensor,
    weights: torch.Tensor,
    cfg: LinkSpec = LinkSpec(),
    strategy: str = "none",
    pack: str = "lane",
    **order_kwargs: object,
) -> torch.Tensor:
    """The full (P*F, bytes_per_flit) uint8 link stream of P packet pairs
    under one ordering strategy (derived from the input side)."""
    _validate_paired(inputs, weights, cfg)
    order = make_order(strategy, inputs, lanes=cfg.input_lanes, **order_kwargs)
    return assemble_stream(inputs, weights, cfg, order, pack)


def measure(
    inputs: torch.Tensor,
    weights: torch.Tensor,
    cfg: LinkSpec = LinkSpec(),
    strategy: str = "none",
    pack: str = "lane",
    **order_kwargs: object,
) -> BTReport:
    """One-call Table-I measurement for a strategy (legacy API; new code
    uses ``TxPipeline.measure``)."""
    stream = paired_stream(inputs, weights, cfg, strategy, pack, **order_kwargs)
    return bt_report(stream, cfg.input_lanes)
