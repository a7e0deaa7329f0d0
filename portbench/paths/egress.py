"""Gradient egress: one whole gradient snapshot through the port's egress
path, as ``chip_smoke.py`` phase 3d drives it.

A step quantizes the float32 gradient to int8 by blocks
(``kernels.quantize_egress``), derives the static packet permutation from
the weights' int8 view (``traffic.int8_view`` + ``traffic.egress_permutation``),
applies it to the wire (``torch.index_select``: the benchmark's own op, as
``optim.compress.compressed_psum`` applies it) and counts the exact BT of
both 16-lane flit streams (``link.tensor_flit_stream`` + ``kernels.bt_count``
in chunks of at most ``bt_chunk_rows`` rows, so no int32 count can wrap).
The answer, on the host once the step ends, is (BT before, BT after).
"""

from __future__ import annotations

import torch

from repro_torch import kernels, link, traffic

from ..compare import differ
from ..reference import wire

# each layer of the port this path drives, and the ranges its calls run in
LAYERS = {
    "quantize": ("quantize",),
    "egress_permutation": ("int8_view", "egress_permutation"),
    "bt_count": ("bt_count",),
}


def work(m: int, mix: dict) -> dict[str, tuple[int, int]]:
    """(bytes, integer operations) of one step, per layer, from shapes alone:
    each input byte read once and each output byte written once."""
    block, lanes = mix["quantizer_block"], mix["lanes"]
    mp = -(-m // block) * block
    flits = m // lanes
    return {
        # 4 bytes in, 1 code out per element and one float32 scale per block
        "quantize": (4 * m + mp + 4 * (mp // block), 8 * m),
        # the float32 weights in; int32 perm and inverse out
        "egress_permutation": (4 * m + 8 * m, 8 * m),
        # the wire before and after the permutation, read once each
        "bt_count": (2 * flits * lanes, 2 * 3 * max(flits - 1, 0) * lanes),
    }


def _bt_parts(stream: torch.Tensor, rows: int) -> list[torch.Tensor]:
    """int32 BT of row chunks of at most ``rows`` rows, overlapping by one."""
    return [kernels.bt_count(stream[r0: r0 + rows + 1])
            for r0 in range(0, max(stream.shape[0] - 1, 0), rows)]


def step(snap: dict, mix: dict, span) -> tuple[tuple[int, int], dict]:
    """One measurement: the answer (BT before, BT after) and the device
    outputs the check compares."""
    g, w = snap["grad"], snap["weights"]
    m = g.shape[0]
    with span("quantize"):
        codes, scales, _ = kernels.quantize_egress(g, block=mix["quantizer_block"])
    with span("int8_view"):
        w8 = traffic.int8_view(w)
    with span("egress_permutation"):
        perm, inv = traffic.egress_permutation(
            w8, packet=mix["packet"], strategy=mix["strategy"], k=mix["k"])
    del w8
    sent = codes[:m]
    with span("index_select"):
        permuted = torch.index_select(sent, 0, perm)
    with span("bt_count"):
        totals = []
        for x in (sent, permuted):
            parts = _bt_parts(link.tensor_flit_stream(x.view(torch.uint8), mix["lanes"]),
                              mix["bt_chunk_rows"])
            totals.append(torch.stack(parts).to(torch.int64).sum() if parts
                          else torch.zeros((), dtype=torch.int64, device=g.device))
        answer = tuple(torch.stack(totals).tolist())
    return answer, {"codes": codes, "scales": scales, "perm": perm, "inv": inv}


def reference(snap: dict, mix: dict, kept: dict | None) -> tuple[tuple[int, int], dict]:
    """The reference's answer for one snapshot and, where ``kept`` holds
    the program's outputs for it, the counts of its elements that differ."""
    g, w = snap["grad"], snap["weights"]
    m, packet, lanes = g.shape[0], mix["packet"], mix["lanes"]
    levels = 9 if mix["strategy"] == "acc" else mix["k"]
    codes, scales = wire.quantize(g, mix["quantizer_block"])
    sent = codes[:m].view(torch.uint8)
    w8 = wire.int8_view(w).view(torch.uint8)
    usable = (m // packet) * packet
    permuted = sent.clone()  # a tail shorter than a packet stays in place
    counts = {}
    if kept is not None:
        counts = {"codes_differ": differ(kept["codes"], codes),
                  "scales_differ": differ(kept["scales"], scales),
                  # elements past the m due; the blocks below count the rest
                  "perm_differ": max(kept["perm"].shape[0] - m, 0),
                  "inv_differ": max(kept["inv"].shape[0] - m, 0)}
    idx = torch.arange(packet, device=g.device)
    for p0 in range(0, usable // packet, wire.PACKETS):
        pk = w8[p0 * packet: usable].reshape(-1, packet)[: wire.PACKETS]
        a, b = p0 * packet, p0 * packet + pk.numel()
        order = wire.packet_order(pk, levels)
        base = (torch.arange(pk.shape[0], device=g.device)[:, None] + p0) * packet
        perm = (order + base).reshape(-1)
        permuted[a:b] = sent[perm]
        if kept is not None:
            inv = torch.empty_like(order).scatter_(1, order, idx.expand_as(order)) + base
            counts["perm_differ"] += differ(kept["perm"][a:b], perm)
            counts["inv_differ"] += differ(kept["inv"][a:b], inv.reshape(-1))
    if kept is not None and usable < m:
        tail = torch.arange(usable, m, device=g.device)
        counts["perm_differ"] += differ(kept["perm"][usable:m], tail)
        counts["inv_differ"] += differ(kept["inv"][usable:m], tail)
    t = m // lanes
    answer = (wire.bt(sent[: t * lanes].view(t, lanes)),
              wire.bt(permuted[: t * lanes].view(t, lanes)))
    return answer, counts

