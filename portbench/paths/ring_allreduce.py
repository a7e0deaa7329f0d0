"""Ring all-reduce: one reduce-scatter step of a whole gradient snapshot's
int8 wire on a ring, measured by the port's NoC fabric, as
``chip_smoke.py`` phase 3e (d) drives it.

A step quantizes the float32 gradient (``kernels.quantize_egress``),
shards its wire into ``routers`` flows of ``packet``-byte packets, shard i
from router i to router i + 1 (``noc.ring_allreduce_flows`` on
``noc.ring``), and runs ``noc.simulate_noc`` once under each ordering key
with the sorting unit at the source, on an input-only ``lanes``-byte flit.
The answer, on the host once the step ends, is each key's per-link rows
(src, dst, input BT, weight BT, flits).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import kernels, link, noc

from ..compare import differ
from ..reference import wire

LAYERS = {
    "quantize": ("quantize",),
    "noc_fabric": ("simulate_noc",),
}


def work(m: int, mix: dict) -> dict[str, tuple[int, int]]:
    """(bytes, integer operations) of one step, per layer, from shapes alone."""
    block, packet = mix["quantizer_block"], mix["packet"]
    mp = -(-m // block) * block
    sent = (m // packet) * packet
    # a fabric reads the wire once per key: per byte ~3 operations to count
    # its transitions, and ~4 more to key, rank and place it where it sorts
    ops = sum(3 + (4 if key in ("acc", "app") else 0) for key in mix["keys"]) * sent
    return {
        "quantize": (4 * m + mp + 4 * (mp // block), 8 * m),
        "noc_fabric": (len(mix["keys"]) * sent, ops),
    }


def _spec(mix: dict) -> link.LinkSpec:
    lanes = mix["lanes"]
    return link.LinkSpec(width_bits=8 * lanes, flits_per_packet=mix["packet"] // lanes,
                         input_lanes=lanes, weight_lanes=0, k=mix["k"])


def step(snap: dict, mix: dict, span) -> tuple[tuple, dict]:
    """One measurement: the answer (each key's link rows) and the device
    outputs the check compares."""
    g = snap["grad"]
    with span("quantize"):
        codes, scales, _ = kernels.quantize_egress(g, block=mix["quantizer_block"])
    spec = _spec(mix)
    with span("ring_flows"):
        topo = noc.ring(mix["routers"])
        flows = noc.ring_allreduce_flows(codes[: g.shape[0]], topo, spec=spec)
    answer = []
    for key in mix["keys"]:
        with span("simulate_noc"):
            rep = noc.simulate_noc(topo, flows, dataclasses.replace(spec, key=key),
                                   sort_at=mix["sort_at"])
        answer.append((key, tuple(sorted(
            (s.src, s.dst, s.bt_input, s.bt_weight, s.num_flits) for s in rep.links))))
    return tuple(answer), {"codes": codes, "scales": scales}


def _link_bt(packets: torch.Tensor, key: str, mix: dict) -> int:
    """BT of one link carrying ``packets`` in order, each packet's bytes in
    the source's order for ``key`` and laid out lane by lane: flit f, lane
    l carries byte l * F + f of its packet."""
    lanes = mix["lanes"]
    f = packets.shape[1] // lanes
    total, prev = 0, None
    for a in range(0, packets.shape[0], wire.PACKETS):
        pk = packets[a: a + wire.PACKETS]
        if key in ("acc", "app"):
            pk = torch.gather(pk, 1, wire.packet_order(pk, 9 if key == "acc" else mix["k"]))
        flits = pk.reshape(-1, lanes, f).transpose(1, 2).reshape(-1, lanes)
        total += wire.bt(flits, prev)
        prev = flits[-1]
    return total


def reference(snap: dict, mix: dict, kept: dict | None) -> tuple[tuple, dict]:
    """The reference's answer for one snapshot and, where ``kept`` holds
    the program's outputs for it, the counts of its elements that differ."""
    g = snap["grad"]
    m, packet, routers = g.shape[0], mix["packet"], mix["routers"]
    codes, scales = wire.quantize(g, mix["quantizer_block"])
    counts = {}
    if kept is not None:
        counts = {"codes_differ": differ(kept["codes"], codes),
                  "scales_differ": differ(kept["scales"], scales)}
    pk = codes[: (m // packet) * packet].view(torch.uint8).reshape(-1, packet)
    shard = max(pk.shape[0] // routers, 1)
    flits = packet // mix["lanes"]
    answer = []
    for key in mix["keys"]:
        rows = []
        for i in range(routers):
            lo = min(i * shard, pk.shape[0])
            hi = pk.shape[0] if i == routers - 1 else min(lo + shard, pk.shape[0])
            if hi > lo:
                rows.append((i, (i + 1) % routers, _link_bt(pk[lo:hi], key, mix), 0,
                             (hi - lo) * flits))
        answer.append((key, tuple(sorted(rows))))
    return tuple(answer), counts

