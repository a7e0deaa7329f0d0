"""Traffic adapters: real workload tensors -> NoC flows.

Counterpart of ``repro.noc.adapters``, on the port's ``tensor_flit_stream``
and ``int8_view``.  Workload families mapped onto fabric traffic patterns
(DESIGN.md §9, §17):

  * **Conv platform** (paper §IV-B): the allocation unit scatters im2col
    patch packets from a memory router to the PE routers (unicast each),
    with the convolution kernel bytes riding the paired weight lanes;
  * **Decode weight streams**: a weight matrix's int8 image multicast from
    the memory-controller router to a row of PEs;
  * **Gradient all-reduce**: the int8 gradient wire image sharded over the
    routers of a ring, each shard hopping to the next router;
  * **Fleet decode**: users x layers x shards multicast weight flows on a
    large grid, the merge-heavy traffic the contention model prices;
  * **MoE dispatch**: each expert's capacity buffer unicast to its router.

Adapters only build ``TrafficFlow``s on the payload's own device;
ordering/packing/measuring stay in :mod:`repro_torch.noc.simulate`.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..link import LinkSpec, tensor_flit_stream
from ..traffic.ordering import int8_view

from .simulate import TrafficFlow
from .topology import Topology

__all__ = [
    "packetize",
    "conv_platform_flows",
    "decode_weight_flows",
    "fleet_decode_flows",
    "ring_allreduce_flows",
    "moe_dispatch_flows",
]


def _wire_bytes(x: torch.Tensor) -> torch.Tensor:
    """A tensor's int8 wire image as flat uint8 bytes.

    int8/uint8 inputs ARE already their wire image and pass through
    untouched (int8 as a view of its bytes) — re-quantizing them would
    rescale the bytes and distort the measured distribution.
    """
    if x.dtype == torch.uint8:
        return x.reshape(-1)
    if x.dtype == torch.int8:
        return x.reshape(-1).view(torch.uint8)
    return int8_view(x).reshape(-1).view(torch.uint8)


def packetize(data: torch.Tensor, elems: int) -> torch.Tensor:
    """Flatten a byte tensor and shape it into (P, elems) packets (trimmed
    to whole packets; a NoC flow transmits complete packets only)."""
    flat = data.reshape(-1)
    if flat.dtype == torch.int8:
        flat = flat.view(torch.uint8)
    pkts = tensor_flit_stream(flat.to(torch.uint8), elems)
    if pkts.shape[0] == 0:
        raise ValueError(
            f"payload of {data.numel()} bytes is smaller than one "
            f"{elems}-byte packet"
        )
    return pkts


def conv_platform_flows(
    patches: torch.Tensor,
    kernel_bytes: torch.Tensor,
    topo: Topology,
    src: int,
    pe_routers: Sequence[int],
    spec: LinkSpec = LinkSpec(),
) -> list[TrafficFlow]:
    """Scatter conv input packets to PE routers, kernels on the weight lanes.

    ``patches`` is the (num_patches, window) im2col byte matrix of one
    image; ``kernel_bytes`` one output channel's flattened kernel.  Packets
    are dealt round-robin over ``pe_routers``; when the spec has weight
    lanes each packet pairs with the cyclically-tiled kernel bytes.
    """
    topo.coords(src)  # validates the router id
    pkts = packetize(patches, spec.elems_per_packet)
    p = pkts.shape[0]
    if spec.weight_lanes:
        kb = kernel_bytes.reshape(-1).to(torch.uint8)
        need = p * spec.weight_elems_per_packet
        wrep = kb.repeat(need // kb.numel() + 1)[:need].reshape(p, -1)
    flows = []
    for i, pe in enumerate(pe_routers):
        sel = torch.arange(i, p, len(pe_routers), device=pkts.device)
        if sel.shape[0] == 0:
            continue
        flows.append(
            TrafficFlow(
                name=f"conv/pe{pe}",
                src=src,
                dsts=(pe,),
                inputs=pkts.index_select(0, sel),
                weights=wrep.index_select(0, sel) if spec.weight_lanes else None,
            )
        )
    return flows


def decode_weight_flows(
    weight: torch.Tensor,
    topo: Topology,
    src: int,
    dsts: Sequence[int],
    spec: LinkSpec = LinkSpec(),
    max_packets: int | None = None,
) -> list[TrafficFlow]:
    """Multicast a weight matrix's int8 HBM stream to a set of PE routers.

    The matrix is quantized to its int8 wire image, the row-major byte
    stream is packetized, and ONE multicast flow carries it down the XY
    tree.  Input-only specs model the dedicated weight-distribution channel.
    """
    if spec.weight_lanes:
        raise ValueError(
            "decode weight streams are a one-sided broadcast; use an "
            "input-only spec (weight_lanes=0)"
        )
    topo.coords(src)  # validates the router id
    pkts = packetize(_wire_bytes(weight), spec.elems_per_packet)
    if max_packets is not None:
        pkts = pkts[:max_packets]
    return [TrafficFlow(name="decode/weights", src=src, dsts=tuple(dsts), inputs=pkts)]


def fleet_decode_flows(
    weights: torch.Tensor,
    topo: Topology,
    *,
    users: int,
    layers: int,
    shards: int,
    spec: LinkSpec = LinkSpec(input_lanes=16, weight_lanes=0),
    packets_per_flow: int = 2,
) -> list[TrafficFlow]:
    """Multi-tenant decode weight traffic: users x layers x shards flows.

    Tenant ``u`` is pinned to grid row ``u % rows`` — its memory-controller
    router sits at column 0 and its PEs are the remaining routers of the
    row.  For every decode layer ``l``, weight shard ``s`` multicasts from
    the tenant's memory router to the ``s``-th contiguous group of the
    row's PE columns, so flows of co-located tenants and of every layer
    merge on the row's column-0 egress links.  Payloads are deterministic
    strided slices of ``weights``'s int8 wire image (tiled if the tensor is
    smaller than one flow).
    """
    if spec.weight_lanes:
        raise ValueError(
            "fleet decode traffic is a one-sided broadcast; use an "
            "input-only spec (weight_lanes=0)"
        )
    if users < 1 or layers < 1 or shards < 1:
        raise ValueError(
            f"need users/layers/shards >= 1, got {users}/{layers}/{shards}"
        )
    if packets_per_flow < 1:
        raise ValueError(f"packets_per_flow must be >= 1, got {packets_per_flow}")
    pe_cols = topo.cols - 1
    if pe_cols < shards:
        raise ValueError(
            f"{shards} shards need {shards} PE columns; a {topo.rows}x"
            f"{topo.cols} grid has {pe_cols} (column 0 is the memory router)"
        )
    data = _wire_bytes(weights)
    need = packets_per_flow * spec.elems_per_packet
    if int(data.numel()) < need:
        data = data.repeat(-(-need // int(data.numel())))
    span = int(data.numel()) - need  # highest valid slice start
    flows = []
    for u in range(users):
        row = u % topo.rows
        mem = topo.router(row, 0)
        for layer in range(layers):
            for s in range(shards):
                lo = s * pe_cols // shards
                hi = (s + 1) * pe_cols // shards
                dsts = tuple(topo.router(row, 1 + c) for c in range(lo, hi))
                fi = (u * layers + layer) * shards + s
                # coprime stride walks the wire image without re-slicing
                # the same window for co-located tenants
                off = 0 if span == 0 else (fi * 7919) % (span + 1)
                flows.append(
                    TrafficFlow(
                        name=f"u{u}/l{layer}/s{s}",
                        src=mem,
                        dsts=dsts,
                        inputs=data[off: off + need].reshape(
                            packets_per_flow, spec.elems_per_packet
                        ),
                    )
                )
    return flows


def ring_allreduce_flows(
    grad: torch.Tensor,
    topo: Topology,
    routers: Sequence[int] | None = None,
    spec: LinkSpec = LinkSpec(),
) -> list[TrafficFlow]:
    """One ring reduce-scatter step of a gradient's int8 wire image.

    The flat gradient quantizes to int8 (an int8 or uint8 gradient is
    already its wire image), shards evenly over ``routers`` (default: every
    router, in id order — on a ring topology that is the physical cycle),
    and shard i flows from router i to its cyclic successor.  The shards
    are views of the packetized wire, not copies.
    """
    order = tuple(routers) if routers is not None else tuple(range(topo.num_routers))
    if len(order) < 2:
        raise ValueError("ring all-reduce needs >= 2 routers")
    if spec.weight_lanes:
        raise ValueError("gradient traffic is one-sided; use weight_lanes=0")
    pkts = packetize(_wire_bytes(grad), spec.elems_per_packet)
    shard = max(pkts.shape[0] // len(order), 1)
    flows = []
    for i, r in enumerate(order):
        lo = min(i * shard, pkts.shape[0])
        hi = pkts.shape[0] if i == len(order) - 1 else min(lo + shard, pkts.shape[0])
        if hi <= lo:
            continue
        flows.append(
            TrafficFlow(
                name=f"allreduce/shard{i}",
                src=r,
                dsts=(order[(i + 1) % len(order)],),
                inputs=pkts[lo:hi],
            )
        )
    return flows


def moe_dispatch_flows(
    expert_in: torch.Tensor,
    topo: Topology,
    src: int,
    expert_routers: Sequence[int],
    spec: LinkSpec = LinkSpec(),
) -> list[TrafficFlow]:
    """MoE dispatch: each expert's capacity buffer unicast to its router.

    ``expert_in`` is a (G, E, C, D) dispatched buffer (or its int8 wire
    image); expert e's slice ``expert_in[:, e]`` flows from the dispatch
    router ``src`` to ``expert_routers[e % len]``.  Tokens inside a
    capacity buffer are an unordered set, which is exactly the permutation
    freedom the paper's sorting unit exploits.
    """
    if spec.weight_lanes:
        raise ValueError("dispatch traffic is one-sided; use weight_lanes=0")
    if expert_in.dim() != 4:
        raise ValueError(
            f"expert_in must be (groups, experts, capacity, d_model), "
            f"got shape {tuple(expert_in.shape)}"
        )
    if not expert_routers:
        raise ValueError("moe dispatch needs >= 1 expert router")
    topo.coords(src)  # validates the router id
    flows = []
    for e in range(expert_in.shape[1]):
        data = _wire_bytes(expert_in[:, e].contiguous())
        if int(data.numel()) < spec.elems_per_packet:
            continue  # padded expert with an empty (sub-packet) buffer
        flows.append(
            TrafficFlow(
                name=f"moe/expert{e}",
                src=src,
                dsts=(expert_routers[e % len(expert_routers)],),
                inputs=packetize(data, spec.elems_per_packet),
            )
        )
    if not flows:
        raise ValueError(
            f"no expert buffer reaches one {spec.elems_per_packet}-byte "
            "packet; capture more tokens or shrink the packet"
        )
    return flows
