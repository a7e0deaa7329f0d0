# The NoC interconnect subsystem (counterpart of repro.noc): the paper's
# sorting unit inside a multi-router fabric (DESIGN.md §9, §17).  Every hop
# of a route pays switching power, so per-link BT is the fabric metric; the
# whole fabric is measured by ONE repro_torch.kernels.bt_count_links call
# over its distinct link queues.
#   topology.py - mesh / torus / ring builders + directed link tables
#   routing.py  - deterministic XY / shortest-wrap routing, multicast
#                 trees, and the compiled FabricPlan queue tables
#   fabric.py   - batched device-side expansion: FlowBatch -> per-queue
#                 wire streams (link stages + codecs over the queue batch)
#   simulate.py - flows -> fabric streams -> batched BT / energy report
#   latency.py  - wormhole serialization + merge-point contention model
#   power.py    - per-hop energy: link wire model + router flit overhead
#   adapters.py - real workloads (conv platform, decode weights, gradient
#                 all-reduce, MoE dispatch, fleet decode) as NoC flows
from .adapters import (
    conv_platform_flows,
    decode_weight_flows,
    fleet_decode_flows,
    moe_dispatch_flows,
    packetize,
    ring_allreduce_flows,
)
from .fabric import FabricStreams, FlowBatch, expand_fabric
from .latency import (
    FabricLatency,
    FlowLatency,
    LinkContention,
    NocLatencyModel,
    fabric_latency,
    route_latency_cycles,
    route_latency_ns,
)
from .power import NocPowerModel
from .routing import (
    FabricPlan,
    compile_fabric,
    hop_count,
    multicast_links,
    route,
    unicast_links,
)
from .simulate import (
    LinkStats,
    LinkStreams,
    NocReport,
    TrafficFlow,
    expand_link_streams,
    fabric_to_link_streams,
    simulate_noc,
    stack_link_streams,
)
from .topology import Topology, mesh, ring, torus

__all__ = [
    "Topology",
    "mesh",
    "torus",
    "ring",
    "route",
    "unicast_links",
    "multicast_links",
    "hop_count",
    "FabricPlan",
    "compile_fabric",
    "FlowBatch",
    "FabricStreams",
    "expand_fabric",
    "TrafficFlow",
    "LinkStats",
    "LinkStreams",
    "NocReport",
    "expand_link_streams",
    "fabric_to_link_streams",
    "stack_link_streams",
    "simulate_noc",
    "NocLatencyModel",
    "LinkContention",
    "FlowLatency",
    "FabricLatency",
    "fabric_latency",
    "route_latency_cycles",
    "route_latency_ns",
    "NocPowerModel",
    "packetize",
    "conv_platform_flows",
    "decode_weight_flows",
    "fleet_decode_flows",
    "ring_allreduce_flows",
    "moe_dispatch_flows",
]
