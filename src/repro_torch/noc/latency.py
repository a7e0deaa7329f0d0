"""Hop-contention / queueing latency model (DESIGN.md §17).

Counterpart of ``repro.noc.latency`` (pure Python, evaluated on the host).

The BT accounting answers "how much do the wires switch"; this module
answers "how long does the traffic take".  It is a deterministic analytical
wormhole model evaluated host-side over a :class:`~repro_torch.noc.routing.
FabricPlan`'s queue tables — no event simulation, so a 16x16 fleet costs
microseconds and the numbers are exactly reproducible for the DSE plane:

  * serialization — a link transmits ``link_cycles`` per flit, so a flow's
    body pipelines ``link_cycles * (flits - 1)`` behind its head;
  * per-hop traversal — the head pays ``router_cycles + link_cycles`` at
    every hop of its XY route;
  * merge-point contention — flows queued on the same link transmit in
    injection order (the order the plan's queue tables record, which is
    also the order the expansion concatenates wire streams in): a flow
    waits ``link_cycles * (flits queued ahead of it)`` at each contended
    link.

A flow's latency is the max over its destinations of the per-destination
path latency; a link's drain latency is the time to forward its whole
queue.  Contended links (>= 2 merged flows) fire a ``noc.contend`` probe
event so the observability layer can rank merge hot-spots next to the BT
hot links.

:func:`route_latency_ns` is the single-flow special case the DSE uses to
price a design point's topology choice (one workload tenure crossing the
grid) — the AREA_BT_LATENCY Pareto plane ranks on it via
``Evaluation.total_latency_ns``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

from .. import _obs_hooks as _obs

from .routing import FabricPlan, unicast_links

__all__ = [
    "NocLatencyModel",
    "LinkContention",
    "FlowLatency",
    "FabricLatency",
    "route_latency_cycles",
    "route_latency_ns",
    "fabric_latency",
]


@dataclasses.dataclass(frozen=True)
class NocLatencyModel:
    """Cycle-level NoC timing constants.

    Defaults follow the same 28nm-class operating point as
    ``NocPowerModel``: a 500 MHz fabric clock, a 3-cycle router pipeline
    (buffer write / route+arbitrate / crossbar) and single-cycle link
    traversal at one flit per cycle.
    """

    clock_ghz: float = 0.5
    router_cycles: int = 3
    link_cycles: int = 1

    def __post_init__(self) -> None:
        if self.clock_ghz <= 0:
            raise ValueError(f"clock_ghz must be > 0, got {self.clock_ghz}")
        if self.router_cycles < 0 or self.link_cycles < 1:
            raise ValueError(
                "need router_cycles >= 0 and link_cycles >= 1, got "
                f"{self.router_cycles}/{self.link_cycles}"
            )

    @property
    def cycle_ns(self) -> float:
        return 1.0 / self.clock_ghz

    def ns(self, cycles: int) -> float:
        return float(cycles) * self.cycle_ns


class LinkContention(NamedTuple):
    """One directed link's occupancy / contention accounting."""

    link: int
    src: int
    dst: int
    flows: int  # flows merged onto this link
    flits: int  # total flits forwarded (serialization occupancy)
    wait_cycles: int  # aggregate injection-order queueing delay
    busy_ns: float  # serialization time: link_cycles * flits
    drain_ns: float  # router traversal + full queue serialization


class FlowLatency(NamedTuple):
    """One flow's delivery latency (max over its destinations)."""

    flow: int
    hops: int  # XY hops to the latency-critical destination
    flits: int
    wait_cycles: int  # contention stalls along the critical path
    cycles: int
    latency_ns: float


class FabricLatency(NamedTuple):
    """The whole fabric's latency picture: per-link and per-flow rows."""

    links: tuple[LinkContention, ...]
    flows: tuple[FlowLatency, ...]
    model: NocLatencyModel

    @property
    def max_latency_ns(self) -> float:
        return max((f.latency_ns for f in self.flows), default=0.0)

    @property
    def mean_latency_ns(self) -> float:
        return (
            sum(f.latency_ns for f in self.flows) / len(self.flows)
            if self.flows
            else 0.0
        )

    @property
    def total_wait_cycles(self) -> int:
        return sum(l.wait_cycles for l in self.links)

    @property
    def contended_links(self) -> int:
        return sum(1 for l in self.links if l.flows >= 2)


def route_latency_cycles(
    hops: int, flits: int, model: NocLatencyModel = NocLatencyModel()
) -> int:
    """Uncontended wormhole traversal of one route: the head flit pays
    router + link at every hop, the body pipelines one link behind."""
    if hops <= 0 or flits <= 0:
        return 0
    head = hops * (model.router_cycles + model.link_cycles)
    return head + model.link_cycles * (flits - 1)


def route_latency_ns(
    hops: int, flits: int, model: NocLatencyModel = NocLatencyModel()
) -> float:
    return model.ns(route_latency_cycles(hops, flits, model))


def fabric_latency(
    plan: FabricPlan,
    flits_per_flow: Sequence[int],
    model: NocLatencyModel = NocLatencyModel(),
) -> FabricLatency:
    """Evaluate the contention model over a compiled fabric plan.

    ``flits_per_flow[f]`` is flow f's flit count (packets x
    flits_per_packet).  Fires one ``noc.contend`` probe event per link
    that merges >= 2 flows.
    """
    flits_per_flow = tuple(int(v) for v in flits_per_flow)
    if len(flits_per_flow) != plan.num_flows:
        raise ValueError(
            f"{len(flits_per_flow)} flit counts for {plan.num_flows} flows"
        )
    topo = plan.topo
    # per active link: queue occupancy + each member flow's head-of-line wait
    wait_at: dict[int, dict[int, int]] = {}
    links: list[LinkContention] = []
    for lid, qi in zip(plan.link_ids, plan.link_queue):
        queue = plan.queues[qi]
        ahead = 0
        waits: dict[int, int] = {}
        for f in queue:
            waits[f] = model.link_cycles * ahead
            ahead += flits_per_flow[f]
        wait_at[lid] = waits
        u, v = topo.links[lid]
        total_wait = sum(waits.values())
        links.append(
            LinkContention(
                link=lid,
                src=u,
                dst=v,
                flows=len(queue),
                flits=ahead,
                wait_cycles=total_wait,
                busy_ns=model.ns(model.link_cycles * ahead),
                drain_ns=model.ns(
                    model.router_cycles + model.link_cycles * ahead
                ),
            )
        )
        if len(queue) >= 2 and _obs.active():
            _obs.event(
                "noc.contend", link=lid, src=u, dst=v, flows=len(queue),
                flits=ahead, wait_cycles=total_wait,
            )
    # per flow: worst destination's path latency under those waits
    flows: list[FlowLatency] = []
    for fi, (src, dsts) in enumerate(plan.endpoints):
        flits = flits_per_flow[fi]
        best = (0, 0, 0)  # (cycles, hops, wait)
        for dst in dsts:
            if dst == src:
                continue
            path = unicast_links(topo, src, dst)
            wait = sum(wait_at[lid].get(fi, 0) for lid in path)
            cycles = (
                route_latency_cycles(len(path), flits, model) + wait
            )
            if cycles > best[0]:
                best = (cycles, len(path), wait)
        cycles, hops, wait = best
        flows.append(
            FlowLatency(
                flow=fi,
                hops=hops,
                flits=flits,
                wait_cycles=wait,
                cycles=cycles,
                latency_ns=model.ns(cycles),
            )
        )
    return FabricLatency(tuple(links), tuple(flows), model)
