"""Deterministic routing and path expansion (DESIGN.md §9).

Counterpart of ``repro.noc.routing``, copied (pure Python; the reference
package loads JAX on import).  ``compile_fabric``'s queue order is the
reference's: links ascending, flows in injection order, distinct
compositions numbered in first-use order.

Dimension-order (XY) routing covers all three topology families: a packet
first corrects its column offset, then its row offset.  On a mesh each
dimension is walked monotonically; on a torus/ring each dimension picks the
shorter wrap direction (ties break toward +), which on a ring degenerates
to classic shortest-direction ring routing.  XY is deadlock-free on the
mesh and — more importantly here — *deterministic*, so a multicast to many
destinations is a tree: paths from one source share prefixes, and the
union of their links visits each physical link at most once (one copy of
the payload per link, the standard tree-multicast accounting).

``unicast_links`` / ``multicast_links`` expand route endpoints into the
ordered link-id lists the simulator schedules flit streams onto.

:func:`compile_fabric` runs the deterministic router ONCE for a whole set
of flow endpoints and freezes the result as a :class:`FabricPlan` — the
(flow x link) incidence and per-link queue tables the batched expansion
path (``repro_torch.noc.fabric``, DESIGN.md §17) and the contention model
(``repro_torch.noc.latency``) both read.  The plan is pure routing: payload
bytes never enter it, so one plan serves every spec / sort mode / payload
of the same traffic pattern.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from .topology import Topology

__all__ = [
    "route",
    "unicast_links",
    "multicast_links",
    "hop_count",
    "FabricPlan",
    "compile_fabric",
]


def _axis_step(pos: int, dst: int, size: int, wrap: bool) -> int:
    """Next coordinate along one dimension (monotone, or shortest wrap)."""
    if pos == dst:
        return pos
    if not wrap:
        return pos + (1 if dst > pos else -1)
    fwd = (dst - pos) % size
    back = (pos - dst) % size
    return (pos + (1 if fwd <= back else -1)) % size


def route(topo: Topology, src: int, dst: int) -> list[int]:
    """Router sequence from src to dst (inclusive) under XY routing."""
    r, c = topo.coords(src)
    dr, dc = topo.coords(dst)
    path = [src]
    while c != dc:
        c = _axis_step(c, dc, topo.cols, topo.wrap)
        path.append(topo.router(r, c))
    while r != dr:
        r = _axis_step(r, dr, topo.rows, topo.wrap)
        path.append(topo.router(r, c))
    return path


def hop_count(topo: Topology, src: int, dst: int) -> int:
    """Number of links the XY route crosses."""
    return len(route(topo, src, dst)) - 1


def unicast_links(topo: Topology, src: int, dst: int) -> list[int]:
    """Ordered link ids of the XY route src -> dst."""
    path = route(topo, src, dst)
    return [topo.link_id(u, v) for u, v in zip(path[:-1], path[1:])]


def multicast_links(topo: Topology, src: int, dsts: tuple[int, ...]) -> list[int]:
    """Link ids of the XY multicast tree from src to every destination.

    The union of the deterministic unicast routes, deduplicated in
    first-visit order: shared path prefixes (and on wrapped topologies the
    occasional shared interior segment) carry ONE copy of the payload — the
    whole point of tree multicast for broadcast-heavy weight traffic.
    """
    seen: dict[int, None] = {}
    for dst in dsts:
        if dst == src:
            continue
        for lid in unicast_links(topo, src, dst):
            seen.setdefault(lid, None)
    return list(seen)


@dataclasses.dataclass(frozen=True)
class FabricPlan:
    """Routing of a whole flow set, compiled once into queue tables.

    The plan captures everything the batched expansion needs that is NOT
    payload bytes:

      * ``link_ids``   — the active links, ascending (the row order of
        every per-link report, identical to the legacy expansion loop);
      * ``link_queue`` — per active link, the index of its *distinct
        queue*: links whose queued-flow composition is identical carry
        byte-identical streams, so they share one assembled/measured row
        (multicast tree links, every interior link of a unicast route);
      * ``queues``     — the distinct queues, each the tuple of flow
        indices feeding that link IN INJECTION ORDER (the order the
        legacy loop concatenated segments in — bit-exactness depends on
        it);
      * ``flow_links`` — per flow, its multicast-tree link ids (the
        flow x link incidence, first-visit order);
      * ``endpoints``  — the (src, dsts) pairs the plan was compiled from,
        kept so the contention model (``noc.latency``) can walk per-
        destination paths without re-deriving the traffic pattern.
    """

    topo: Topology
    num_flows: int
    link_ids: tuple[int, ...]
    link_queue: tuple[int, ...]
    queues: tuple[tuple[int, ...], ...]
    flow_links: tuple[tuple[int, ...], ...]
    endpoints: tuple[tuple[int, tuple[int, ...]], ...]

    @property
    def num_queues(self) -> int:
        return len(self.queues)

    @property
    def active_links(self) -> int:
        return len(self.link_ids)

    def queue_of(self, link_id: int) -> tuple[int, ...]:
        """The flow indices queued on one active link (injection order)."""
        return self.queues[self.link_queue[self.link_ids.index(link_id)]]


def compile_fabric(
    topo: Topology, endpoints: Sequence[tuple[int, tuple[int, ...]]]
) -> FabricPlan:
    """Route every (src, dsts) endpoint pair once and freeze the tables.

    ``endpoints[f]`` describes flow f; the returned plan's queue tables
    reproduce exactly what the legacy per-flow expansion loop built as
    Python dicts — links sorted ascending, each link's queue holding flow
    indices in injection order, distinct compositions deduplicated in
    first-use order along the ascending link scan.
    """
    endpoints = tuple((src, tuple(dsts)) for src, dsts in endpoints)
    flow_links = tuple(
        tuple(multicast_links(topo, src, dsts)) for src, dsts in endpoints
    )
    segments: dict[int, list[int]] = {}
    for fi, links in enumerate(flow_links):
        for lid in links:
            segments.setdefault(lid, []).append(fi)
    link_ids = tuple(sorted(segments))
    queue_index: dict[tuple[int, ...], int] = {}
    link_queue = []
    for lid in link_ids:
        key = tuple(segments[lid])
        qi = queue_index.setdefault(key, len(queue_index))
        link_queue.append(qi)
    return FabricPlan(
        topo=topo,
        num_flows=len(flow_links),
        link_ids=link_ids,
        link_queue=tuple(link_queue),
        queues=tuple(queue_index),
        flow_links=flow_links,
        endpoints=endpoints,
    )
