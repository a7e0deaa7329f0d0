"""NoC-level simulation: flows in, per-link BT/energy accounting out.

Counterpart of ``repro.noc.simulate``.  Traffic is injected as
``TrafficFlow``s (packet payloads with a source router and one or more
destinations), expanded along deterministic XY/ring routes into the
fabric's distinct link queues (``repro_torch.noc.fabric``) and measured by
ONE ``kernels.bt_count_links`` call — on a CUDA batch one launch of the
``bt_axes`` kernels (or of ``bt_axes_activity`` with ``activity_windows``)
for the whole fabric.

Where the sorting unit sits is the modeled design choice (DESIGN.md §9):

  * ``sort_at='source'`` — one PSU per injection port: packets are
    element-sorted once, the wire image is fixed at the source, and every
    hop of the route re-uses the same ordered stream;
  * ``sort_at='hop'``   — a PSU (plus a packet-granularity transmission
    scheduler) at every router egress: each link also reorders the
    transmission sequence of the packets queued on it by popcount bucket
    (the scheme of Chen et al., arXiv:2509.00500).

A spec naming a ``repro_torch.codec`` codec puts one encoder at every
active link's egress; each link's invert-line transitions ride along as
``LinkStats.bt_aux``.

The reference's pinned per-flow loop ``_expand_link_streams_reference`` is
not ported: the port is held against the reference's batched output.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .. import _obs_hooks as _obs
from ..codec.schemes import codec_by_name
from ..kernels import bt_count_links
from ..link import LinkSpec

from .fabric import FabricStreams, FlowBatch, expand_fabric
from .latency import FabricLatency, NocLatencyModel, fabric_latency
from .power import NocPowerModel
from .routing import compile_fabric, hop_count
from .topology import Topology

__all__ = [
    "TrafficFlow",
    "LinkStats",
    "LinkStreams",
    "NocReport",
    "expand_link_streams",
    "fabric_to_link_streams",
    "stack_link_streams",
    "simulate_noc",
]


@dataclasses.dataclass(frozen=True)
class TrafficFlow:
    """One traffic injection: packets from a source router to destination(s).

    ``inputs`` is a (P, elems_per_packet) byte tensor; ``weights``
    (optional) is the paired weight payload per the ``LinkSpec`` framing.
    More than one destination means tree multicast along the deterministic
    routes.
    """

    name: str
    src: int
    dsts: tuple[int, ...]
    inputs: torch.Tensor
    weights: torch.Tensor | None = None

    def __post_init__(self) -> None:
        if not self.dsts:
            raise ValueError(f"flow {self.name!r} has no destinations")


@dataclasses.dataclass(frozen=True)
class LinkStats:
    """BT / energy accounting of one directed link's traffic."""

    link: int  # topology link id
    src: int
    dst: int
    num_flits: int
    bt_input: int
    bt_weight: int
    energy_pj: float
    bt_aux: int = 0  # invert-line transitions (wire-codec overhead)

    @property
    def total_bt(self) -> int:
        return self.bt_input + self.bt_weight

    @property
    def gross_bt(self) -> int:
        """Data BT plus the codec's invert-line transitions."""
        return self.total_bt + self.bt_aux

    @property
    def bt_per_flit(self) -> float:
        return self.total_bt / max(self.num_flits, 1)


class LinkStreams(NamedTuple):
    """Per-link wire streams, stacked for the batched BT measurement.

    ``streams`` is (L, T_max, lanes) uint8; links shorter than T_max are
    padded with copies of their last flit (BT-neutral), ``lengths`` keeps
    the real flit counts.  When the spec names a wire codec, ``streams``
    is the *coded* wire image, ``aux_bt`` carries each link's invert-line
    transitions (all zeros otherwise), and ``inverts`` keeps the raw
    (T_link, npart) invert-line states per link (``None`` when the codec
    adds no wires).
    """

    link_ids: tuple[int, ...]
    streams: torch.Tensor
    lengths: tuple[int, ...]
    aux_bt: tuple[int, ...] = ()
    inverts: tuple = ()


@dataclasses.dataclass(frozen=True)
class NocReport:
    """Fabric-level accounting: per-link stats plus flow path info."""

    name: str
    topology: str
    sort_at: str
    key: str
    links: tuple[LinkStats, ...]
    flow_hops: tuple[tuple[str, int], ...]  # (flow name, max hops to a dst)
    total_links: int  # links in the topology (active or not)
    # wire-level activity (DESIGN.md §15) — populated only when the run was
    # measured with ``activity_windows=``.  One (num_windows, wires) int64
    # numpy toggle array and one (wires,) time-at-1 vector per active link,
    # wires = wire_lanes*8 data bits + the codec's invert lines; consumed
    # duck-typed by ``repro_torch.obs.activity.profiles_from_noc``.
    activity_window: int = 0
    wire_lanes: int = 0
    wire_toggles: tuple = ()
    wire_ones: tuple = ()
    # contention-model results (DESIGN.md §17) — populated only when the
    # run was simulated with ``latency=``
    latency: FabricLatency | None = None

    @property
    def active_links(self) -> int:
        return len(self.links)

    @property
    def total_bt(self) -> int:
        return sum(s.total_bt for s in self.links)

    @property
    def total_aux_bt(self) -> int:
        """Fabric-wide invert-line transitions (wire-codec overhead)."""
        return sum(s.bt_aux for s in self.links)

    @property
    def gross_bt(self) -> int:
        return self.total_bt + self.total_aux_bt

    @property
    def total_flit_hops(self) -> int:
        """Flits summed over links — each hop retransmits the payload."""
        return sum(s.num_flits for s in self.links)

    @property
    def energy_pj(self) -> float:
        return sum(s.energy_pj for s in self.links)

    @property
    def max_hops(self) -> int:
        return max((h for _, h in self.flow_hops), default=0)

    def reduction_vs(self, base: "NocReport") -> float:
        """Fabric-level BT reduction relative to a baseline run (fraction,
        scored on ``gross_bt`` so coded fabrics are net of overhead)."""
        return 1.0 - self.gross_bt / max(base.gross_bt, 1e-9)


def expand_link_streams(
    topo: Topology,
    flows: Sequence[TrafficFlow],
    spec: LinkSpec = LinkSpec(),
    *,
    sort_at: str = "source",
) -> LinkStreams:
    """Expand flows into the per-link wire streams of the whole fabric.

    The batched fabric pipeline (``noc.fabric``), re-expanded from its
    distinct-queue streams into the per-link view.  New code should keep
    the :class:`~repro_torch.noc.fabric.FabricStreams` form instead: it
    measures Q distinct queues, not L links.
    """
    plan = compile_fabric(topo, [(f.src, f.dsts) for f in flows])
    batch = FlowBatch.from_flows(flows, spec)
    fs = expand_fabric(plan, batch, spec, sort_at=sort_at)
    return fabric_to_link_streams(fs)


def fabric_to_link_streams(fs: FabricStreams) -> LinkStreams:
    """Per-link view of a fabric expansion: one gather of the distinct-queue
    streams per the plan's link->queue table.  Invert-line states stay
    device tensors, trimmed to each link's real flit count; only the
    scalar aux counts sync to host here, once for the whole fabric."""
    plan = fs.plan
    dev = fs.streams.device
    if not plan.link_ids:
        lanes = int(fs.streams.shape[-1])
        return LinkStreams((), torch.zeros((0, 1, lanes), dtype=torch.uint8, device=dev), ())
    lq = torch.as_tensor(plan.link_queue, dtype=torch.int64, device=dev)
    stacked = fs.streams.index_select(0, lq)
    lengths = fs.link_lengths()
    if fs.aux_bt is None:
        aux = (0,) * len(plan.link_ids)
        inverts: tuple = ()
    else:
        aux_q = fs.aux_bt.cpu().tolist()
        aux = tuple(aux_q[qi] for qi in plan.link_queue)
        if fs.inverts is None:
            inverts = (None,) * len(plan.link_ids)
        else:
            inverts = tuple(
                fs.inverts[qi, : lengths[i]] for i, qi in enumerate(plan.link_queue)
            )
    return LinkStreams(plan.link_ids, stacked, lengths, aux, inverts)


def stack_link_streams(
    streams: Sequence[torch.Tensor], lanes: int
) -> tuple[torch.Tensor, tuple[int, ...]]:
    """Stack jagged (T_l, lanes) streams to (L, T_max, lanes) uint8.

    Shorter streams are padded with copies of their last flit and the real
    flit counts are returned alongside.  The BT measurement masks
    everything past each link's length, so the padding value only keeps
    the padded tensor self-consistent.  An empty list gives an empty CPU
    tensor.
    """
    if not streams:
        return torch.zeros((0, 1, lanes), dtype=torch.uint8), ()
    lengths = tuple(int(s.shape[0]) for s in streams)
    t_max = max(lengths)
    padded = [
        s if s.shape[0] == t_max
        else torch.cat([s, s[-1:].expand(t_max - s.shape[0], s.shape[1])])
        for s in streams
    ]
    return torch.stack(padded).to(torch.uint8), lengths


def simulate_noc(
    topo: Topology,
    flows: Sequence[TrafficFlow],
    spec: LinkSpec = LinkSpec(),
    *,
    sort_at: str = "source",
    power: NocPowerModel | None = None,
    backend: str | None = None,
    chunk_rows: int | None = None,
    activity_windows: int | None = None,
    latency: NocLatencyModel | None = None,
    name: str = "noc",
) -> NocReport:
    """Run the fabric: expand flows to queue streams, measure every link.

    Routing is compiled once into a ``FabricPlan``, payloads are stacked
    into a ``FlowBatch`` on the flows' device, every distinct link queue is
    assembled and coded in batched steps, and ONE ``bt_count_links`` call
    measures the whole fabric (links sharing a queue composition carry
    byte-identical streams, so each distinct queue is measured once).
    Per-link energies roll up through ``NocPowerModel``.  ``backend="torch"``
    runs the plain versions of the source sort and the measurement on any
    device; ``chunk_rows`` measures the
    flit-row axis in chunks.  ``activity_windows`` (a flit count) also
    measures per-wire x per-window switching activity on every link: the
    report gains ``wire_toggles`` / ``wire_ones`` and each link fires a
    ``link.activity`` probe event.  ``latency`` (a ``NocLatencyModel``)
    also evaluates the hop-contention model over the plan's queue tables.
    The reference's ``interpret`` keyword is not taken.
    """
    power = power if power is not None else NocPowerModel()
    with _obs.span(
        "noc.simulate",
        topology=f"{topo.kind}{topo.rows}x{topo.cols}",
        sort_at=sort_at, key=spec.key, flows=len(flows), name=name,
    ):
        report = _simulate_noc(
            topo, flows, spec, sort_at=sort_at, power=power, backend=backend,
            chunk_rows=chunk_rows, activity_windows=activity_windows,
            latency=latency, name=name,
        )
    if _obs.active():
        # per-link egress telemetry (the rows behind repro_torch.obs.report)
        for s in report.links:
            _obs.event(
                "noc.link", link=s.link, src=s.src, dst=s.dst,
                num_flits=s.num_flits, bt_input=s.bt_input,
                bt_weight=s.bt_weight, bt_aux=s.bt_aux,
                energy_pj=s.energy_pj,
            )
        for i, s in enumerate(report.links if report.activity_window else ()):
            pw = report.wire_toggles[i].sum(axis=0)
            hot = int(np.lexsort((np.arange(len(pw)), -pw))[0])
            _obs.event(
                "link.activity", link=s.link, src=s.src, dst=s.dst,
                window_flits=report.activity_window,
                num_windows=-(-s.num_flits // report.activity_window),
                data_lanes=report.wire_lanes,
                toggles_total=int(pw.sum()),
                per_wire=[int(v) for v in pw],
                hot_wire=hot, hot_wire_toggles=int(pw[hot]),
            )
    return report


def _simulate_noc(
    topo: Topology,
    flows: Sequence[TrafficFlow],
    spec: LinkSpec,
    *,
    sort_at: str,
    power: NocPowerModel,
    backend: str | None,
    chunk_rows: int | None,
    activity_windows: int | None,
    latency: NocLatencyModel | None,
    name: str,
) -> NocReport:
    plan = compile_fabric(topo, [(f.src, f.dsts) for f in flows])
    batch = FlowBatch.from_flows(flows, spec)
    fs = expand_fabric(plan, batch, spec, sort_at=sort_at, backend=backend)
    extra_wires = 0
    if spec.codec != "none":
        extra_wires = codec_by_name(spec.codec).extra_wires(spec.bytes_per_flit)
    stats: list[LinkStats] = []
    wire_toggles: tuple = ()
    wire_ones: tuple = ()
    if plan.link_ids:
        # ONE measurement over the Q distinct queues; per-link rows are
        # table lookups (dedup'd links carry byte-identical streams)
        out = bt_count_links(
            fs.streams,
            input_lanes=spec.input_lanes,
            lengths=fs.lengths,
            backend=backend,
            chunk_rows=chunk_rows,
            activity_windows=activity_windows,
        )
        if activity_windows is not None:
            qtog, qone = _queue_wire_activity(
                out, fs.lengths, fs.inverts, activity_windows, extra_wires
            )
            wire_toggles = tuple(qtog[qi] for qi in plan.link_queue)
            wire_ones = tuple(qone[qi] for qi in plan.link_queue)
            out = out.bt
        # one sync for the BT table and one for the aux counts; totals are
        # summed in Python ints, never in int32 on the device
        bt_rows = out.cpu().tolist()
        aux_q = [0] * plan.num_queues if fs.aux_bt is None else fs.aux_bt.cpu().tolist()
        table = topo.link_table
        for lid, qi in zip(plan.link_ids, plan.link_queue):
            length = fs.lengths[qi]
            bi, bw = bt_rows[qi]
            aux = aux_q[qi]
            u, v = int(table[lid, 0]), int(table[lid, 1])
            stats.append(
                LinkStats(
                    link=lid,
                    src=u,
                    dst=v,
                    num_flits=length,
                    bt_input=bi,
                    bt_weight=bw,
                    # same coded-wire accounting as the point-to-point
                    # path: invert lines switch and widen this hop too
                    energy_pj=power.coded_hop_energy_pj(
                        bi + bw, aux, length, 8 * spec.bytes_per_flit, extra_wires,
                    ),
                    bt_aux=aux,
                )
            )
    fabric_lat = None
    if latency is not None:
        fabric_lat = fabric_latency(
            plan, [c * spec.flits_per_packet for c in batch.counts], latency
        )
    flow_hops = tuple(
        (f.name, max(hop_count(topo, f.src, d) for d in f.dsts)) for f in flows
    )
    return NocReport(
        name=name,
        topology=f"{topo.kind}{topo.rows}x{topo.cols}",
        sort_at=sort_at,
        key=spec.key,
        links=tuple(stats),
        flow_hops=flow_hops,
        total_links=topo.num_links,
        activity_window=activity_windows or 0,
        wire_lanes=spec.bytes_per_flit if activity_windows else 0,
        wire_toggles=wire_toggles,
        wire_ones=wire_ones,
        latency=fabric_lat,
    )


def _queue_wire_activity(
    out, lengths: tuple[int, ...], inverts, window: int, extra_wires: int
) -> tuple[list, list]:
    """Per-queue full-wire activity: the measured data-wire arrays widened
    with the codec invert lines' toggles/ones.  The invert recurrence was
    already paid on the device in the batched expansion; the (Q, T, npart)
    line-state tensor crosses to host ONCE here and only window bucketing
    happens per queue, in numpy."""
    tog = out.toggles.cpu().numpy().astype(np.int64)  # (Q, NW, lanes*8)
    one = out.ones.cpu().numpy().astype(np.int64)  # (Q, lanes*8)
    nw = tog.shape[1]
    inv_all = None if inverts is None else inverts.cpu().numpy().astype(np.int64)
    wire_toggles, wire_ones = [], []
    for i, length in enumerate(lengths):
        aux_t = np.zeros((nw, extra_wires), np.int64)
        aux_o = np.zeros(extra_wires, np.int64)
        if inv_all is not None and length >= 1:
            iv = inv_all[i, :length]
            aux_o[: iv.shape[1]] = iv.sum(axis=0)
            if length >= 2:
                flips = (iv[1:] != iv[:-1]).astype(np.int64)
                # boundary into row t lands in window t // window — the
                # same global indexing as the measured data wires
                widx = np.arange(1, length) // window
                np.add.at(aux_t[:, : iv.shape[1]], widx, flips)
        wire_toggles.append(np.concatenate([tog[i], aux_t], axis=1))
        wire_ones.append(np.concatenate([one[i], aux_o]))
    return wire_toggles, wire_ones
