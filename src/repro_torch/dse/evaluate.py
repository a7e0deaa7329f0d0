"""Evaluate a design grid against a workload — the DSE measurement core.

Counterpart of ``repro.dse.evaluate``.  For every
:class:`~repro_torch.dse.space.DesignPoint` of a grid, one
:class:`Evaluation` joins the models end to end:

  * **BT** — measured on the workload's actual flit streams by ONE
    ``kernels.bt_count_axes`` call per key width (DESIGN.md §12; on a CUDA
    workload one launch of the ``bt_axes`` kernels): every workload stream
    AND every distinct NoC route queue rides the call's link axis (jagged
    links masked), every (ordering, codec) config its config axis.  Coded
    points' invert-line transitions count against them, so their BT
    reductions are net of wire overhead (DESIGN.md §11).
  * **Area / timing** — the closed-form models of ``repro_torch.core.area``
    per family/N/W/k, plus the codec encoder area in ``PSUArea.codec``.
  * **Link power / energy** — ``repro_torch.link.LinkPowerModel``.
  * **NoC (optional)** — points with a ``topology`` are also scored on a
    source-sorted fabric carrying the workload from router 0 to the
    farthest router: the route's link queue is one more row of the SAME
    measurement, scaled by the route length (every route link retransmits
    the byte-identical queue), and the route's wormhole latency comes from
    ``repro_torch.noc.latency``.

The unsorted 'none' variant is always measured as the reduction baseline;
area reductions are vs the precise ACC-PSU at the same (N, W).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .. import _obs_hooks as _obs
from ..core.area import PSUArea, PSUTiming, codec_area, psu_area
from ..kernels import CodecVariant, bt_count_axes, launch_counts
from ..link import LinkPowerModel

from .space import DesignPoint, topology_route_hops

__all__ = ["Workload", "Evaluation", "evaluate_grid", "grid_launch_count"]

_BASELINE = CodecVariant("none", None, False, "none", None)


class Workload(NamedTuple):
    """The traffic a design grid is evaluated on.

    ``streams`` are (P, elems) byte-packet tensors measured independently
    (the Table-I conv setup streams inputs and weights on separate links),
    all on one device; ``lanes`` is the byte width of each measured flit.
    """

    name: str
    streams: tuple[torch.Tensor, ...]
    lanes: int = 16

    @property
    def elems_per_packet(self) -> int:
        return int(self.streams[0].shape[-1])

    @property
    def num_flits(self) -> int:
        return sum(
            int(s.shape[0]) * (int(s.shape[-1]) // self.lanes) for s in self.streams
        )


def _validate_workload(workload: Workload) -> None:
    if not workload.streams:
        raise ValueError(f"workload {workload.name!r} has no streams")
    elems = None
    for s in workload.streams:
        if getattr(s, "ndim", None) != 2 or s.shape[0] == 0:
            raise ValueError(
                f"workload {workload.name!r}: streams must be non-empty "
                f"(P, elems) arrays, got {getattr(s, 'shape', None)}"
            )
        elems = s.shape[-1] if elems is None else elems
        if s.shape[-1] != elems:
            raise ValueError(
                f"workload {workload.name!r}: streams disagree on packet "
                f"size ({elems} vs {s.shape[-1]})"
            )
    if elems % workload.lanes != 0:
        raise ValueError(
            f"workload {workload.name!r}: packet size {elems} not divisible "
            f"by lanes={workload.lanes}"
        )


@dataclasses.dataclass(frozen=True)
class Evaluation:
    """One design point joined across the BT / area / timing / power models."""

    point: DesignPoint
    area: PSUArea
    timing: PSUTiming
    total_bt: int
    num_flits: int
    bt_reduction: float  # vs the unsorted uncoded stream, net of overhead
    area_reduction: float  # vs the precise ACC-PSU at the same (N, W)
    link_power_reduction: float  # Fig. 6/7 model applied to bt_reduction
    energy_pj: float
    noc_bt_reduction: float | None = None  # fabric-level, when topology set
    noc_active_links: int | None = None
    aux_bt: int = 0  # invert-line transitions (wire-codec overhead)
    extra_wires: int = 0  # invert lines beside the data lanes
    # per-wire BT over the workload streams (data wires then invert lines,
    # DESIGN.md §15) — populated when evaluated with ``activity_windows=``
    per_wire_bt: tuple[int, ...] | None = None
    # wormhole traversal of the point's NoC route (``repro_torch.noc.latency``,
    # DESIGN.md §17) — set when topology is
    noc_latency_ns: float | None = None

    @property
    def label(self) -> str:
        return self.point.label

    @property
    def hot_wire(self) -> int | None:
        """Index of the busiest wire (first on ties), wire-resolved runs."""
        if not self.per_wire_bt:
            return None
        return int(np.argmax(self.per_wire_bt))

    @property
    def hot_wire_bt(self) -> int | None:
        return None if not self.per_wire_bt else int(max(self.per_wire_bt))

    @property
    def wire_bt_mean(self) -> float | None:
        if not self.per_wire_bt:
            return None
        return sum(self.per_wire_bt) / len(self.per_wire_bt)

    @property
    def hot_wire_ratio(self) -> float | None:
        """Hot-wire tail: busiest wire's BT over the mean (1.0 = perfectly
        flat) — the figure of merit for orderings that flatten the tail."""
        mean = self.wire_bt_mean
        if mean is None:
            return None
        return self.hot_wire_bt / max(mean, 1e-12)

    @property
    def area_um2(self) -> float:
        return self.area.total

    @property
    def gross_bt(self) -> int:
        """Data BT plus the codec's invert-line transitions."""
        return self.total_bt + self.aux_bt

    @property
    def bt_per_flit(self) -> float:
        return self.total_bt / max(self.num_flits, 1)

    @property
    def latency_ns(self) -> float:
        """Time to sort one N-element window at the paper's 500 MHz."""
        return self.timing.sort_time_ns(self.point.n)

    @property
    def total_latency_ns(self) -> float:
        """Sort latency plus the NoC traversal of the workload (when the
        point names a topology) — the latency axis of the
        AREA_BT_LATENCY Pareto plane."""
        return self.latency_ns + (self.noc_latency_ns or 0.0)


def _configs_by_width(
    points: tuple[DesignPoint, ...],
) -> dict[int, tuple[CodecVariant, ...]]:
    """Unique (ordering, codec) configs per key width, baseline first."""
    by_width: dict[int, list[CodecVariant]] = {}
    for pt in points:
        vs = by_width.setdefault(pt.width, [_BASELINE])
        if pt.codec_variant not in vs:
            vs.append(pt.codec_variant)
    return {w: tuple(vs) for w, vs in by_width.items()}


def _grid_links(
    points: tuple[DesignPoint, ...], workload: Workload
) -> tuple[list[torch.Tensor], dict[str, tuple[int, int]]]:
    """The measurement links of one grid call.

    The first ``len(workload.streams)`` rows are the point-to-point
    streams.  Then, per distinct topology named by any point, ONE row
    carrying the source-sorted fabric's link queue (all the workload's
    packets, router 0 toward the farthest router), measured once and
    scaled by the route length.  Returns (payloads, {topology: (row index,
    link count)}).
    """
    streams = list(workload.streams)
    payloads = list(streams)
    topo_rows: dict[str, tuple[int, int]] = {}
    names = dict.fromkeys(pt.topology for pt in points if pt.topology is not None)
    for name in names:
        nlinks = topology_route_hops(name)
        q = streams[0] if len(streams) == 1 else torch.cat(streams, dim=0)
        topo_rows[name] = (len(payloads), nlinks)
        payloads.append(q)
    return payloads, topo_rows


def _stack_links(
    payloads: Sequence[torch.Tensor],
) -> tuple[torch.Tensor, tuple[int, ...]]:
    """Stack jagged (P_l, N) packet queues to (L, P_max, N) + valid counts
    (zero-padded; the measurement masks past each link's valid count)."""
    valid = tuple(int(s.shape[0]) for s in payloads)
    pmax = max(valid)
    stacked = torch.zeros(
        (len(payloads), pmax, payloads[0].shape[-1]), dtype=payloads[0].dtype,
        device=payloads[0].device,
    )
    for i, s in enumerate(payloads):
        stacked[i, : s.shape[0]] = s
    return stacked, valid


def _measure_grid(
    points: tuple[DesignPoint, ...],
    workload: Workload,
    *,
    backend: str | None = None,
    chunk_packets: int | None = None,
    activity_windows: int | None = None,
) -> tuple[
    dict[tuple[int, CodecVariant], tuple[int, int]],
    dict[tuple[int, str, CodecVariant], int],
    dict[str, int],
    dict[tuple[int, CodecVariant], np.ndarray],
]:
    """Run the grid's one-call-per-width measurement.

    Returns (bt_tab, noc_tab, topo_links, wire_tab): point-to-point (data
    BT, aux BT) per (width, config), fabric gross BT per (width,
    topology, config), active link counts per topology, and — when
    ``activity_windows`` is set — the per-wire BT vector of the workload
    streams per (width, config) (empty dict otherwise).  One host sync per
    width.
    """
    configs_by_width = _configs_by_width(points)
    payloads, topo_rows = _grid_links(points, workload)
    stacked, valid = _stack_links(payloads)
    n_p2p = len(workload.streams)
    bt_tab: dict[tuple[int, CodecVariant], tuple[int, int]] = {}
    noc_tab: dict[tuple[int, str, CodecVariant], int] = {}
    wire_tab: dict[tuple[int, CodecVariant], np.ndarray] = {}
    link_names = [f"{workload.name}[{i}]" for i in range(n_p2p)] + list(topo_rows)
    for width in sorted(configs_by_width):
        vs = configs_by_width[width]
        with _obs.span(
            "dse.measure", width=width, links=len(payloads),
            configs=len(vs), workload=workload.name,
        ):
            raw = bt_count_axes(
                stacked,
                None,
                valid=valid,
                configs=vs,
                width=width,
                input_lanes=workload.lanes,
                backend=backend,
                chunk_packets=chunk_packets,
                activity_windows=activity_windows,
            )
        toggles = None
        if activity_windows is not None:
            toggles = raw.toggles.cpu().numpy().astype(np.int64)
            raw = raw.bt
        out = raw.cpu().numpy().astype(np.int64)  # (L, C, 3)
        if _obs.active():
            # per-link baseline BT of this width's call (config 0 is
            # always the unsorted/uncoded baseline)
            for li, lname in enumerate(link_names):
                _obs.event(
                    "dse.link", link=lname, width=width,
                    bt=int(out[li, 0, :2].sum()), packets=int(valid[li]),
                )
        for ci, v in enumerate(vs):
            p2p = out[:n_p2p, ci]
            bt_tab[(width, v)] = (int(p2p[:, :2].sum()), int(p2p[:, 2].sum()))
            if toggles is not None:
                # workload streams share one link in the energy roll-up,
                # so their per-wire vectors sum (windows collapse too)
                wire_tab[(width, v)] = toggles[:n_p2p, ci].sum(axis=(0, 1))
            for name, (row, nlinks) in topo_rows.items():
                # every route link retransmits the identical queue
                noc_tab[(width, name, v)] = nlinks * int(out[row, ci].sum())
    return bt_tab, noc_tab, {n: r[1] for n, r in topo_rows.items()}, wire_tab


def grid_launch_count(points: Sequence[DesignPoint], workload: Workload) -> int:
    """CUDA launches of the ``bt_axes`` kernels in ONE run of the whole
    grid measurement — every stream, every NoC route link, every
    (ordering, codec) config.

    The reference counts ``pallas_call`` equations in the traced jaxpr;
    here the measurement runs once and the ``bt_axes`` launch counter's
    delta is returned (``kernels.launch_counts()``).  On a CUDA workload
    one key width is exactly 1 launch and mixed widths add one per width.
    On a CPU workload the plain version runs and the count is 0.
    """
    points = tuple(points)
    if not points:
        return 0
    _validate_workload(workload)
    before = launch_counts()["bt_axes"]
    _measure_grid(points, workload)
    return launch_counts()["bt_axes"] - before


def evaluate_grid(
    points: Sequence[DesignPoint],
    workload: Workload,
    *,
    power: LinkPowerModel | None = None,
    backend: str | None = None,
    chunk_packets: int | None = None,
    activity_windows: int | None = None,
    latency=None,
) -> tuple[Evaluation, ...]:
    """Evaluate every design point of a grid against one workload.

    Points sharing a stream variant (e.g. the comparator families, which
    sort exactly like ACC) share one measurement; all streams, NoC route
    links and (ordering, codec) configs ride ONE ``bt_count_axes`` call,
    with distinct key widths split into one call per width.

    ``backend="torch"`` runs the plain version on any device;
    ``chunk_packets`` measures the packet axis in chunks.
    ``activity_windows`` rides the same call and resolves each point's BT
    per wire (``Evaluation.per_wire_bt``).  ``latency`` (a
    ``repro_torch.noc.NocLatencyModel``; default timing constants when
    omitted) prices each topology point's NoC traversal into
    ``Evaluation.noc_latency_ns``.  The reference's ``interpret`` and
    ``block_packets`` keywords are not taken.
    """
    points = tuple(points)
    if not points:
        return ()
    _validate_workload(workload)
    power = power if power is not None else LinkPowerModel()
    lanes = workload.lanes
    from ..noc.latency import NocLatencyModel, route_latency_ns  # deferred

    latency = latency if latency is not None else NocLatencyModel()

    bt_tab, noc_tab, topo_links, wire_tab = _measure_grid(
        points,
        workload,
        backend=backend,
        chunk_packets=chunk_packets,
        activity_windows=activity_windows,
    )
    num_flits = workload.num_flits

    evals: list[Evaluation] = []
    for pt in points:
        total_bt, aux_bt = bt_tab[(pt.width, pt.codec_variant)]
        base_bt, _ = bt_tab[(pt.width, _BASELINE)]
        # coded points are scored net of their invert-line transitions
        bt_red = 1.0 - (total_bt + aux_bt) / max(base_bt, 1)
        area = pt.area()
        extra_wires = 0
        if pt.codec is not None:
            # fold the encoder hardware into the point's area breakdown
            cv = pt.codec_variant
            area = PSUArea(
                area.popcount, area.sort, codec=codec_area(cv.codec, lanes, cv.partition),
            )
            from ..codec.schemes import codec_by_name  # deferred

            extra_wires = codec_by_name(pt.codec).extra_wires(lanes)
        acc_total = psu_area(pt.n, pt.width).total
        noc_red = noc_links = noc_lat = None
        if pt.topology is not None:
            gross = noc_tab[(pt.width, pt.topology, pt.codec_variant)]
            base = noc_tab[(pt.width, pt.topology, _BASELINE)]
            noc_red = 1.0 - gross / max(base, 1)
            noc_links = topo_links[pt.topology]
            # the whole workload crossing the evaluation route (router 0
            # to the farthest router) under the wormhole model
            noc_lat = route_latency_ns(noc_links, num_flits, latency)
        per_wire = None
        if activity_windows is not None:
            # trim the call-wide aux columns to this point's own invert
            # lines so len(per_wire_bt) == data wires + extra_wires
            pw = wire_tab[(pt.width, pt.codec_variant)]
            per_wire = tuple(int(b) for b in pw[: 8 * lanes + extra_wires])
        evals.append(
            Evaluation(
                point=pt,
                area=area,
                timing=pt.timing(),
                total_bt=total_bt,
                num_flits=num_flits,
                bt_reduction=bt_red,
                area_reduction=1.0 - area.total / acc_total,
                link_power_reduction=power.power_reduction(bt_red),
                energy_pj=power.coded_link_energy_pj(
                    total_bt, aux_bt, num_flits, 8 * lanes, extra_wires
                ),
                noc_bt_reduction=noc_red,
                noc_active_links=noc_links,
                aux_bt=aux_bt,
                extra_wires=extra_wires,
                per_wire_bt=per_wire,
                noc_latency_ns=noc_lat,
            )
        )
        _obs.event(
            "dse.point", label=pt.label, width=pt.width,
            bt_reduction=bt_red, area_um2=float(area.total),
        )
    return tuple(evals)
