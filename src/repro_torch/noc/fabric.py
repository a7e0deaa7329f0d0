"""Batched device-side fabric expansion (DESIGN.md §17).

Counterpart of ``repro.noc.fabric``.  Three batched steps over the
routing tables a :class:`~repro_torch.noc.routing.FabricPlan` compiled
once:

  1. :class:`FlowBatch` — every flow's packets stacked into ONE (F, P_max,
     elems) tensor on the flows' own device (zero-padded, per-flow packet
     counts kept statically; no host round trip);
  2. :func:`expand_fabric` — encode and the source's element order for ALL
     flows at once (for ``acc`` / ``app`` keys one ``kernels.psu_sort`` over
     the (F*P_max, N) packets: the sorting unit the NoC places at each
     source), flows gathered into distinct-queue rows by one (Q, P_q) index
     table, the hop-sort packet permutation as a masked batched counting
     sort, flit assembly of all queues in one ``assemble_stream`` call and
     the wire codec over the queue batch (bus-invert's recurrence included);
  3. one ``bt_count_links`` call (the multi-axis measurement) measures
     every distinct queue in ``repro_torch.noc.simulate``.

The source order is applied to the packets before they are gathered into
queues: a per-packet element order commutes with the queue gather, and the
hop sort's keys (row popcounts) do not depend on the element order, so the
streams are the reference's byte for byte.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from .. import _obs_hooks as _obs
from ..codec.schemes import codec_by_name
from ..core.sorting import counting_sort_indices
from ..kernels import psu_sort
from ..link import ENCODE_STAGES, LinkSpec, make_order
from ..link.framing import assemble_stream
from ..link.stages import row_bucket_keys

from .routing import FabricPlan

__all__ = [
    "FlowBatch",
    "FabricStreams",
    "expand_fabric",
    "validate_flow",
]

# packets a chunk when the source order is applied by an int64 gather
# (2**22 packets of 64 bytes: a 2 GiB index)
_GATHER_PACKETS = 1 << 22


def validate_flow(flow, spec: LinkSpec) -> None:
    """Payload/framing consistency of one flow against the link spec."""
    if flow.inputs.dim() != 2 or flow.inputs.shape[-1] != spec.elems_per_packet:
        raise ValueError(
            f"flow {flow.name!r}: payload {tuple(flow.inputs.shape)} != "
            f"(P, {spec.elems_per_packet}) for this spec"
        )
    if flow.inputs.shape[0] == 0:
        raise ValueError(f"flow {flow.name!r}: zero packets")
    if spec.weight_lanes and flow.weights is None:
        raise ValueError(
            f"flow {flow.name!r}: spec has weight lanes but no weight payload"
        )
    if flow.weights is not None:
        if not spec.weight_lanes:
            raise ValueError(
                f"flow {flow.name!r}: weight payload on an input-only spec"
            )
        if tuple(flow.weights.shape) != (
            flow.inputs.shape[0],
            spec.weight_elems_per_packet,
        ):
            raise ValueError(
                f"flow {flow.name!r}: weight payload "
                f"{tuple(flow.weights.shape)} != "
                f"(P, {spec.weight_elems_per_packet})"
            )


class FlowBatch(NamedTuple):
    """Every flow's packet payloads as one batch on the flows' device.

    ``inputs`` is (F, P_max, elems) uint8 (flows shorter than P_max are
    zero-padded — padding never reaches a measured wire, the queue tables
    index real packets only); ``weights`` rides along for paired framings.
    ``counts`` keeps each flow's real packet count statically.
    """

    inputs: torch.Tensor
    weights: Optional[torch.Tensor]
    counts: tuple[int, ...]

    @property
    def num_flows(self) -> int:
        return len(self.counts)

    @property
    def max_packets(self) -> int:
        return 0 if not self.counts else int(self.inputs.shape[1])

    @classmethod
    def from_flows(cls, flows: Sequence, spec: LinkSpec) -> "FlowBatch":
        """Validate and stack flow payloads on the first flow's device (one
        device copy per flow and side, no host staging).  An empty flow set
        has nothing to measure: its batch is an empty CPU tensor."""
        flows = tuple(flows)
        for flow in flows:
            validate_flow(flow, spec)
        counts = tuple(int(f.inputs.shape[0]) for f in flows)
        if not flows:
            return cls(torch.zeros((0, 1, spec.elems_per_packet), dtype=torch.uint8), None, ())
        dev = flows[0].inputs.device
        pmax = max(counts)

        def stack(side: str, elems: int) -> torch.Tensor:
            out = torch.zeros((len(flows), pmax, elems), dtype=torch.uint8, device=dev)
            for i, f in enumerate(flows):
                out[i, : counts[i]] = getattr(f, side).to(device=dev, dtype=torch.uint8)
            return out

        ws = stack("weights", spec.weight_elems_per_packet) if spec.weight_lanes else None
        return cls(stack("inputs", spec.elems_per_packet), ws, counts)


class FabricStreams(NamedTuple):
    """The fabric's distinct-queue wire streams, ready for ONE BT call.

    ``streams`` is (Q, T_max, bytes_per_flit) uint8 — one row per distinct
    link queue, padded past each queue's real flit count with copies of its
    last flit (the kernel masks past ``lengths`` either way).  ``aux_bt`` /
    ``inverts`` carry the wire codec's invert-line transition counts (int32
    (Q,)) and raw line states (uint8 (Q, T_max, partitions)) per queue —
    device tensors until a consumer materializes them (``None`` for
    uncoded links; ``inverts`` also for codecs with no extra wires).
    Per-link views are ``plan.link_queue`` lookups.
    """

    plan: FabricPlan
    streams: torch.Tensor
    lengths: tuple[int, ...]
    aux_bt: Optional[torch.Tensor] = None
    inverts: Optional[torch.Tensor] = None

    @property
    def num_queues(self) -> int:
        return len(self.lengths)

    def link_lengths(self) -> tuple[int, ...]:
        """Real flit counts in per-active-link order."""
        return tuple(self.lengths[qi] for qi in self.plan.link_queue)


def _queue_gather_table(
    plan: FabricPlan, counts: tuple[int, ...], pmax: int, device: torch.device
) -> tuple[torch.Tensor, tuple[int, ...]]:
    """(Q, P_qmax) int64 flat packet indices per distinct queue + real
    counts, built on ``device``.

    Queue slot j of queue q maps to flat index flow*P_max + packet of the
    j-th packet in injection order (the legacy concatenation order); pad
    slots point at index 0 and are masked everywhere downstream.  Each
    (queue, flow) entry is one run of consecutive slots, so the table is
    written from the runs' offsets without a host array of its size.
    """
    qcounts = tuple(sum(counts[f] for f in q) for q in plan.queues)
    qmax = max(max(qcounts, default=0), 1)
    # run r covers slots [ends[r-1], ends[r]) of the concatenated real
    # slots: slot i of it sits at table index i + shift[r] and holds
    # i + shift[r] + delta[r].  The run of each slot comes from a binary
    # search: repeat_interleave gives a run one warp, which serialises runs
    # of millions of slots.
    ends, shift, delta, n = [], [], [], 0
    for qi, q in enumerate(plan.queues):
        slot = qi * qmax
        for f in q:
            shift.append(slot - n)
            delta.append(f * pmax - slot)
            slot += counts[f]
            n += counts[f]
            ends.append(n)
    table = torch.zeros(len(plan.queues) * qmax, dtype=torch.int64, device=device)
    if n:
        def as_t(v: list[int]) -> torch.Tensor:
            return torch.as_tensor(v, dtype=torch.int64, device=device)

        dst = torch.arange(n, dtype=torch.int64, device=device)
        run = torch.searchsorted(as_t(ends), dst, right=True)
        dst += as_t(shift)[run]
        table[dst] = dst + as_t(delta)[run]
    return table.reshape(len(plan.queues), qmax), qcounts


def _hop_perm_masked(
    rows: torch.Tensor,
    qcounts: Sequence[int],
    levels: int,
    *,
    width: int,
    descending: bool,
) -> torch.Tensor:
    """Batched, jagged-queue version of the per-hop packet permutation.

    Real rows get the popcount-bucket keys (and descending flip) of
    ``row_bucket_order``; pad rows get one extra bucket past everything,
    so the stable counting sort emits the real packets in order followed
    by the pads.  int32 (Q, P).
    """
    keys = row_bucket_keys(rows, levels, width=width)  # (Q, P)
    if descending:
        keys = (levels - 1) - keys
    p = rows.shape[1]
    counts = torch.as_tensor(qcounts, dtype=torch.int32, device=rows.device)
    mask = torch.arange(p, device=rows.device)[None, :] < counts[:, None]
    keys = torch.where(mask, keys, levels)
    return counting_sort_indices(keys, levels + 1)


def _validate_expansion(spec: LinkSpec, sort_at: str) -> None:
    if sort_at not in ("source", "hop"):
        raise ValueError(f"sort_at must be 'source' or 'hop', got {sort_at!r}")
    if spec.key == "row_bucket":
        raise ValueError(
            "NoC flows carry packets, which use the packet-granularity key "
            "stages ('none', 'column_major', 'acc', 'app'); 'row_bucket' is "
            "a row-stream stage (TxPipeline.measure_rows)"
        )


def _gather_rows(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """x[i, order[i, j]] for (R, N) packets, gathered in row chunks (an
    int64 index of the whole batch would take 8 bytes per element)."""
    out = torch.empty_like(x)
    for r0 in range(0, x.shape[0], _GATHER_PACKETS):
        sl = slice(r0, r0 + _GATHER_PACKETS)
        torch.gather(x[sl], 1, order[sl].to(torch.int64), out=out[sl])
    return out


def _source_sorted(
    xi: torch.Tensor, wi: torch.Tensor | None, spec: LinkSpec, backend: str | None
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(R, N) packets (and their paired weights) in the source's element
    order: ``acc`` / ``app`` from one ``psu_sort`` (a stable counting sort
    by the same keys as ``make_order``), the data-independent keys from
    ``make_order``'s one fixed permutation.  Weights move along only for
    the symmetric framing, as in ``assemble_stream``."""
    moves_w = wi is not None and wi.shape == xi.shape
    if spec.key == "none":
        return xi, wi
    if spec.key == "column_major":
        perm = make_order(
            spec.key, xi[:1], lanes=spec.input_lanes, width=spec.width, k=spec.k,
            descending=spec.descending,
        )[0].to(torch.int64)
        return xi.index_select(1, perm), wi.index_select(1, perm) if moves_w else wi
    order = psu_sort(
        xi, width=spec.width, k=spec.k if spec.key == "app" else None,
        descending=spec.descending, backend=backend,
    )[0]
    return _gather_rows(xi, order), _gather_rows(wi, order) if moves_w else wi


def expand_fabric(
    plan: FabricPlan,
    batch: FlowBatch,
    spec: LinkSpec = LinkSpec(),
    *,
    sort_at: str = "source",
    backend: str | None = None,
) -> FabricStreams:
    """Expand a whole fabric's flows into distinct-queue wire streams.

    Every step is batched over all flows / queues at once; the only Python
    iteration is the O(queues) index-table build.  Bit-exact vs the
    reference's expansion (``tests/test_torch_noc.py``).  On a CUDA batch
    the ``acc`` / ``app`` source order is one ``psu_sort`` launch;
    ``backend="torch"`` takes its plain version.
    """
    _validate_expansion(spec, sort_at)
    if batch.num_flows != plan.num_flows:
        raise ValueError(
            f"batch carries {batch.num_flows} flows but the plan routed "
            f"{plan.num_flows}"
        )
    with _obs.span(
        "noc.expand",
        topology=f"{plan.topo.kind}{plan.topo.rows}x{plan.topo.cols}",
        sort_at=sort_at, flows=plan.num_flows, queues=plan.num_queues,
    ):
        return _expand_fabric(plan, batch, spec, sort_at, backend)


def _is_identity(plan: FabricPlan, counts: tuple[int, ...], pmax: int) -> bool:
    """True when queue q is flow q alone and every flow fills P_max: the
    batch is then already queued, and the gather (an ``index_select`` of
    the whole batch; ``chip_smoke.py`` times it at a full-width ring step
    as ``gather_ms``) is skipped."""
    return plan.queues == tuple((f,) for f in range(len(counts))) and all(
        c == pmax for c in counts
    )


def _expand_fabric(
    plan: FabricPlan, batch: FlowBatch, spec: LinkSpec, sort_at: str, backend: str | None
) -> FabricStreams:
    nq = plan.num_queues
    dev = batch.inputs.device
    if nq == 0 or batch.num_flows == 0:
        return FabricStreams(
            plan, torch.zeros((nq, 1, spec.bytes_per_flit), dtype=torch.uint8, device=dev),
            (0,) * nq,
        )
    encode = ENCODE_STAGES[spec.encode]
    f, pmax, e = (int(d) for d in batch.inputs.shape)
    xi = encode(batch.inputs).to(torch.uint8).reshape(f * pmax, e)
    wi = None
    if batch.weights is not None:
        wi = encode(batch.weights).to(torch.uint8)
        wi = wi.reshape(f * pmax, wi.shape[-1])
    # ONE order derivation for every packet of every flow
    xi, wi = _source_sorted(xi, wi, spec, backend)
    if _is_identity(plan, batch.counts, pmax):
        qcounts, pq = batch.counts, pmax
        qx = xi.reshape(nq, pq, e)
        qw = None if wi is None else wi.reshape(nq, pq, -1)
    else:
        table, qcounts = _queue_gather_table(plan, batch.counts, pmax, dev)
        pq = table.shape[1]
        gather = table.reshape(-1)
        qx = xi.index_select(0, gather).reshape(nq, pq, e)
        qw = None if wi is None else wi.index_select(0, gather).reshape(nq, pq, -1)
        del table, gather
    del xi, wi
    if sort_at == "hop":
        rows = qx if qw is None else torch.cat([qx, qw], dim=-1)
        levels = spec.k if spec.key == "app" else spec.width + 1
        perm = _hop_perm_masked(
            rows, qcounts, levels, width=spec.width, descending=spec.descending,
        ).to(torch.int64)
        del rows
        qx = torch.gather(qx, 1, perm[..., None].expand(qx.shape))
        if qw is not None:
            qw = torch.gather(qw, 1, perm[..., None].expand(qw.shape))
    # flit assembly of every queue in one call: its rows are packet-major,
    # so (Q*P_q*F, bytes) reshapes to the per-queue streams
    streams = assemble_stream(
        qx.reshape(nq * pq, e), None if qw is None else qw.reshape(nq * pq, -1),
        spec, None, spec.pack,
    ).reshape(nq, pq * spec.flits_per_packet, spec.bytes_per_flit)
    del qx, qw
    lengths = tuple(c * spec.flits_per_packet for c in qcounts)
    t = int(streams.shape[1])
    real_len = torch.as_tensor(lengths, dtype=torch.int64, device=dev)
    aux = inverts = None
    if spec.codec != "none":
        # every queue coded on its own; state runs over the padded tail
        # too, which comes after the real rows and is masked below
        coded = codec_by_name(spec.codec).encode(streams)
        streams = coded.wire.to(torch.uint8)
        if coded.invert is not None:
            inverts = coded.invert
            real = torch.arange(1, t, device=dev)[None, :, None] < real_len[:, None, None]
            flips = (inverts[:, 1:] != inverts[:, :-1]) & real
            aux = flips.sum(dim=(1, 2)).to(torch.int32)
        else:
            aux = torch.zeros((nq,), dtype=torch.int32, device=dev)
    # pad rows become copies of each queue's last real flit
    if min(lengths) < t:
        last = (real_len - 1).clamp_min(0)
        last_rows = streams[torch.arange(nq, device=dev), last]  # (Q, bytes)
        pad = torch.arange(t, device=dev)[None, :] >= real_len[:, None]
        streams = torch.where(pad[..., None], last_rows[:, None, :], streams)
    return FabricStreams(plan, streams, lengths, aux, inverts)
