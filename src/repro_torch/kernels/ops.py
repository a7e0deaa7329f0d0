"""Public kernel entry points, dispatched by the tensor's device.

Counterpart of ``repro/kernels/ops.py``:
``psu_sort`` / ``psu_reorder`` (``ops.py:165-238``), ``psu_stream`` and
``PsuStreamResult`` (``ops.py:684-804``), ``bt_count`` (``ops.py:807-835``),
the multi-axis measurement ``bt_count_axes`` (``ops.py:853-983``), its link
axis sharded over a ``torch.distributed`` group ``bt_count_axes_sharded``
(``ops.py:986-1095``), and its thin configurations ``bt_count_links``, ``bt_count_variants`` and
``bt_count_codecs`` (``ops.py:1098-1308``), per-wire activity windows
(``AxesActivity`` / ``LinkActivity``) included, and the int8 egress
quantizer ``quantize_egress`` (``ops.py:1312-1343``).  A CUDA tensor launches
the hand-written kernel, a CPU tensor takes the plain version,
``backend="torch"`` forces the plain version (``backend.py``).  The
reference's ``block_packets`` / ``block_rows`` / ``interpret`` keywords
have no meaning here and are not taken.

Every public entry point fires one ``kernel.dispatch`` probe span
(``repro_torch._obs_hooks``; a ``None`` test while nothing collects) with
labels ``entry`` and ``backend`` ("cuda" / "torch") and the call's CUDA
launches as ``kernel_launches``.

The reference pads P to a kernel block multiple and trims on return; its
padded packets never reach an output.  Neither version here needs the
padding: the plain version works per packet and the CUDA kernels mask by
P.  Outputs keep the reference's types: int32 order, rank and BT, uint8
stream.  Packets of another integer dtype are cast to int32 first, as the
reference does.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from .. import _collectives
from .. import _obs_hooks as _obs
from ..core.bt import wrap_int32
from .axes import (
    ActivityOut,
    CodecVariant,
    Variant,
    bt_axes_activity_cuda,
    bt_axes_cuda,
    bt_axes_plain,
    max_partitions,
    psu_stream_cuda,
    psu_stream_plain,
    validate_axes_call,
    validate_stream_call,
    validate_variants,
)
from ._build import DTYPE_CODES
from .backend import resolve_device, use_kernel
from .btcount import bt_count_cuda, bt_count_plain
from .psu import check_key, psu_sort_cuda, psu_sort_plain
from .quantize import check_block, quantize_egress_cuda, quantize_egress_plain

__all__ = [
    "psu_sort",
    "psu_reorder",
    "psu_stream",
    "PsuStreamResult",
    "AxesActivity",
    "LinkActivity",
    "bt_count",
    "bt_count_axes",
    "bt_count_axes_sharded",
    "bt_count_links",
    "bt_count_variants",
    "bt_count_codecs",
    "quantize_egress",
]


def _probe(entry: str, cuda: bool, launches: int, shape, **data):
    """The ``kernel.dispatch`` span of one public entry point call; the
    payload is built only while something collects."""
    if not _obs.active():
        return _obs.span("kernel.dispatch")
    return _obs.span(
        "kernel.dispatch", entry=entry, backend="cuda" if cuda else "torch",
        kernel_launches=launches if cuda else 0, shape=tuple(int(d) for d in shape), **data,
    )


def _kernel_dtype(x: torch.Tensor) -> torch.Tensor:
    """uint8 and int32 go to the kernels as they are; other integer
    dtypes are widened to int32 (the reference's ``astype(int32)``)."""
    x = x if x.dtype in DTYPE_CODES else x.to(torch.int32)
    return x.contiguous()


def psu_sort(
    packets: torch.Tensor, width: int = 8, k: int | None = None,
    descending: bool = False, backend: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(order, rank) of each (P, N) packet by (approximate) popcount."""
    check_key(width, k)
    cuda = use_kernel(packets, backend)
    with _probe("psu_sort", cuda, int(packets.numel() > 0), packets.shape, width=width, k=k):
        if cuda:
            return psu_sort_cuda(_kernel_dtype(packets), width=width, k=k, descending=descending)
        return psu_sort_plain(packets, width=width, k=k, descending=descending)


def psu_reorder(
    packets: torch.Tensor, width: int = 8, k: int | None = None,
    descending: bool = False, backend: str | None = None,
) -> torch.Tensor:
    """Packets with elements in PSU transmit order (gather by ``order``)."""
    order, _ = psu_sort(packets, width=width, k=k, descending=descending, backend=backend)
    return torch.gather(packets, -1, order.to(torch.int64))


def _paired(inputs, weights, weight_lanes, input_lanes):
    """The reference's (weights, weight_lanes) defaulting: no weights frame
    the inputs alone unless ``weight_lanes`` is given (then zero weights
    fill those lanes); given weights default to the symmetric framing."""
    if weights is None:
        weight_lanes = 0 if weight_lanes is None else weight_lanes
        if weight_lanes:
            weights = torch.zeros_like(inputs)
    elif weight_lanes is None:
        weight_lanes = input_lanes
    if weights is not None and weights.shape != inputs.shape:
        raise ValueError(f"paired shapes differ: {tuple(inputs.shape)} vs {tuple(weights.shape)}")
    return weights, weight_lanes


class PsuStreamResult(NamedTuple):
    """Everything the fused TX pipeline produces in one kernel launch."""

    order: torch.Tensor  # (P, N) int32: input index transmitted j-th
    rank: torch.Tensor  # (P, N) int32: output slot of input element i
    stream: torch.Tensor  # (P*F, lanes) uint8 packed flit rows
    bt_input: torch.Tensor  # int32 scalar: input-side bit transitions
    bt_weight: torch.Tensor  # int32 scalar: weight-side bit transitions


def psu_stream(
    inputs: torch.Tensor,
    weights: torch.Tensor | None = None,
    width: int = 8,
    k: int | None = None,
    descending: bool = False,
    input_lanes: int = 8,
    weight_lanes: int | None = None,
    pack: str = "lane",
    backend: str | None = None,
) -> PsuStreamResult:
    """Fused popcount-sort -> reorder -> flit-pack -> BT count.

    ``weights=None`` frames the inputs alone (``weight_lanes`` 0) unless
    ``weight_lanes`` is given, in which case zero weights fill those lanes,
    as in the reference.
    """
    weights, weight_lanes = _paired(inputs, weights, weight_lanes, input_lanes)
    if inputs.dim() != 2:
        raise ValueError(f"psu_stream needs (P, N) packets, got {tuple(inputs.shape)}")
    validate_stream_call(
        inputs.shape[1], config=CodecVariant("acc" if k is None else "app", k, descending),
        width=width, input_lanes=input_lanes, weight_lanes=weight_lanes, pack=pack,
    )
    kw = dict(
        width=width, k=k, descending=descending, input_lanes=input_lanes,
        weight_lanes=weight_lanes, pack=pack,
    )
    cuda = use_kernel(inputs, backend)
    with _probe("psu_stream", cuda, int(inputs.numel() > 0), inputs.shape, width=width, k=k,
                pack=pack):
        if cuda:
            x = _kernel_dtype(inputs)
            w = weights.to(x.dtype).contiguous() if weight_lanes else None
            return PsuStreamResult(*psu_stream_cuda(x, w, **kw))
        return PsuStreamResult(*psu_stream_plain(inputs, weights, **kw))


def bt_count(
    stream: torch.Tensor, width: int = 8, backend: str | None = None
) -> torch.Tensor:
    """Total bit transitions of a (T, L) flit stream (int32 scalar)."""
    cuda = use_kernel(stream, backend)
    launches = int(stream.dim() == 2 and stream.shape[0] >= 2 and stream.shape[1] > 0)
    with _probe("bt_count", cuda, launches, stream.shape, width=width):
        if cuda:
            if stream.dtype not in DTYPE_CODES:
                stream = stream.to(torch.int32)
            if stream.shape[1] > 1 and stream.stride(1) != 1:
                stream = stream.contiguous()
            return bt_count_cuda(stream, width=width)
        return bt_count_plain(stream, width=width)




class AxesActivity(NamedTuple):
    """:func:`bt_count_axes` result with per-wire switching activity.

    Wires: ``lanes * 8`` data wires first (wire = lane * 8 + bit, LSB
    first), then ``PMAX`` invert-line wires (only the first ``partitions``
    of a bus-invert config ever toggle).
    """

    bt: torch.Tensor  # (L, C, 3) per-link, per-config BT totals
    toggles: torch.Tensor  # (L, C, NW, WIRES) toggle counts per time window
    ones: torch.Tensor  # (L, C, WIRES) flit rows each wire spent at level 1


class LinkActivity(NamedTuple):
    """:func:`bt_count_links` result with per-wire switching activity."""

    bt: torch.Tensor  # (L, 2) per-link (input, weight) BT totals
    toggles: torch.Tensor  # (L, NW, lanes*8)
    ones: torch.Tensor  # (L, lanes*8)


def _measure_axes(inputs, weights, valid, *, configs, width, input_lanes, weight_lanes,
                  split_lanes, pack, cuda, chunk_packets, activity_windows):
    """The checked multi-axis measurement behind every BT entry point:
    one call of the plain version or of the CUDA kernels per chunk,
    threading the carry; (L, C, 3) totals or :class:`AxesActivity`."""
    links, p, n = inputs.shape
    configs, split_lanes = validate_axes_call(
        n, configs=configs, width=width, input_lanes=input_lanes,
        weight_lanes=weight_lanes, split_lanes=split_lanes, pack=pack,
    )
    dev = inputs.device
    flits, lanes, nc = n // input_lanes, input_lanes + weight_lanes, len(configs)
    toggles = ones = None  # the activity sums every chunk adds into
    if activity_windows is not None:
        nwires = lanes * 8 + max_partitions(configs, lanes)
        nw = -(-(p * flits) // activity_windows)
        toggles = torch.zeros((links, nc, nw, nwires), dtype=torch.int32, device=dev)
        ones = torch.zeros((links, nc, nwires), dtype=torch.int32, device=dev)
    if links == 0 or p == 0:
        bt = torch.zeros((links, nc, 3), dtype=torch.int32, device=dev)
        return bt if toggles is None else AxesActivity(bt, toggles, ones)
    if valid is None:
        valid = torch.full((links,), p, dtype=torch.int32, device=dev)
    else:
        valid = torch.as_tensor(valid, device=dev).to(torch.int32).clamp(0, p)
    if valid.shape != (links,):
        raise ValueError(f"valid must be ({links},), got {tuple(valid.shape)}")
    kw = dict(
        configs=configs, width=width, input_lanes=input_lanes,
        weight_lanes=weight_lanes, split_lanes=split_lanes, pack=pack,
    )
    if cuda:
        inputs = _kernel_dtype(inputs)
        weights = weights.to(inputs.dtype).contiguous() if weight_lanes else None
    step = p if chunk_packets is None else min(chunk_packets, p)
    total, carry = None, None
    for p0 in range(0, p, step):
        x = inputs[:, p0: p0 + step]
        w = weights[:, p0: p0 + step] if weight_lanes else None
        vc = valid if step == p else (valid - p0).clamp(0, x.shape[1])
        into = None if toggles is None else ActivityOut(
            toggles, ones, activity_windows, p0 * flits
        )
        if cuda:
            w = w.contiguous() if w is not None else None
            if into is None:
                bt, carry = bt_axes_cuda(x.contiguous(), w, vc, carry=carry, **kw)
            else:
                bt, carry = bt_axes_activity_cuda(
                    x.contiguous(), w, vc, carry=carry, activity=into, **kw
                )
        else:
            bt, carry = bt_axes_plain(x, w, vc, carry=carry, activity=into, **kw)
        # int32 totals wrap like the reference's
        total = bt if total is None else wrap_int32(total.to(torch.int64) + bt)
    return total if toggles is None else AxesActivity(total, toggles, ones)


def _launches(cuda: bool, links: int, p: int, chunk: int | None) -> int:
    """CUDA launches of one measurement: one per chunk of a non-empty batch."""
    if not cuda or links == 0 or p == 0:
        return 0
    return 1 if chunk is None else -(-p // min(chunk, p))


def bt_count_axes(
    inputs: torch.Tensor,
    weights: torch.Tensor | None = None,
    valid: torch.Tensor | Sequence[int] | None = None,
    configs: tuple[CodecVariant, ...] = (CodecVariant(),),
    width: int = 8,
    input_lanes: int = 8,
    weight_lanes: int | None = None,
    split_lanes: int | None = None,
    pack: str = "lane",
    backend: str | None = None,
    chunk_packets: int | None = None,
    activity_windows: int | None = None,
) -> torch.Tensor | AxesActivity:
    """The multi-axis measurement: per-link, per-(ordering, codec) config
    BT of an (L, P, N) packet batch.

    ``valid`` gives each link's real packet count (default all P; clamped
    to [0, P]); rows past it count nothing, data or invert line.
    ``split_lanes`` is the lane where the input side ends (default
    ``input_lanes``).  ``chunk_packets`` measures the packet axis in chunks
    of that many packets, one launch each, threading the carry (started,
    last wire flit, last invert states, wire parities) from chunk to
    chunk; the result is the same for any chunk size.  On a CUDA tensor
    each chunk is one launch of the ``bt_axes`` kernels, or of the
    ``bt_axes_activity`` kernels with ``activity_windows``.

    ``activity_windows`` (flit rows per window, >= 1) also measures every
    wire: the result is then :class:`AxesActivity` with ``toggles`` of
    shape (L, C, ceil(P*F / activity_windows), lanes*8 + PMAX) — the
    toggle at the boundary into global flit row r counts in window
    r // activity_windows — and ``ones``, each wire's valid rows at level
    1, of shape (L, C, lanes*8 + PMAX).

    Returns int32 (L, C, 3): input-side, weight-side and invert-line BT.
    """
    if inputs.dim() != 3:
        raise ValueError(f"expected (L, P, N) packets, got {tuple(inputs.shape)}")
    if chunk_packets is not None and chunk_packets < 1:
        raise ValueError(f"chunk_packets must be >= 1, got {chunk_packets}")
    if activity_windows is not None and activity_windows < 1:
        raise ValueError(f"activity_windows must be >= 1, got {activity_windows}")
    weights, weight_lanes = _paired(inputs, weights, weight_lanes, input_lanes)
    links, p, _ = inputs.shape
    cuda = use_kernel(inputs, backend)
    configs = tuple(configs)
    with _probe("bt_count_axes", cuda, _launches(cuda, links, p, chunk_packets), inputs.shape,
                configs=len(configs), width=width, chunked=chunk_packets is not None,
                activity=activity_windows is not None):
        return _measure_axes(
            inputs, weights, valid, configs=configs, width=width, input_lanes=input_lanes,
            weight_lanes=weight_lanes, split_lanes=split_lanes, pack=pack, cuda=cuda,
            chunk_packets=chunk_packets, activity_windows=activity_windows,
        )


def bt_count_axes_sharded(
    inputs: torch.Tensor,
    weights: torch.Tensor | None = None,
    valid: torch.Tensor | Sequence[int] | None = None,
    configs: tuple[CodecVariant, ...] = (CodecVariant(),),
    width: int = 8,
    input_lanes: int = 8,
    weight_lanes: int | None = None,
    split_lanes: int | None = None,
    pack: str = "lane",
    backend: str | None = None,
    chunk_packets: int | None = None,
    activity_windows: int | None = None,
    group=None,
) -> torch.Tensor | AxesActivity:
    """:func:`bt_count_axes` with the LINK axis split over the ranks of a
    ``torch.distributed`` process ``group`` (None: one rank, no collective).

    Every rank passes the whole batch.  The links are padded to a multiple
    of the group's size with ``valid = 0`` links, whose rows count nothing,
    so the padding is exact; rank r measures the r-th contiguous block of
    links with :func:`bt_count_axes` (one ``bt_axes`` or
    ``bt_axes_activity`` launch per chunk on a CUDA tensor, the plain
    version on a CPU one), scatters it into a zero table of all the links,
    and one SUM ``all_reduce`` per output assembles the (L, C, 3) table
    (and the activity tensors) on every rank.  Each link's result
    is its unsharded one, bit for bit: a link's measurement never crosses
    a block boundary.
    """
    if inputs.dim() != 3:
        raise ValueError(f"expected (L, P, N) packets, got {tuple(inputs.shape)}")
    links, p, _ = inputs.shape
    dev = inputs.device
    if group is None:
        nd, me = 1, 0
    else:
        import torch.distributed as dist

        nd, me = dist.get_world_size(group), dist.get_rank(group)
    if valid is None:
        valid = torch.full((links,), p, dtype=torch.int32, device=dev)
    else:
        valid = torch.as_tensor(valid, device=dev).to(torch.int32).clamp(0, p)
    if valid.shape != (links,):
        raise ValueError(f"valid must be ({links},), got {tuple(valid.shape)}")
    ltot = links + (-links) % nd
    shard = ltot // nd
    lo, hi = me * shard, min((me + 1) * shard, links)
    real = max(hi - lo, 0)

    def block(t):  # this rank's links, padded with zero links to ``shard``
        if t is None:
            return None
        mine = t[lo: lo + real]
        if real == shard:
            return mine
        return torch.cat([mine, mine.new_zeros((shard - real,) + tuple(t.shape[1:]))])

    out = bt_count_axes(
        block(inputs), block(weights), block(valid), configs=configs, width=width,
        input_lanes=input_lanes, weight_lanes=weight_lanes, split_lanes=split_lanes, pack=pack,
        backend=backend, chunk_packets=chunk_packets, activity_windows=activity_windows,
    )
    if group is None:
        return out

    def assemble(arr):
        full = arr.new_zeros((ltot,) + tuple(arr.shape[1:]))
        full[lo: lo + shard] = arr
        dist.all_reduce(full, group=group)
        _collectives.note("all-reduce", full.numel() * full.element_size(), group)
        return full[:links]

    if activity_windows is None:
        return assemble(out)
    return AxesActivity(*(assemble(o) for o in out))


def bt_count_links(
    streams: torch.Tensor,
    input_lanes: int | None = None,
    lengths: torch.Tensor | Sequence[int] | None = None,
    width: int = 8,
    backend: str | None = None,
    chunk_rows: int | None = None,
    activity_windows: int | None = None,
) -> torch.Tensor | LinkActivity:
    """Per-link (input-side, weight-side) BT of an (L, T, lanes) batch of
    flit streams, int32 (L, 2): each flit row is one packet of the
    multi-axis measurement with the identity ordering.  ``lengths`` gives
    each link's real flit count (rows past it count nothing, whatever they
    hold); ``input_lanes`` (default all) is where the input side ends.
    ``activity_windows`` also measures every data wire: the result is then
    :class:`LinkActivity` with ``toggles`` (L, ceil(T / activity_windows),
    lanes*8) and ``ones`` (L, lanes*8)."""
    if activity_windows is not None and activity_windows < 1:
        raise ValueError(f"activity_windows must be >= 1, got {activity_windows}")
    if chunk_rows is not None and chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    links, t, lanes = streams.shape
    if input_lanes is None:
        input_lanes = lanes
    if not 0 <= input_lanes <= lanes:
        raise ValueError(f"input_lanes={input_lanes} outside the {lanes}-lane flit")
    dev = streams.device
    if links == 0 or t == 0 or (t < 2 and activity_windows is None):
        bt = torch.zeros((links, 2), dtype=torch.int32, device=dev)
        if activity_windows is None:
            return bt
        nw = -(-t // activity_windows)
        return LinkActivity(
            bt, torch.zeros((links, nw, lanes * 8), dtype=torch.int32, device=dev),
            torch.zeros((links, lanes * 8), dtype=torch.int32, device=dev),
        )
    cuda = use_kernel(streams, backend)
    with _probe("bt_count_links", cuda, _launches(cuda, links, t, chunk_rows), streams.shape,
                width=width, chunked=chunk_rows is not None,
                activity=activity_windows is not None):
        out = _measure_axes(
            streams, None, lengths, configs=(CodecVariant("none"),), width=width,
            input_lanes=lanes, weight_lanes=0, split_lanes=input_lanes, pack="row",
            cuda=cuda, chunk_packets=chunk_rows, activity_windows=activity_windows,
        )
    if activity_windows is None:
        return out[:, 0, :2]
    # one uncoded config: drop the config axis and the (zero) invert-line wire
    return LinkActivity(
        out.bt[:, 0, :2], out.toggles[:, 0, :, : lanes * 8], out.ones[:, 0, : lanes * 8]
    )


def bt_count_variants(
    inputs: torch.Tensor,
    weights: torch.Tensor | None = None,
    variants: tuple[Variant, ...] = (Variant("acc"),),
    width: int = 8,
    input_lanes: int = 8,
    weight_lanes: int | None = None,
    pack: str = "lane",
    backend: str | None = None,
    chunk_packets: int | None = None,
) -> torch.Tensor:
    """Ordered BT of (P, N) packets under many uncoded orderings: int32
    (V, 2) (input-side, weight-side), one measurement for all of them."""
    variants = validate_variants(tuple(variants), width)
    weights, weight_lanes = _paired(inputs, weights, weight_lanes, input_lanes)
    out = bt_count_axes(
        inputs[None], None if weights is None else weights[None], None,
        configs=tuple(CodecVariant(v.key, v.k, v.descending) for v in variants),
        width=width, input_lanes=input_lanes, weight_lanes=weight_lanes, pack=pack,
        backend=backend, chunk_packets=chunk_packets,
    )
    return out[0, :, :2]


def bt_count_codecs(
    inputs: torch.Tensor,
    weights: torch.Tensor | None = None,
    configs: tuple[CodecVariant, ...] = (CodecVariant(),),
    width: int = 8,
    input_lanes: int = 8,
    weight_lanes: int | None = None,
    pack: str = "lane",
    backend: str | None = None,
    chunk_packets: int | None = None,
    activity_windows: int | None = None,
) -> torch.Tensor | AxesActivity:
    """Coded and ordered BT of (P, N) packets under many (ordering, codec)
    configs: int32 (C, 3) (input-side, weight-side, invert-line), one
    measurement for all of them.  With ``activity_windows`` the result is
    :class:`AxesActivity` without the link axis: bt (C, 3), toggles
    (C, NW, WIRES), ones (C, WIRES)."""
    weights, weight_lanes = _paired(inputs, weights, weight_lanes, input_lanes)
    out = bt_count_axes(
        inputs[None], None if weights is None else weights[None], None,
        configs=tuple(configs), width=width, input_lanes=input_lanes,
        weight_lanes=weight_lanes, pack=pack, backend=backend,
        chunk_packets=chunk_packets, activity_windows=activity_windows,
    )
    if activity_windows is None:
        return out[0]
    return AxesActivity(out.bt[0], out.toggles[0], out.ones[0])


def quantize_egress(
    x, block: int = 256, backend: str | None = None
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Blockwise int8 quantization of a flat vector (pads internally).

    Returns (q, scales, padded_size): int8 codes and float32 scales of the
    vector zero-padded to ``padded_size``, the next multiple of ``block``;
    callers keep ``padded_size`` to dequantize and trim.  Unlike the
    reference's 0-d int32 array, ``padded_size`` is a Python int.  A
    non-tensor ``x`` is put on ``cuda`` first (``resolve_device``).
    """
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, device=resolve_device())
    if x.dim() != 1:
        raise ValueError(f"quantize_egress needs a flat (M,) vector, got {tuple(x.shape)}")
    check_block(block)
    m = int(x.shape[0])
    padded = m + (-m) % block
    cuda = use_kernel(x, backend)
    with _probe("quantize_egress", cuda, int(padded > 0), x.shape, elems=m, block=block):
        x = x.to(torch.float32)
        if cuda:
            q, scales = quantize_egress_cuda(x.contiguous(), block=block)
        else:
            q, scales = quantize_egress_plain(x, block=block)
    return q, scales, padded
