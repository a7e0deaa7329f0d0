"""Ordering vs coding vs ordering∘coding — the comparison tables.

Counterpart of ``repro.codec.compare``.  ``compare_streams`` scores every
(ordering, codec) pair of a grid on the same packet streams with ONE
``bt_count_codecs`` measurement per stream (on a CUDA tensor, one launch
of the ``bt_axes`` kernels per stream, or per chunk with
``chunk_packets``); every reduction is net of overhead — invert-line
transitions count against a codec, and the baseline is the unordered,
uncoded wire.  Each stream fires a ``codec.stream`` probe event with its
baseline BT (``repro_torch.obs``; read from the totals already on the
host).  :func:`demo_workloads` gives the repo's three traffic
families (conv patches, a decode weight image, an all-reduce gradient
image) from a numpy seed.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from .. import _obs_hooks as _obs
from ..kernels import CodecVariant, Variant, bt_count_codecs
from ..kernels.backend import resolve_device
from ..link import LinkPowerModel, tensor_flit_stream
from ..traffic.ordering import int8_view
from .overhead import codec_overhead
from .schemes import codec_by_name

__all__ = ["ComparisonRow", "compare_streams", "format_table", "demo_workloads"]

_BASELINE = Variant("none", None, False)


@dataclasses.dataclass(frozen=True)
class ComparisonRow:
    """One (ordering, codec) pair scored on one workload's streams."""

    workload: str
    ordering: str  # compact ordering label ('none', 'acc', 'app4', ...)
    codec: str
    data_bt: int
    aux_bt: int  # invert-line transitions (the codec's own switching)
    num_flits: int
    extra_wires: int
    data_wires: int
    bt_reduction: float  # net of overhead, vs the unordered uncoded wire
    power_reduction: float  # Fig. 6/7 transfer of bt_reduction
    energy_pj: float  # coded stream energy incl. widened static floor

    @property
    def gross_bt(self) -> int:
        """Data BT plus invert-line BT — what the reduction is scored on."""
        return self.data_bt + self.aux_bt

    @property
    def label(self) -> str:
        if self.codec == "none":
            return self.ordering
        return f"{self.ordering}+{self.codec}"


def _ordering_label(v: Variant) -> str:
    head = f"app{v.k}" if v.key == "app" else v.key
    return head + ("-desc" if v.descending else "")


def _as_variant(ordering) -> Variant:
    if isinstance(ordering, str):
        return Variant(ordering, None, False)
    return Variant(*ordering)


def compare_streams(
    streams: Sequence[torch.Tensor | np.ndarray],
    lanes: int,
    *,
    orderings: Sequence[Variant | str] = ("none", Variant("acc"), Variant("app", 4)),
    codecs: Sequence[str] = ("none", "bus_invert"),
    width: int = 8,
    power: LinkPowerModel | None = None,
    workload: str = "stream",
    backend: str | None = None,
    chunk_packets: int | None = None,
    device: str | torch.device | None = None,
) -> tuple[ComparisonRow, ...]:
    """Score every (ordering, codec) pair on the same packet streams.

    ``streams`` are (P, elems) byte-packet arrays, measured independently
    and summed; tensors stay on their device, numpy arrays go to
    ``device`` (``cuda`` unless named).  ``lanes`` is the byte width of
    each flit, ``orderings`` ``Variant`` configs or bare key strings,
    ``codecs`` registered codec names.  Returns one row per pair in grid
    order, the unordered uncoded baseline (always measured, prepended if
    absent) first among equals with ``bt_reduction == 0``.
    """
    power = power if power is not None else LinkPowerModel()
    pairs = [(_as_variant(o), c) for o in orderings for c in codecs]
    if (_BASELINE, "none") not in pairs:
        pairs.insert(0, (_BASELINE, "none"))
    configs = tuple(
        CodecVariant(o.key, o.k, o.descending, codec_by_name(c).scheme,
                     codec_by_name(c).partition)
        for o, c in pairs
    )
    totals = np.zeros((len(configs), 3), dtype=np.int64)
    num_flits = 0
    for si, s in enumerate(streams):
        if not isinstance(s, torch.Tensor):
            s = torch.from_numpy(np.ascontiguousarray(s)).to(resolve_device(device))
        if s.dim() != 2 or s.shape[-1] % lanes != 0:
            raise ValueError(
                f"streams must be (P, elems) with elems divisible by lanes={lanes}, "
                f"got {tuple(s.shape)}"
            )
        per_stream = bt_count_codecs(
            s, None, configs=configs, width=width, input_lanes=lanes, backend=backend,
            chunk_packets=chunk_packets,
        )
        per_stream = per_stream.cpu().numpy().astype(np.int64)
        totals += per_stream
        if _obs.active():
            # baseline (unordered, uncoded) data BT of this one stream
            _obs.event(
                "codec.stream", workload=workload, stream=f"{workload}[{si}]",
                bt=int(per_stream[pairs.index((_BASELINE, "none"))][:2].sum()),
                packets=int(s.shape[0]),
            )
        num_flits += int(s.shape[0]) * (int(s.shape[-1]) // lanes)

    base = int(totals[pairs.index((_BASELINE, "none"))][:2].sum())
    rows = []
    for (o, c), (bt_i, bt_w, aux) in zip(pairs, totals.tolist()):
        data_bt = int(bt_i) + int(bt_w)
        ov = codec_overhead(c, lanes)
        red = 1.0 - (data_bt + int(aux)) / max(base, 1)
        rows.append(ComparisonRow(
            workload=workload,
            ordering=_ordering_label(o),
            codec=c,
            data_bt=data_bt,
            aux_bt=int(aux),
            num_flits=num_flits,
            extra_wires=ov.extra_wires,
            data_wires=ov.data_wires,
            bt_reduction=red,
            power_reduction=power.power_reduction(red),
            energy_pj=power.coded_link_energy_pj(
                data_bt, int(aux), num_flits, ov.data_wires, ov.extra_wires
            ),
        ))
    return tuple(rows)


def format_table(rows: Sequence[ComparisonRow]) -> str:
    """Aligned text table of comparison rows."""
    head = (
        f"{'workload':10s} {'config':22s} {'data BT':>10s} {'aux BT':>8s} "
        f"{'+wires':>6s} {'net red':>8s} {'power red':>9s} {'energy pJ':>11s}"
    )
    lines = [head, "-" * len(head)]
    for r in rows:
        lines.append(
            f"{r.workload:10s} {r.label:22s} {r.data_bt:10d} {r.aux_bt:8d} "
            f"{r.extra_wires:6d} {100 * r.bt_reduction:7.2f}% "
            f"{100 * r.power_reduction:8.2f}% {r.energy_pj:11.0f}"
        )
    return "\n".join(lines)


def demo_workloads(
    elems: int = 64,
    images: int = 4,
    weight_shape: tuple[int, int] = (96, 256),
    grad_size: int = 1 << 14,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> Mapping[str, tuple[torch.Tensor, ...]]:
    """The repo's three traffic families as (P, elems) uint8 packet
    streams on ``device`` (``cuda`` unless named), the same bytes as the
    reference's for the same arguments:

      * ``conv`` — spatially-correlated im2col patch packets;
      * ``decode`` — a weight matrix's int8 HBM image;
      * ``allreduce`` — an int8 gradient wire image.
    """
    rng = np.random.default_rng(seed)
    hw, kernel = 32, 5
    imgs = rng.normal(size=(images, hw, hw))
    for _ in range(2):
        imgs = (
            imgs
            + np.roll(imgs, 1, 1)
            + np.roll(imgs, -1, 1)
            + np.roll(imgs, 1, 2)
            + np.roll(imgs, -1, 2)
        ) / 5
    thr = np.quantile(imgs, 0.55, axis=(1, 2), keepdims=True)
    v = np.clip(imgs - thr, 0, None)
    v = (v / (v.max(axis=(1, 2), keepdims=True) + 1e-9) * 255).astype(np.uint8)
    out = hw - kernel + 1
    patches = np.lib.stride_tricks.sliding_window_view(
        v, (kernel, kernel), axis=(1, 2)
    ).reshape(images * out * out, kernel * kernel)
    conv = tensor_flit_stream(torch.from_numpy(patches.reshape(-1)), elems)

    wmat = rng.normal(size=weight_shape).astype(np.float32)
    decode = tensor_flit_stream(int8_view(torch.from_numpy(wmat)).to(torch.uint8).reshape(-1),
                                elems)
    grad = (rng.standard_t(df=4, size=grad_size) * 1e-3).astype(np.float32)
    allreduce = tensor_flit_stream(int8_view(torch.from_numpy(grad)).to(torch.uint8), elems)
    dev = resolve_device(device)
    return {
        "conv": (conv.to(dev),),
        "decode": (decode.to(dev),),
        "allreduce": (allreduce.to(dev),),
    }
