"""The fused transmit stream (the multi-axis BT core's ``emit_stream``
mode): plain PyTorch version and the CUDA kernel's wrapper.

Replaces ``repro/kernels/axes.py:bt_axes_pallas`` in its ``emit_stream``
mode only — one link, one uncoded 'acc'/'app' config (body
``_bt_axes_kernel`` -> ``_axes_block``, with the inter-block fold
``repro/kernels/ops.py:_fold_axes``).  The jagged link axis, the other
orderings, the codecs and the activity windows are later slices.

The CUDA kernel (``csrc/axes.cu``) runs popcount -> bucket -> rank ->
reorder -> flit-pack -> (input, weight) BT in one launch: one warp ranks a
run of packets, scatters each byte straight into its flit cell of a
shared-memory packet image (integer addressing — no float permutation
product, whose TF32 form would round payloads above 2**11), writes the
stream rows out contiguously and counts BT over every flit boundary it
owns, including the one from the previous packet, which the first packet
of a run gets by re-sorting its predecessor.  Bound by bytes on the H100:
each side's packets read once, int32 order and rank and the uint8 stream
written once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ._build import DTYPE_CODES, check, library
from .btcount import bt_count_plain
from .psu import MAX_N, _rank_block, check_key

__all__ = [
    "Variant",
    "CodecVariant",
    "VARIANT_KEYS",
    "validate_variants",
    "validate_stream_call",
    "psu_stream_plain",
    "psu_stream_cuda",
]

VARIANT_KEYS = ("none", "column_major", "acc", "app")


class Variant(NamedTuple):
    """One ordering configuration: key ('none' | 'column_major' | 'acc' |
    'app'), the APP bucket count k (None otherwise) and the direction."""

    key: str = "acc"
    k: int | None = None
    descending: bool = False


class CodecVariant(NamedTuple):
    """One (ordering, codec) configuration.  This slice measures only the
    uncoded ('none') codec; the other schemes are a later slice."""

    key: str = "acc"
    k: int | None = None
    descending: bool = False
    codec: str = "none"
    partition: int | None = None

    @property
    def ordering(self) -> Variant:
        return Variant(self.key, self.k, self.descending)


def validate_variants(variants: tuple[Variant, ...], width: int) -> tuple[Variant, ...]:
    """Check a variant tuple against the kernel's contract."""
    if not variants:
        raise ValueError("need at least one variant")
    out = []
    for v in variants:
        v = Variant(*v)
        if v.key not in VARIANT_KEYS:
            raise ValueError(f"unknown variant key {v.key!r}; choose from {VARIANT_KEYS}")
        if v.key == "app":
            if v.k is None or not 1 <= v.k <= width + 1:
                raise ValueError(f"variant {v}: 'app' needs k in [1, {width + 1}]")
        elif v.k is not None:
            raise ValueError(f"variant {v}: k is only meaningful for 'app'")
        if v.descending and v.key not in ("acc", "app"):
            raise ValueError(f"variant {v}: descending applies to sorted keys only")
        out.append(v)
    return tuple(out)


def validate_stream_call(
    n: int, *, config: CodecVariant, width: int, input_lanes: int,
    weight_lanes: int, pack: str,
) -> None:
    """The emit-stream contract: one uncoded 'acc'/'app' config, packets
    of whole flits, a symmetric (or absent) weight side, 'lane'/'row'
    packing."""
    (v,) = validate_variants((CodecVariant(*config).ordering,), width)
    if config.codec != "none" or v.key not in ("acc", "app"):
        raise ValueError(f"the fused stream needs one uncoded 'acc'/'app' config, got {config}")
    check_key(width, v.k)
    if input_lanes < 1 or n % input_lanes != 0:
        raise ValueError(f"packet size {n} not divisible by input_lanes={input_lanes}")
    if weight_lanes not in (0, input_lanes):
        raise ValueError(
            "the fused stream needs a symmetric (or absent) weight side: "
            f"weight_lanes={weight_lanes} vs input_lanes={input_lanes}"
        )
    if pack not in ("lane", "row"):
        raise ValueError(f"the fused stream packs 'lane'|'row', got {pack!r}")


def _flit(values: torch.Tensor, lanes: int, pack: str) -> torch.Tensor:
    """(P, N) sorted payloads -> (P, F, lanes) flit halves."""
    p, n = values.shape
    if pack == "lane":
        return values.reshape(p, lanes, n // lanes).transpose(1, 2)
    return values.reshape(p, n // lanes, lanes)


def psu_stream_plain(
    x: torch.Tensor, w: torch.Tensor, *, width: int, k: int | None,
    descending: bool, input_lanes: int, weight_lanes: int, pack: str,
):
    """(order, rank, stream, bt_input, bt_weight) of (P, N) paired packets.

    ``weight_lanes == 0`` frames the inputs alone (``w`` is ignored).
    The stream is (P*F, lanes) uint8; BT is int32 over every flit boundary.
    """
    x = x.to(torch.int32)
    rank = _rank_block(x, width=width, k=k, descending=descending)
    order = torch.argsort(rank, dim=-1, stable=True)
    halves = [_flit(torch.gather(x, -1, order), input_lanes, pack)]
    if weight_lanes:
        ws = torch.gather(w.to(torch.int32), -1, order)
        halves.append(_flit(ws, weight_lanes, pack))
    p, n = x.shape
    lanes = input_lanes + weight_lanes
    stream = (torch.cat(halves, dim=-1).reshape(p * (n // input_lanes), lanes) & 0xFF)
    stream = stream.to(torch.uint8)
    bt_in = bt_count_plain(stream[:, :input_lanes], width=8)
    bt_w = bt_count_plain(stream[:, input_lanes:], width=8)
    return order.to(torch.int32), rank, stream, bt_in, bt_w


def psu_stream_cuda(
    x: torch.Tensor, w: torch.Tensor | None, *, width: int, k: int | None,
    descending: bool, input_lanes: int, weight_lanes: int, pack: str,
):
    """The same five outputs from the CUDA kernel, one launch.  ``x`` and
    ``w`` are contiguous uint8 or int32 (P, N) packets of one dtype on a
    CUDA device (``w`` may be None when ``weight_lanes == 0``)."""
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"psu_stream_cuda needs contiguous (P, N) packets, got {tuple(x.shape)}")
    if weight_lanes:
        if w is None or w.shape != x.shape or w.dtype != x.dtype:
            raise ValueError("psu_stream_cuda needs weights shaped and typed like the inputs")
        if w.device != x.device or not w.is_contiguous():
            raise ValueError("psu_stream_cuda needs contiguous weights on the inputs' device")
    p, n = x.shape
    if not 1 <= n <= MAX_N:
        raise ValueError(f"psu_stream_cuda takes 1 <= N <= {MAX_N}, got N={n}")
    config = CodecVariant("acc" if k is None else "app", k, descending)
    validate_stream_call(
        n, config=config, width=width, input_lanes=input_lanes,
        weight_lanes=weight_lanes, pack=pack,
    )
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"psu_stream_cuda takes uint8 or int32 packets, got {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"psu_stream_cuda needs CUDA tensors, got {x.device}")
    flits, lanes = n // input_lanes, input_lanes + weight_lanes
    order = torch.empty((p, n), dtype=torch.int32, device=x.device)
    rank = torch.empty_like(order)
    stream = torch.empty((p * flits, lanes), dtype=torch.uint8, device=x.device)
    bt = torch.zeros(2, dtype=torch.int32, device=x.device)
    if p > 0:
        with torch.cuda.device(x.device):
            err = library().repro_psu_stream(
                x.data_ptr(), w.data_ptr() if weight_lanes else None,
                DTYPE_CODES[x.dtype], p, n, width, 0 if k is None else k,
                int(descending), input_lanes, weight_lanes, int(pack == "row"),
                order.data_ptr(), rank.data_ptr(), stream.data_ptr(),
                bt.data_ptr(), torch.cuda.current_stream().cuda_stream,
            )
        check(err, "repro_psu_stream")
        psu_stream_cuda.launches += 1
    return order, rank, stream, bt[0], bt[1]


psu_stream_cuda.launches = 0
