"""Public kernel entry points, dispatched by the tensor's device.

Counterpart of the main-path subset of ``repro/kernels/ops.py``:
``psu_sort`` / ``psu_reorder`` (``ops.py:165-238``), ``psu_stream`` and
``PsuStreamResult`` (``ops.py:684-804``) and ``bt_count``
(``ops.py:807-835``).  A CUDA tensor launches the hand-written kernel, a
CPU tensor takes the plain version, ``backend="torch"`` forces the plain
version (``backend.py``).

The reference pads P to a kernel block multiple and trims on return; its
padded packets never reach an output.  Neither version here needs the
padding: the plain version works per packet and the CUDA kernels mask by
P.  Outputs keep the reference's types: int32 order, rank and BT, uint8
stream.  Packets of another integer dtype are cast to int32 first, as the
reference does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .axes import CodecVariant, psu_stream_cuda, psu_stream_plain, validate_stream_call
from ._build import DTYPE_CODES
from .backend import use_kernel
from .btcount import bt_count_cuda, bt_count_plain
from .psu import check_key, psu_sort_cuda, psu_sort_plain

__all__ = ["psu_sort", "psu_reorder", "psu_stream", "PsuStreamResult", "bt_count"]


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
    if use_kernel(packets, backend):
        return psu_sort_cuda(_kernel_dtype(packets), width=width, k=k, descending=descending)
    return psu_sort_plain(packets, width=width, k=k, descending=descending)


def psu_reorder(
    packets: torch.Tensor, width: int = 8, k: int | None = None,
    descending: bool = False, backend: str | None = None,
) -> torch.Tensor:
    """Packets with elements in PSU transmit order (gather by ``order``)."""
    order, _ = psu_sort(packets, width=width, k=k, descending=descending, backend=backend)
    return torch.gather(packets, -1, order.to(torch.int64))


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
    if weights is None:
        weight_lanes = 0 if weight_lanes is None else weight_lanes
        if weight_lanes:
            weights = torch.zeros_like(inputs)
    elif weight_lanes is None:
        weight_lanes = input_lanes
    if weights is not None and weights.shape != inputs.shape:
        raise ValueError(f"paired shapes differ: {tuple(inputs.shape)} vs {tuple(weights.shape)}")
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
    if use_kernel(inputs, backend):
        x = _kernel_dtype(inputs)
        w = weights.to(x.dtype).contiguous() if weight_lanes else None
        return PsuStreamResult(*psu_stream_cuda(x, w, **kw))
    return PsuStreamResult(*psu_stream_plain(inputs, weights, **kw))


def bt_count(
    stream: torch.Tensor, width: int = 8, backend: str | None = None
) -> torch.Tensor:
    """Total bit transitions of a (T, L) flit stream (int32 scalar)."""
    if use_kernel(stream, backend):
        if stream.dtype not in DTYPE_CODES:
            stream = stream.to(torch.int32)
        if stream.shape[1] > 1 and stream.stride(1) != 1:
            stream = stream.contiguous()
        return bt_count_cuda(stream, width=width)
    return bt_count_plain(stream, width=width)
