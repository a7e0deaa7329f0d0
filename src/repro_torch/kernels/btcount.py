"""Bit-transition count of a flit stream: plain PyTorch version and the
CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/btcount.py:bt_count_pallas``
(body ``_bt_kernel``), which reduced per-block int32 partials over two
shifted, padded copies of the stream.  The CUDA kernels
(``csrc/btcount.cu``) read the stream in place and add one int32 partial
per block with ``atomicAdd``.  They are bound by bytes on the H100 (every
stream byte read once for ~1 integer operation); a thread per row pair
with one load per element is bound by load instructions instead, so a
contiguous stream (the egress wire, the scale stream) is counted as a flat
array, s[i] against s[i + L], with 16-byte loads in a persistent grid, and
a row-strided one (the staged TX path's column slices, which need no copy)
with one 4-, 8- or 16-byte vector per row where its alignment allows and a
group of threads per row pair.  One launch per call either way.

Totals are int32 and wrap modulo 2**32 as the reference's int32 sum does.
"""

from __future__ import annotations

import torch

from ..core.bt import wrap_int32
from ._build import DTYPE_CODES, check, library
from .psu import _popcount_bits

__all__ = ["bt_count_plain", "bt_count_cuda", "check_width"]


def check_width(width: int) -> None:
    """Lane widths the count takes: [1, 16] (the reference's SWAR range)."""
    if not 1 <= width <= 16:
        raise ValueError(f"width must be in [1, 16], got {width}")


def bt_count_plain(stream: torch.Tensor, *, width: int = 8) -> torch.Tensor:
    """Total bit transitions of a (T, L) stream: int32 scalar tensor."""
    check_width(width)
    if stream.shape[0] < 2:
        return torch.zeros((), dtype=torch.int32, device=stream.device)
    x = stream.to(torch.int32)
    return wrap_int32(_popcount_bits(x[1:] ^ x[:-1], width).sum(dtype=torch.int64))


def bt_count_cuda(stream: torch.Tensor, *, width: int = 8) -> torch.Tensor:
    """Total bit transitions from the CUDA kernel: a (T, L) uint8 or int32
    stream on a CUDA device whose lanes are contiguous (rows may be
    strided, as a column slice's are)."""
    if stream.dim() != 2:
        raise ValueError(f"bt_count_cuda needs a (T, L) stream, got {tuple(stream.shape)}")
    t, lanes = stream.shape
    if lanes > 1 and stream.stride(1) != 1:
        raise ValueError("bt_count_cuda needs contiguous lanes (stride(1) == 1)")
    check_width(width)
    if stream.dtype not in DTYPE_CODES:
        raise TypeError(f"bt_count_cuda takes uint8 or int32 streams, got {stream.dtype}")
    if stream.device.type != "cuda":
        raise ValueError(f"bt_count_cuda needs a CUDA tensor, got {stream.device}")
    out = torch.zeros((), dtype=torch.int32, device=stream.device)
    if t < 2 or lanes == 0:
        return out
    with torch.cuda.device(stream.device):
        err = library().repro_bt_count(
            stream.data_ptr(), DTYPE_CODES[stream.dtype], t, lanes, stream.stride(0),
            width, out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    check(err, "repro_bt_count")
    bt_count_cuda.launches += 1
    return out


bt_count_cuda.launches = 0
