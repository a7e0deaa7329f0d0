"""The popcount-sorting unit (ACC-PSU / APP-PSU): plain PyTorch version
and the CUDA kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/psu.py:psu_sort_pallas`` (body
``_psu_kernel``; helpers ``_popcount_bits``, ``_rank_from_keys``,
``_rank_block``).  The CUDA kernel (``csrc/psu.cu``) is bound by bytes on
the H100 — the input read once and 8 bytes of order + rank written per
element — and is built to move just those: persistent blocks walk tiles of
whole packets (16 KB spans of the input, read with 16-byte loads one tile
ahead), each key is computed once into shared memory, ranks come from the
keys' bit-plane ballots (several short packets per warp; one warp per
packet above 32 elements, with a bucket scan), ``rank`` is stored
coalesced and ``order[rank[i]] = i`` is staged in shared memory before its
16-byte stores.

The plain version repeats the reference's arithmetic: SWAR popcount on
int32 lanes, one-hot / histogram / prefix-sum ranks, and the inverse
permutation by a stable argsort (as ``psu_sort_compiled`` does).
"""

from __future__ import annotations

import torch

from ._build import DTYPE_CODES, check, library

__all__ = [
    "MAX_N",
    "psu_sort_plain",
    "psu_sort_cuda",
    "check_key",
]

MAX_N = 1024  # packet width the CUDA kernels take (32 ranking chunks of a warp)


def check_key(width: int, k: int | None) -> None:
    """The sort-key contract: W in [1, 16] (SWAR popcount range of the
    reference kernel), APP k in [1, W + 1]."""
    if not 1 <= width <= 16:
        raise ValueError(f"width must be in [1, 16], got {width}")
    if k is not None and not 1 <= k <= width + 1:
        raise ValueError(f"k must be in [1, {width + 1}] for width {width}, got {k}")


def _popcount_bits(x: torch.Tensor, width: int) -> torch.Tensor:
    """Branch-free popcount of the low ``width`` bits of int32 lanes
    (SWAR, valid for width <= 16)."""
    v = x.to(torch.int32) & ((1 << width) - 1)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    if width > 8:
        v = v + (v >> 8)
    return v & 0x1F


def _rank_from_keys(key: torch.Tensor, nb: int) -> torch.Tensor:
    """One-hot / histogram / prefix-sum, then index mapping: the (P, N)
    int32 stable counting-sort ranks of a (P, N) key block."""
    iota_k = torch.arange(nb, dtype=torch.int32, device=key.device)
    onehot = (key[:, :, None] == iota_k).to(torch.int32)  # (P, N, K)
    within = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    hist = onehot.sum(dim=1, dtype=torch.int32)
    starts = torch.cumsum(hist, dim=1, dtype=torch.int32) - hist
    return ((within + starts[:, None, :]) * onehot).sum(dim=2, dtype=torch.int32)


def _rank_block(
    x: torch.Tensor, *, width: int, k: int | None, descending: bool
) -> torch.Tensor:
    """Popcount (+ APP bucket encoder), then the counting-sort ranks."""
    p = _popcount_bits(x, width)
    if k is None:
        key, nb = p, width + 1
    else:
        key, nb = torch.div(p * k, width + 1, rounding_mode="floor"), k
    if descending:
        key = (nb - 1) - key
    return _rank_from_keys(key, nb)


def psu_sort_plain(
    packets: torch.Tensor, *, width: int = 8, k: int | None = None,
    descending: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(order, rank), both int32 (P, N), on the packets' own device."""
    rank = _rank_block(packets.to(torch.int32), width=width, k=k, descending=descending)
    order = torch.argsort(rank, dim=-1, stable=True).to(torch.int32)
    return order, rank


def psu_sort_cuda(
    packets: torch.Tensor, *, width: int = 8, k: int | None = None,
    descending: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(order, rank) from the CUDA kernel: uint8 or int32 (P, N) packets,
    contiguous, on a CUDA device, 1 <= N <= MAX_N."""
    if packets.dim() != 2 or not packets.is_contiguous():
        raise ValueError(
            f"psu_sort_cuda needs contiguous (P, N) packets, got {tuple(packets.shape)}"
        )
    p, n = packets.shape
    if not 1 <= n <= MAX_N:
        raise ValueError(f"psu_sort_cuda takes 1 <= N <= {MAX_N}, got N={n}")
    check_key(width, k)
    if packets.dtype not in DTYPE_CODES:
        raise TypeError(f"psu_sort_cuda takes uint8 or int32 packets, got {packets.dtype}")
    if packets.device.type != "cuda":
        raise ValueError(f"psu_sort_cuda needs a CUDA tensor, got {packets.device}")
    order = torch.empty((p, n), dtype=torch.int32, device=packets.device)
    rank = torch.empty_like(order)
    if p == 0:
        return order, rank
    with torch.cuda.device(packets.device):
        err = library().repro_psu_sort(
            packets.data_ptr(), DTYPE_CODES[packets.dtype], p, n, width,
            0 if k is None else k, int(descending), order.data_ptr(),
            rank.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    check(err, "repro_psu_sort")
    psu_sort_cuda.launches += 1
    return order, rank


psu_sort_cuda.launches = 0
