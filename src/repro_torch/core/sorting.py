"""Comparison-free popcount sorting — ACC-PSU and APP-PSU (paper §III).

Counterpart of ``repro.core.sorting``: the PSU's one-hot / histogram /
prefix-sum / index-mapping dataflow is a stable counting sort, written
here with batched tensor ops over a leading packet axis.  The inverse
permutation is an integer scatter (the GPU has no reason to use the TPU's
one-hot matrix product).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .popcount import bucket_map, popcount

__all__ = [
    "counting_sort_ranks",
    "counting_sort_indices",
    "acc_sort_indices",
    "app_sort_indices",
    "apply_order",
    "invert_permutation",
]


def counting_sort_ranks(keys: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Stable counting-sort ranks: ``rank[i]`` = output slot of element i.

    ``keys`` is an integer tensor (..., N) with values in
    [0, num_buckets); returns int32 (..., N).  Equal keys keep input order.
    """
    keys = keys.to(torch.int64)
    onehot = F.one_hot(keys, num_buckets).to(torch.int32)  # (..., N, K)
    hist = onehot.sum(dim=-2, dtype=torch.int32)  # frequency histogram
    starts = torch.cumsum(hist, dim=-1, dtype=torch.int32) - hist
    within = torch.cumsum(onehot, dim=-2, dtype=torch.int32) - onehot
    start_i = torch.gather(starts, -1, keys)
    within_i = torch.gather(within, -1, keys[..., None])[..., 0]
    return (start_i + within_i).to(torch.int32)


def invert_permutation(perm: torch.Tensor) -> torch.Tensor:
    """``out[..., perm[..., i]] = i`` for a batch of permutations (int32)."""
    n = perm.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=perm.device)
    out = torch.empty(perm.shape, dtype=torch.int32, device=perm.device)
    return out.scatter_(-1, perm.to(torch.int64), idx.expand(perm.shape))


def counting_sort_indices(keys: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Stable sorted order: ``order[j]`` = input index of the j-th output."""
    return invert_permutation(counting_sort_ranks(keys, num_buckets))


def acc_sort_indices(
    values: torch.Tensor, width: int = 8, descending: bool = False
) -> torch.Tensor:
    """ACC-PSU: stable sort order of ``values`` (..., N) by exact popcount."""
    keys = popcount(values, width)
    if descending:
        keys = width - keys
    return counting_sort_indices(keys, width + 1)


def app_sort_indices(
    values: torch.Tensor, width: int = 8, k: int = 4, descending: bool = False
) -> torch.Tensor:
    """APP-PSU: stable sort order by the k-bucket approximate popcount."""
    keys = bucket_map(popcount(values, width), width, k)
    if descending:
        keys = (k - 1) - keys
    return counting_sort_indices(keys, k)


def apply_order(data: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Permute the last axis: ``out[..., j] = data[..., order[..., j]]``."""
    return torch.gather(data, -1, order.to(torch.int64))
