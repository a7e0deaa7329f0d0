"""The comparison that decides ``correct``: element counts of the program's
outputs that differ from the reference's.  Every limit is 0: every
compared output is an integer, or a float32 whose bits the reference
fixes (the quantizer's scales)."""

from __future__ import annotations

import torch

BLOCK = 1 << 26


def differ(got: torch.Tensor, want: torch.Tensor) -> int:
    """Elements of ``got`` that differ from ``want``, compared by value
    (float32 by bits); a length that differs counts each missing or extra
    element too."""
    got, want = got.reshape(-1), want.reshape(-1)
    if got.dtype == torch.float32:
        got = got.view(torch.int32)
    if want.dtype == torch.float32:
        want = want.view(torch.int32)
    n = min(got.shape[0], want.shape[0])
    total = abs(got.shape[0] - want.shape[0])
    for a in range(0, n, BLOCK):
        g = got[a: min(a + BLOCK, n)].to(want.device, torch.int64)
        total += int((g != want[a: min(a + BLOCK, n)].to(torch.int64)).sum())
    return total


def steps_wrong(answers: list[tuple[int, object]], want: dict[int, object]) -> int:
    """Window steps whose answer is not the reference's for their snapshot."""
    return sum(answer != want[snap] for snap, answer in answers)
