"""Plain PyTorch reference of the int8 gradient wire: the blockwise
quantizer, the per-tensor int8 view, the popcount packet order and the
bit-transition count.  Written from the paper's and the JAX package's
documented semantics, with none of the program's code: it imports torch
alone.  Every function works in blocks, so that it fits beside a cell's
inputs on one card.

``dtype`` is the precision the floating-point steps run in: float32, as
the configurations state; the control runs them in bfloat16.
"""

from __future__ import annotations

import torch

# elements a block of the element-wise passes; packets a block of the sort
BLOCK = 1 << 24
PACKETS = 1 << 20
INV_127 = float.fromhex("0x1.020408p-7")  # float32(1/127)


def quantize(x: torch.Tensor, block: int, dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """(codes int8, scales float32) of a flat gradient zero-padded to a
    multiple of ``block``: per block scale = max|x| * float32(1/127), codes =
    round-half-even(x / scale) clamped to [-127, 127]; subnormal inputs and
    scales count as 0, a zero scale divides by 1."""
    m = x.shape[0]
    nb = -(-m // block)
    codes = torch.empty(nb * block, dtype=torch.int8, device=x.device)
    scales = torch.empty(nb, dtype=torch.float32, device=x.device)
    tiny = torch.finfo(torch.float32).tiny
    step = max(BLOCK // block, 1) * block
    for a in range(0, nb * block, step):
        xb = x[a: a + step]
        if xb.shape[0] % block:
            xb = torch.cat([xb, xb.new_zeros(block - xb.shape[0] % block)])
        xb = xb.to(dtype).reshape(-1, block)
        xb = torch.where(xb.abs() < tiny, torch.zeros_like(xb), xb)
        s = xb.abs().amax(dim=1) * torch.tensor(INV_127, dtype=dtype, device=x.device)
        s = torch.where(s < tiny, torch.zeros_like(s), s)
        div = torch.where(s > 0, s, torch.ones_like(s))
        q = torch.round(xb / div[:, None]).clamp(-127, 127)
        codes[a: a + q.numel()] = q.to(torch.int8).reshape(-1)
        scales[a // block: a // block + s.shape[0]] = s.to(torch.float32)
    return codes, scales


def int8_view(w: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Symmetric per-tensor int8 image: round-half-even(w / (max|w| / 127))
    clamped to [-127, 127], the scale at least 1e-12."""
    amax = max(float(w[a: a + BLOCK].abs().max()) for a in range(0, w.shape[0], BLOCK))
    scale = torch.tensor(amax, dtype=torch.float32).to(dtype) / 127.0
    scale = scale.clamp_min(1e-12).to(w.device)
    out = torch.empty(w.shape[0], dtype=torch.int8, device=w.device)
    for a in range(0, w.shape[0], BLOCK):
        q = torch.round(w[a: a + BLOCK].to(dtype) / scale).clamp(-127, 127)
        out[a: a + BLOCK] = q.to(torch.int8)
    return out


def popcount(b: torch.Tensor) -> torch.Tensor:
    """Set bits of each uint8 byte, as uint8."""
    x = b.to(torch.uint8)
    out = x & 1
    for s in range(1, 8):
        out += (x >> s) & 1
    return out


def packet_order(packets: torch.Tensor, levels: int) -> torch.Tensor:
    """The stable ascending order of each packet's bytes by popcount bucket
    ``popcount * levels // 9`` (levels 9: the exact count, ACC; k: APP):
    order[i, j] = the element sent j-th.  int64."""
    key = popcount(packets).to(torch.int32) * levels // 9
    return torch.argsort(key, dim=1, stable=True)


def bt(flits: torch.Tensor, prev: torch.Tensor | None = None) -> int:
    """Bit transitions of a (T, L) uint8 flit stream, as a Python int;
    ``prev`` is the flit sent just before it, if any."""
    total = 0
    if prev is not None and flits.shape[0]:
        total += int(popcount(prev ^ flits[0]).sum(dtype=torch.int64))
    rows = max(BLOCK // max(flits.shape[1], 1), 1)
    for a in range(0, max(flits.shape[0] - 1, 0), rows):
        s = flits[a: a + rows + 1]
        total += int(popcount(s[1:] ^ s[:-1]).sum(dtype=torch.int64))
    return total
