"""Blockwise int8 egress quantizer: plain PyTorch version and the CUDA
kernel's wrapper.

Replaces the TPU kernel ``repro/kernels/quantize.py:quantize_egress_pallas``
(body ``_quant_kernel``): a model's flat float32 gradient, cut into blocks
of ``block`` values, becomes symmetric int8 codes with one float32 scale
per block before it crosses the link.  The CUDA kernel
(``csrc/quantize.cu``) quantizes one block per warp: a strided abs-max
with a shuffle reduction, the scale, then the codes from a second read of
the block.  It is bound by bytes on the H100 (4 bytes read and 1 written
per element), and it reads past the true length as zeros instead of
padding the input.

Both versions compute what the reference's public, jitted entry computes
(``repro.kernels.quantize_egress``), not its eager oracle:

  * ``scale = amax * float32(1/127)`` — XLA turns the division by the
    constant 127 into this multiply, one ulp away from IEEE division in
    some blocks;
  * ``q = clamp(round_half_even(x / safe), -127, 127)`` with IEEE
    division, ``safe = scale`` where ``scale > 0`` else 1;
  * subnormals are flushed, as XLA and a TPU do: a subnormal |x| counts as
    0 in the abs-max and in the division, and a subnormal scale is 0.

Inputs must be finite: the reference's results for ±inf and NaN (a NaN
scale, codes from an unscaled division) are not reproduced.
"""

from __future__ import annotations

import torch

from ._build import check, library

__all__ = ["FLT_MIN", "INV_127", "check_block", "quantize_egress_plain", "quantize_egress_cuda"]

FLT_MIN = torch.finfo(torch.float32).tiny  # smallest normal float32
INV_127 = float.fromhex("0x1.020408p-7")  # float32(1/127), exact in float32


def check_block(block: int) -> None:
    """Values per quantizer block: a positive int."""
    if not isinstance(block, int) or block < 1:
        raise ValueError(f"block must be a positive int, got {block!r}")


def quantize_egress_plain(
    x: torch.Tensor, *, block: int = 256
) -> tuple[torch.Tensor, torch.Tensor]:
    """(codes int8 (Mp,), scales float32 (Mp / block,)) of a 1-D float32
    vector zero-padded to Mp, the next multiple of ``block``."""
    check_block(block)
    x = x.to(torch.float32)
    pad = (-x.shape[0]) % block
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    xb = x.reshape(-1, block)
    zero = xb.new_zeros(())
    xb = torch.where(xb.abs() < FLT_MIN, zero, xb)
    scale = xb.abs().amax(dim=1) * torch.tensor(INV_127, dtype=torch.float32, device=x.device)
    scale = torch.where(scale < FLT_MIN, zero, scale)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xb / safe[:, None]), -127, 127).to(torch.int8)
    return q.reshape(-1), scale


def quantize_egress_cuda(
    x: torch.Tensor, *, block: int = 256
) -> tuple[torch.Tensor, torch.Tensor]:
    """(codes, scales) from the CUDA kernel: a contiguous 1-D float32
    vector on a CUDA device, padded with zeros to a multiple of ``block``
    inside the kernel."""
    check_block(block)
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"quantize_egress_cuda needs a contiguous 1-D vector, got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"quantize_egress_cuda takes float32, got {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"quantize_egress_cuda needs a CUDA tensor, got {x.device}")
    m = x.shape[0]
    rows = -(-m // block)
    q = torch.empty(rows * block, dtype=torch.int8, device=x.device)
    scales = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows == 0:
        return q, scales
    with torch.cuda.device(x.device):
        err = library().repro_quantize_egress(
            x.data_ptr(), m, rows, block, q.data_ptr(), scales.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    check(err, "repro_quantize_egress")
    quantize_egress_cuda.launches += 1
    return q, scales


quantize_egress_cuda.launches = 0
