"""Compressed + popcount-ordered gradient all-reduce (explicit-DP path).

Counterpart of ``repro.optim.compress``:

  * **bf16 wire**: grads cross the links as bfloat16 (2x fewer bytes).
  * **int8 + error feedback**: blockwise symmetric int8 with *shared*
    scales (one float32 max-reduce per block), int16 wire accumulation
    (exact for up to 258 replicas), and an error-feedback buffer carrying
    the quantization residue to the next step (EF-SGD semantics).
  * **popcount-ordered egress**: a *static* permutation — derived from the
    corresponding weight bytes by ``repro_torch.traffic.egress_permutation``,
    identical on all replicas, so the reduction stays aligned — reorders
    the int8 wire image so flits with similar Hamming weight are adjacent,
    and its inverse restores the order after the sum.

The reference runs inside ``shard_map`` over named data axes.  Here
``group`` is a ``torch.distributed`` process group: the sums are
``all_reduce`` SUM and the shared scales MAX over it, and ``None`` is a
world of one replica (each collective the identity).  NCCL has no int16
reduction, so over a group the int16 wire is summed as int32 (the same
integers for up to 258 replicas).

The quantization is ``compress``'s own, not the quantizer kernel's, and
follows what the reference computes once XLA has compiled it (it only runs
under ``shard_map``): its source divides ``amax / 127.0``, which XLA turns
into a multiply by float32(1/127), and its new error buffer
``x - q * scale`` is contracted into one fused multiply-add.  The port
does both explicitly, so codes, scales, sums and error buffers are
bit-exact with the reference's (``tests/test_torch_train.py``).  Compiled
XLA also reads a subnormal float as a zero of its sign and writes one for a
subnormal result (flush-to-zero, as a TPU does); ``int8_wire`` flushes by
hand where that changes a value: ``g`` and ``error`` on entry, their sum,
and the new error buffer.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import numpy as np
import torch

from .. import _collectives

Mode = Literal["none", "bf16", "int8_ef"]

_INV_127 = float(np.float32(1 / 127))  # XLA's reciprocal of the constant 127
_FLT_MIN = torch.finfo(torch.float32).tiny  # smallest normal float32
_CHUNK = 1 << 24  # elements per flush pass: bounded temporaries at full width


def _ftz(t: torch.Tensor) -> torch.Tensor:
    """``t`` with every subnormal replaced by a zero of its sign."""
    return torch.where(t.abs() < _FLT_MIN, t * 0, t)


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    mode: Mode = "none"
    block: int = 256
    # static egress permutation (see repro_torch.traffic); applied to the
    # int8 wire image before the collective and inverted after.
    use_egress_ordering: bool = False


def _all_reduce(t: torch.Tensor, group, op: str, inplace: bool = False) -> torch.Tensor:
    """``t`` reduced over ``group`` (SUM or MAX), into ``t`` itself with
    ``inplace``; the identity for None."""
    if group is None:
        return t
    import torch.distributed as dist

    out = t if inplace else t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                    group=group)
    _collectives.note("all-reduce", out.numel() * out.element_size(), group)
    return out


def int8_wire(
    g: torch.Tensor, error: torch.Tensor, cfg: CompressionConfig, group=None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The int8_ef quantization of ``g + error``: (flat int8 wire codes,
    padded to whole blocks; the shared per-block float32 scales; the new
    error buffer ``x - dequant(codes)``)."""
    m = g.shape[0]
    pad = (-m) % cfg.block
    xb = torch.zeros((m + pad,), dtype=torch.float32, device=g.device)
    for a in range(0, m, _CHUNK):  # x = g + error, read and written as XLA does
        b = min(a + _CHUNK, m)
        torch.add(_ftz(g[a:b]), _ftz(error[a:b]), out=xb[a:b])
        xb[a:b] = _ftz(xb[a:b])
    xr = xb.view(-1, cfg.block)
    local_amax = torch.amax(torch.abs(xr), dim=1)
    # shared scales: one float32 max-reduce per block keeps dequantization exact
    amax = _all_reduce(local_amax, group, "max")
    scale = torch.clamp_min(amax * _INV_127, 1e-12)
    # the codes, as floats; + 0 makes a -0 code the int8 code's +0
    y = (xr / scale[:, None]).round_().clamp_(-127, 127).add_(0.0)
    q = y.to(torch.int8)
    # the new error buffer in place of this call's own sum: x - q * scale
    # as one fused multiply-add
    xr.addcmul_(y, scale[:, None], value=-1)
    del y
    for a in range(0, m, _CHUNK):
        xb[a: a + _CHUNK] = _ftz(xb[a: a + _CHUNK])
    return q.reshape(-1), scale, xb[:m]


def compressed_psum(
    g: torch.Tensor,
    error: torch.Tensor,
    cfg: CompressionConfig,
    group=None,
    perm: Optional[torch.Tensor] = None,
    inv_perm: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """All-reduce a flat float32 gradient vector with compression + EF over
    ``group`` (None: one replica).  Returns (summed gradient float32, same
    shape as g; new error buffer)."""
    if cfg.mode == "none":
        return _all_reduce(g, group, "sum"), error

    if cfg.mode == "bf16":
        wire = g.to(torch.bfloat16)
        out = _all_reduce(wire, group, "sum").to(torch.float32)
        return out, error  # rounding error is not fed back in bf16 mode

    # --- int8_ef ---
    m = g.shape[0]
    wire, scale, new_error = int8_wire(g, error, cfg, group)
    ordered = cfg.use_egress_ordering
    if ordered and perm is not None:
        # static, replica-identical: the reduction stays aligned
        wire = torch.index_select(wire, 0, perm)
    acc = wire.to(torch.int16)  # 2-byte wire accumulation
    del wire
    if group is not None:
        acc = _all_reduce(acc.to(torch.int32), group, "sum", inplace=True).to(torch.int16)
    if ordered and inv_perm is not None:
        acc = torch.index_select(acc, 0, inv_perm)
    out = acc.to(torch.float32).reshape(-1, cfg.block).mul_(scale[:, None]).reshape(-1)
    return out[:m], new_error


def init_error_buffer(params_flat_size: int, device=None) -> torch.Tensor:
    """A zero error buffer on ``device`` (``cuda`` unless named)."""
    from ..kernels.backend import resolve_device

    return torch.zeros((params_flat_size,), dtype=torch.float32, device=resolve_device(device))
