"""int8 KV-cache quantization for decode (counterpart of
``repro.serve.kv_quant``).

Symmetric per-(layer, batch, head) int8 storage of the decode KV cache:
scales are amax / 127 in float32, codes ``round(k / max(scale, 1e-8))``
(round half to even) clipped to [-127, 127] — the reference's sequence, so
the codes and scales are bit-exact with it on the same cache.

Layout: ``k_q`` / ``v_q`` int8 with float32 scales of shape (L, B, H_kv).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

Params = Dict[str, Any]


def quantize_kv(k: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """k: (..., S, Hkv, D) bf16/f32; scale: broadcastable (..., 1, Hkv, 1)."""
    safe = torch.clamp_min(scale, 1e-8)
    return torch.clamp(torch.round(k.to(torch.float32) / safe), -127, 127).to(torch.int8)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def quantize_cache(cache: Params) -> Params:
    """Convert a populated cache (from ``prefill``) to int8 storage."""
    out: Params = {k: v for k, v in cache.items() if k not in ("k", "v")}
    for name in ("k", "v"):
        if name not in cache:
            return cache  # SSM-only cache: nothing to quantize
        t = cache[name]  # (L, B, S, Hkv, D)
        amax = torch.amax(torch.abs(t.to(torch.float32)), dim=(2, 4), keepdim=True)
        scale = amax / 127.0
        out[f"{name}_q"] = quantize_kv(t, scale)
        out[f"{name}_scale"] = scale[:, :, 0, :, 0]  # (L, B, Hkv)
    out["quantized"] = torch.tensor(True, device=cache["k"].device)
    return out


def dequantize_cache(cache: Params, dtype=torch.bfloat16) -> Params:
    """Materialise the view ``decode_step`` expects."""
    if "k_q" not in cache:
        return cache
    out: Params = {
        k: v
        for k, v in cache.items()
        if k not in ("k_q", "v_q", "k_scale", "v_scale", "quantized")
    }
    for name in ("k", "v"):
        scale = cache[f"{name}_scale"][:, :, None, :, None]
        out[name] = dequantize_kv(cache[f"{name}_q"], scale, dtype)
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def cache_bytes(cache: Params) -> int:
    """Storage bytes of a cache tree (for the traffic/footprint reports)."""
    return sum(t.numel() * t.element_size() for t in _leaves(cache))
