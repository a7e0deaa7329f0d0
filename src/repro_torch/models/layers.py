"""Shared neural-net layers: norms, RoPE, attention (train + decode), MLPs.

Counterpart of ``repro.models.layers``.  Parameters are plain nested dicts
of tensors, initialisers take an explicit ``torch.Generator``, and every
layer is a function ``(params, inputs, ...) -> outputs`` that follows the
reference's op sequence (so float32 outputs agree to rounding).
Attention supports the reference's three implementations
(``config.attn_impl``):

  dense        -- full (S, S) score matrix; smoke tests and short sequences.
  chunked      -- a loop over query chunks, online softmax over all KV
                  chunks with causal masking (2x causal FLOPs).
  chunked_skip -- the same loop skipping KV chunks above the causal
                  diagonal (FLOP-optimal; the default).

The products are ``torch.matmul`` / ``einsum``; none of this is a Pallas
kernel in the reference.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from .config import ModelConfig

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(name: str | torch.dtype) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` / ``param_dtype`` string."""
    if isinstance(name, torch.dtype):
        return name
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}; choose from {sorted(_DTYPES)}")
    return _DTYPES[name]


# --------------------------------------------------------------------------
# initialisers / norms / rope
# --------------------------------------------------------------------------


def normal(gen: torch.Generator | None, shape: tuple[int, ...], device: torch.device):
    """Standard normal draws of ``shape`` from ``gen`` on ``device``; on the
    ``meta`` device (``param_shapes``) a shape-only tensor and no draw."""
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    return torch.randn(shape, generator=gen, device=gen.device).to(device)


def dense_init(gen, shape: tuple[int, ...], in_axis_size: int, dtype, device):
    """Normal weights scaled by 1/sqrt(fan-in), as the reference's."""
    scale = 1.0 / math.sqrt(max(1, in_axis_size))
    # scaled in place: one float32 draw alive at a time (a 48-layer stacked
    # leaf of internvl2-26b's MLP is 19.3 GB at float32)
    return normal(gen, shape, device).mul_(scale).to(torch_dtype(dtype))


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * w.to(torch.float32)).to(dt)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float) -> tuple:
    """cos/sin tables for given positions: (..., head_dim // 2)."""
    half = head_dim // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32, device=positions.device)
        / half
    )
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, D/2) or (S, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------


def init_mlp(gen, cfg: ModelConfig, d_ff: int, lead: tuple = (), device=None) -> Params:
    """MLP weights; ``lead`` prefixes every shape (a stacked layer axis)."""
    pdt = cfg.param_dtype
    d = cfg.d_model
    gated = cfg.act in ("swiglu", "geglu")
    p: Params = {}
    if gated:
        p["gate"] = dense_init(gen, (*lead, d, d_ff), d, pdt, device)
    p["up"] = dense_init(gen, (*lead, d, d_ff), d, pdt, device)
    p["down"] = dense_init(gen, (*lead, d_ff, d), d_ff, pdt, device)
    return p


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def mlp(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    if cfg.act == "swiglu":
        h = F.silu(x @ params["gate"].to(dt)) * (x @ params["up"].to(dt))
    elif cfg.act == "geglu":
        h = _gelu(x @ params["gate"].to(dt)) * (x @ params["up"].to(dt))
    else:
        h = _gelu(x @ params["up"].to(dt))
    return h @ params["down"].to(dt)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------


def init_attention(gen, cfg: ModelConfig, lead: tuple = (), device=None) -> Params:
    pdt = cfg.param_dtype
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p: Params = {
        "wq": dense_init(gen, (*lead, d, cfg.n_heads, hd), d, pdt, device),
        "wk": dense_init(gen, (*lead, d, cfg.n_kv_heads, hd), d, pdt, device),
        "wv": dense_init(gen, (*lead, d, cfg.n_kv_heads, hd), d, pdt, device),
        "wo": dense_init(gen, (*lead, cfg.n_heads, hd, d), cfg.n_heads * hd, pdt, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((*lead, hd), dtype=torch_dtype(pdt), device=device)
        p["k_norm"] = torch.ones((*lead, hd), dtype=torch_dtype(pdt), device=device)
    return p


def project_kv(params: Params, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The key and value projections of x (B, S, d): (B, S, Hkv, D) each."""
    dt = x.dtype
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(dt))
    return k, v


def norm_rope(params: Params, q, k: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """The (optional) qk-norm, then rope, of projected queries ``q`` and keys
    ``k`` (B, S, H, D); ``q`` may be None (the keys alone)."""
    if cfg.qk_norm:
        if q is not None:
            q = rms_norm(q, params["q_norm"], cfg.rms_eps)
        k = rms_norm(k, params["k_norm"], cfg.rms_eps)
    cos, sin = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    return (None if q is None else apply_rope(q, cos, sin)), apply_rope(k, cos, sin)


def _qkv(params: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """Project + (optional) qk-norm + rope.  x: (B, S, d)."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(x.dtype))
    k, v = project_kv(params, x)
    q, k = norm_rope(params, q, k, cfg, positions)
    return q, k, v


def _sdpa_dense(q, k, v, scale: float, causal: bool) -> torch.Tensor:
    """q: (B, Sq, H, D), k/v: (B, Sk, Hkv, D) with H = Hkv * rep."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    qg = q.reshape(b, sq, hkv, rep, d)
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qg, k).to(torch.float32) * scale
    if causal:
        mask = torch.tril(torch.ones((sq, sk), dtype=torch.bool, device=q.device),
                          diagonal=sk - sq)
        scores = torch.where(mask[None, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs, v)
    return out.reshape(b, sq, h, d)


def _attn_block(q, k, v, scale, mask_bias):
    """One (q-chunk, kv-chunk) online-softmax block.

    q: (B, Cq, Hkv, rep, D); k/v: (B, Ck, Hkv, D).
    Returns (m, l, acc) partials with m/l: (B, Hkv, rep, Cq), acc like q.
    """
    s = torch.einsum("bqhrd,bkhd->bhrqk", q, k).to(torch.float32) * scale
    if mask_bias is not None:
        s = s + mask_bias
    return block_stats(s, v, q.dtype)


def block_stats(s, v, dtype):
    """The online-softmax partials of float32 scores ``s`` (B, Hkv, rep,
    Cq, Ck) over values ``v`` (B, Ck, Hkv, D), the probabilities cast to
    ``dtype`` for the product: (m, l, acc) as ``_attn_block`` returns."""
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    acc = torch.einsum("bhrqk,bkhd->bqhrd", p.to(dtype), v)
    return m, l, acc


def rescale_block(m, l, acc, to):
    """Partials (m, l, acc) rescaled from their maxima ``m`` to ``to``:
    (l, acc), ready to be summed with other blocks'."""
    e = torch.exp(m - to)
    # acc axes (B, Cq, Hkv, rep, D) vs stats (B, Hkv, rep, Cq)
    return l * e, acc * e.permute(0, 3, 1, 2)[..., None].to(acc.dtype)


def _merge_blocks(m1, l1, a1, m2, l2, a2):
    m = torch.maximum(m1, m2)
    l1, a1 = rescale_block(m1, l1, a1, m)
    l2, a2 = rescale_block(m2, l2, a2, m)
    return m, l1 + l2, a1 + a2


def _finalize(m, l, acc):
    denom = l.permute(0, 3, 1, 2)[..., None]
    return (acc.to(torch.float32) / torch.clamp_min(denom, 1e-30)).to(acc.dtype)


def _sdpa_chunked(q, k, v, scale: float, chunk: int, skip: bool) -> torch.Tensor:
    """Causal online-softmax attention over chunks.

    ``skip=True`` skips KV chunks above the causal diagonal (FLOP-optimal);
    ``skip=False`` visits every KV chunk with the causal bias (the
    reference's ``lax.scan`` form: 2x causal FLOPs).  Both are Python
    loops over the chunks here.
    """
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    cq = min(chunk, sq)
    ck = min(chunk, sk)
    if sq % cq or sk % ck:
        return _sdpa_dense(q, k, v, scale, causal=True)
    nq, nk = sq // cq, sk // ck
    qg = q.reshape(b, nq, cq, hkv, rep, d)
    kg = k.reshape(b, nk, ck, hkv, d)
    vg = v.reshape(b, nk, ck, hkv, d)
    hist = sk - sq  # KV positions preceding the query window (decode prefill)
    ar_q = torch.arange(cq, device=q.device)
    ar_k = torch.arange(ck, device=q.device)

    def block_bias(qi: int, kj: int):
        qpos = qi * cq + hist + ar_q
        kpos = kj * ck + ar_k
        keep = qpos[:, None] >= kpos[None, :]
        zero = torch.zeros((), dtype=torch.float32, device=q.device)
        return torch.where(keep, zero, -1e30)[None, None, None]

    outs = []
    for i in range(nq):
        m = torch.full((b, hkv, rep, cq), -1e30, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, hkv, rep, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, cq, hkv, rep, d), dtype=q.dtype, device=q.device)
        if skip:
            hi = min(nk, ((i + 1) * cq + hist + ck - 1) // ck)
        else:
            hi = nk
        for j in range(hi):
            diag = (j + 1) * ck > i * cq + hist  # block touches the mask
            bias = block_bias(i, j) if (diag or not skip) else None
            mb, lb, ab = _attn_block(qg[:, i], kg[:, j], vg[:, j], scale, bias)
            m, l, acc = _merge_blocks(m, l, acc, mb, lb, ab)
        outs.append(_finalize(m, l, acc))
    out = torch.stack(outs, dim=1)
    return out.reshape(b, sq, h, d)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
           causal: bool = True) -> torch.Tensor:
    """The attention core of roped queries ``q`` (B, S, H, D) over keys and
    values (B, S, Hkv, D) by ``cfg.attn_impl``: the heads' output (B, S, H, D)."""
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    s = q.shape[1]
    if not causal or cfg.attn_impl == "dense" or s <= cfg.attn_chunk:
        return _sdpa_dense(q, k, v, scale, causal)
    skip = cfg.attn_impl == "chunked_skip"
    # the reference floors the skip form's chunk at S/8 to bound its
    # unrolled HLO; kept so both packages take the same blocks
    chunk = max(cfg.attn_chunk, s // 8) if skip else cfg.attn_chunk
    return _sdpa_chunked(q, k, v, scale, chunk, skip=skip)


def attention(
    params: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    positions: torch.Tensor,
    causal: bool = True,
) -> torch.Tensor:
    """Full-sequence attention (training / prefill).  x: (B, S, d)."""
    q, k, v = _qkv(params, x, cfg, positions)
    out = attend(q, k, v, cfg, causal)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))


def cross_attention(
    params: Params,
    x: torch.Tensor,
    kv_k: torch.Tensor,
    kv_v: torch.Tensor,
    cfg: ModelConfig,
) -> torch.Tensor:
    """Decoder cross-attention against precomputed encoder K/V (no rope)."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.rms_eps)
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    out = _sdpa_dense(q, kv_k, kv_v, scale, causal=False)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dt))


def encode_kv(params: Params, enc_out: torch.Tensor, cfg: ModelConfig):
    """Precompute cross-attention K/V from encoder output."""
    dt = enc_out.dtype
    k = torch.einsum("bsd,dhk->bshk", enc_out, params["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", enc_out, params["wv"].to(dt))
    if cfg.qk_norm:
        k = rms_norm(k, params["k_norm"], cfg.rms_eps)
    return k, v


def decode_write(
    params: Params,
    x: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    pos: torch.Tensor,
    cfg: ModelConfig,
    start: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The new token's queries, and its keys and values written into the
    cache at ``pos``.  x: (B, 1, d); cache_k/v: (B, S, Hkv, D) holding
    positions ``start`` .. ``start + S`` (the whole cache from 0, or one
    block of a cache split on its sequence).  Returns (q, new_k, new_v);
    the caches passed in are not modified."""
    positions = pos.to(torch.int32).expand(x.shape[0], 1)
    q, k, v = _qkv(params, x, cfg, positions)
    return (q, *write_kv(cache_k, cache_v, k, v, pos, start))


def write_kv(cache_k: torch.Tensor, cache_v: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             pos: torch.Tensor, start: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The new token's keys and values (B, 1, Hkv, D) written into a cache
    block (positions as ``decode_write``'s) at ``pos``: new caches."""
    ar = start + torch.arange(cache_k.shape[1], device=k.device)
    slot = (ar == pos)[None, :, None, None]
    return (torch.where(slot, k.to(cache_k.dtype), cache_k),
            torch.where(slot, v.to(cache_v.dtype), cache_v))


def decode_scores(q: torch.Tensor, cache_k: torch.Tensor, pos: torch.Tensor,
                  start: int = 0) -> torch.Tensor:
    """The new token's scaled float32 scores over a cache block (positions
    as ``decode_write``'s), those past ``pos`` at -1e30.  q: (B, 1, H, D),
    H a multiple of the cache's Hkv; returns (B, Hkv, H / Hkv, 1, S)."""
    b, _, h, d = q.shape
    hkv = cache_k.shape[2]
    qg = q.reshape(b, 1, hkv, h // hkv, d)
    scores = (
        torch.einsum("bqhrd,bkhd->bhrqk", qg, cache_k.to(q.dtype)).to(torch.float32)
        * (1.0 / math.sqrt(d))
    )
    ar = start + torch.arange(cache_k.shape[1], device=q.device)
    valid = (ar <= pos)[None, None, None, None, :]
    return torch.where(valid, scores, -1e30)


def decode_attend(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                  pos: torch.Tensor) -> torch.Tensor:
    """The new token's attention output (B, 1, H, D) over a whole cache
    (written, as ``decode_write`` returns it)."""
    dt = q.dtype
    probs = torch.softmax(decode_scores(q, cache_k, pos), dim=-1).to(dt)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs, cache_v.to(dt))
    return out.reshape(q.shape)


def attention_decode(
    params: Params,
    x: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    pos: torch.Tensor,
    cfg: ModelConfig,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode with KV cache.

    x: (B, 1, d); cache_k/v: (B, S_max, Hkv, D); pos: 0-d int32 tensor
    (tokens already in cache).  Returns (y, new_k, new_v); the caches
    passed in are not modified.
    """
    q, cache_k, cache_v = decode_write(params, x, cache_k, cache_v, pos, cfg)
    out = decode_attend(q, cache_k, cache_v, pos)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))
    return y, cache_k, cache_v
