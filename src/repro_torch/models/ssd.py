"""Mamba-2 / SSD (state-space duality) block [arXiv:2405.21060].

Counterpart of ``repro.models.ssd``.  The chunked SSD algorithm:
intra-chunk terms are dense products, the inter-chunk state is carried by a
short loop over chunk boundaries (the reference's ``lax.scan``), so
sequence memory is O(S * Lc) and the carried state is (B, H, N, P) only
at chunk edges.  The causal mask puts ``-inf`` on the segment sums before
``exp``, as the reference does.

Decode is the exact recurrence ``h = exp(dt*A) h + dt * B (x) x`` with a
rolling causal-conv cache, O(1) state per token.

Einsum index conventions: b=batch, c=chunk, l/m=position-in-chunk, h=head,
n=state dim, p=head dim.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import dense_init, rms_norm, torch_dtype

Params = Dict[str, Any]


def ssm_dims(cfg: ModelConfig) -> tuple[int, int, int, int, int]:
    """(d_inner, n_heads, head_dim, n_groups, d_state)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    if d_inner % s.head_dim:
        raise ValueError(f"d_inner {d_inner} not divisible by head_dim {s.head_dim}")
    return d_inner, d_inner // s.head_dim, s.head_dim, s.n_groups, s.d_state


def init_ssd(gen, cfg: ModelConfig, lead: tuple = (), device=None) -> Params:
    pdt = cfg.param_dtype
    tdt = torch_dtype(pdt)
    d = cfg.d_model
    s = cfg.ssm
    d_inner, n_heads, _, n_groups, d_state = ssm_dims(cfg)
    d_xbc = d_inner + 2 * n_groups * d_state
    a_log = torch.log(torch.arange(1, n_heads + 1, dtype=torch.float32))
    return {
        "in_proj": dense_init(
            gen, (*lead, d, 2 * d_inner + 2 * n_groups * d_state + n_heads), d, pdt, device
        ),
        "conv_w": dense_init(gen, (*lead, s.d_conv, d_xbc), s.d_conv, pdt, device),
        "conv_b": torch.zeros((*lead, d_xbc), dtype=tdt, device=device),
        "a_log": a_log.to(device=device, dtype=tdt).expand(*lead, n_heads).clone(),
        "dt_bias": torch.zeros((*lead, n_heads), dtype=tdt, device=device),
        "d_skip": torch.ones((*lead, n_heads), dtype=tdt, device=device),
        "norm_w": torch.ones((*lead, d_inner), dtype=tdt, device=device),
        "out_proj": dense_init(gen, (*lead, d_inner, d), d_inner, pdt, device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time.  x: (B, S, C); w: (K, C)."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):  # K is tiny (4): the reference's unrolled taps
        out = out + pad[:, i: i + x.shape[1], :] * w[i][None, None, :]
    return out + b[None, None, :]


def _split_xbc(xbc: torch.Tensor, cfg: ModelConfig):
    d_inner, n_heads, hd, n_groups, d_state = ssm_dims(cfg)
    x = xbc[..., :d_inner]
    bmat = xbc[..., d_inner: d_inner + n_groups * d_state]
    cmat = xbc[..., d_inner + n_groups * d_state:]
    bsz, s = x.shape[:2]
    x = x.reshape(bsz, s, n_heads, hd)
    rep = n_heads // n_groups
    bmat = bmat.reshape(bsz, s, n_groups, d_state).repeat_interleave(rep, dim=2)
    cmat = cmat.reshape(bsz, s, n_groups, d_state).repeat_interleave(rep, dim=2)
    return x, bmat, cmat


def ssd_scan(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)  (post-softplus)
    a: torch.Tensor,  # (H,) negative decay rates
    bmat: torch.Tensor,  # (B, S, H, N)
    cmat: torch.Tensor,  # (B, S, H, N)
    chunk: int,
    h0: torch.Tensor | None = None,  # (B, H, N, P) initial state
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD: returns (y (B,S,H,P), final_state (B,H,N,P))."""
    bsz, s, h, p = x.shape
    n = bmat.shape[-1]
    lc = min(chunk, s)
    if s % lc:
        raise ValueError(f"seq {s} not divisible by chunk {lc}")
    nc = s // lc
    f32 = torch.float32
    xf = x.to(f32).reshape(bsz, nc, lc, h, p)
    dtf = dt.to(f32).reshape(bsz, nc, lc, h)
    bf = bmat.to(f32).reshape(bsz, nc, lc, h, n)
    cf = cmat.to(f32).reshape(bsz, nc, lc, h, n)

    da = dtf * a[None, None, None, :]  # log-decay per step
    cum = torch.cumsum(da, dim=2)  # (B, C, L, H)
    # intra-chunk: M[l,m] = (C_l . B_m) * exp(cum_l - cum_m) * dt_m  (l >= m)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,C,L,M,H)
    tril = torch.tril(torch.ones((lc, lc), dtype=torch.bool, device=x.device))
    seg = torch.where(tril[None, None, :, :, None], seg, -math.inf)
    mmat = torch.einsum("bclhn,bcmhn->bclmh", cf, bf) * torch.exp(seg) * dtf[:, :, None, :, :]
    y_intra = torch.einsum("bclmh,bcmhp->bclhp", mmat, xf)

    # chunk states: S_c = sum_m exp(cum_last - cum_m) dt_m B_m (x) x_m
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B,C,L,H)
    s_c = torch.einsum("bclh,bclhn,bclhp->bchnp", decay_to_end * dtf, bf, xf)
    t_c = torch.exp(cum[:, :, -1, :])  # (B, C, H) total chunk decay

    hstate = torch.zeros((bsz, h, n, p), dtype=f32, device=x.device) if h0 is None else h0.to(f32)
    hprevs = []
    for ci in range(nc):  # the reference's lax.scan over chunk boundaries
        hprevs.append(hstate)
        hstate = hstate * t_c[:, ci, :, None, None] + s_c[:, ci]
    hprev = torch.stack(hprevs, dim=1)  # (B, C, H, N, P) state entering chunk
    y_inter = torch.einsum("bclhn,bchnp->bclhp", cf * torch.exp(cum)[..., None], hprev)
    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    return y.to(x.dtype), hstate


def ssd_block(params: Params, x: torch.Tensor, cfg: ModelConfig, return_cache: bool = False):
    """Full-sequence Mamba-2 block (training / prefill).  x: (B, S, d).

    With ``return_cache`` also returns the decode cache (final SSM state +
    causal-conv tail) so prefill can hand off to ``ssd_decode``.
    """
    dt_ = x.dtype
    d_inner, n_heads, hd, n_groups, d_state = ssm_dims(cfg)
    proj = x @ params["in_proj"].to(dt_)
    z = proj[..., :d_inner]
    xbc_raw = proj[..., d_inner:-n_heads]
    dt_raw = proj[..., -n_heads:]
    xbc = F.silu(_causal_conv(xbc_raw, params["conv_w"].to(dt_), params["conv_b"].to(dt_)))
    xs, bmat, cmat = _split_xbc(xbc, cfg)
    dt = F.softplus(dt_raw.to(torch.float32) + params["dt_bias"].to(torch.float32))
    a = -torch.exp(params["a_log"].to(torch.float32))
    y, hlast = ssd_scan(xs, dt, a, bmat, cmat, cfg.ssm.chunk)
    y = y + xs * params["d_skip"].to(dt_)[None, None, :, None]
    y = y.reshape(*x.shape[:2], d_inner)
    y = rms_norm(y * F.silu(z), params["norm_w"], cfg.rms_eps)
    out = y @ params["out_proj"].to(dt_)
    if not return_cache:
        return out
    k = cfg.ssm.d_conv - 1
    # cache layout matches init_ssd_cache: state (B, H, N, P), conv tail raw
    cache = {"state": hlast, "conv": xbc_raw[:, -k:, :].to(dt_)}
    return out, cache


def init_ssd_cache(cfg: ModelConfig, batch: int, dtype, device=None) -> Params:
    d_inner, n_heads, hd, n_groups, d_state = ssm_dims(cfg)
    d_xbc = d_inner + 2 * n_groups * d_state
    return {
        "state": torch.zeros((batch, n_heads, d_state, hd), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm.d_conv - 1, d_xbc), dtype=torch_dtype(dtype),
                            device=device),
    }


def ssd_decode(
    params: Params, x: torch.Tensor, cache: Params, cfg: ModelConfig
) -> tuple[torch.Tensor, Params]:
    """Single-token decode.  x: (B, 1, d); O(1) state update."""
    dt_ = x.dtype
    d_inner, n_heads, hd, n_groups, d_state = ssm_dims(cfg)
    proj = x @ params["in_proj"].to(dt_)
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner:-n_heads]
    dt_raw = proj[..., -n_heads:]

    # rolling causal-conv cache: window = [conv_cache, xbc_t]
    win = torch.cat([cache["conv"], xbc], dim=1)  # (B, K, d_xbc)
    w = params["conv_w"].to(dt_)
    conv_out = torch.einsum("bkc,kc->bc", win, w) + params["conv_b"].to(dt_)
    xbc_t = F.silu(conv_out)[:, None, :]
    new_conv = win[:, 1:, :]

    xs, bmat, cmat = _split_xbc(xbc_t, cfg)  # (B,1,H,P), (B,1,H,N)
    dt = F.softplus(
        dt_raw.to(torch.float32) + params["dt_bias"].to(torch.float32)
    )[:, 0]  # (B,H)
    a = -torch.exp(params["a_log"].to(torch.float32))
    decay = torch.exp(dt * a[None, :])  # (B,H)
    xs32 = xs.to(torch.float32)[:, 0]
    b32 = bmat.to(torch.float32)[:, 0]
    c32 = cmat.to(torch.float32)[:, 0]
    state = cache["state"] * decay[..., None, None] + torch.einsum(
        "bh,bhn,bhp->bhnp", dt, b32, xs32
    )
    y = torch.einsum("bhn,bhnp->bhp", c32, state).to(dt_)
    y = y + xs[:, 0] * params["d_skip"].to(dt_)[None, :, None]
    y = y.reshape(x.shape[0], 1, d_inner)
    y = rms_norm(y * F.silu(z), params["norm_w"], cfg.rms_eps)
    return y @ params["out_proj"].to(dt_), {"state": state, "conv": new_conv}
