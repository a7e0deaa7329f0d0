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


def _heads(t: torch.Tensor, heads, width: int = 1) -> torch.Tensor:
    """The last-dim entries of heads ``heads`` = [h0, h1) of ``t`` (``width``
    entries a head); ``t`` itself for every head (None)."""
    if heads is None:
        return t
    return t[..., heads[0] * width: heads[1] * width]


def xbc_part(t: torch.Tensor, cfg: ModelConfig, heads=None) -> torch.Tensor:
    """The channels of ``t``, whose last dim is laid out as xbc ([x | B |
    C], ``d_xbc`` wide), that heads [h0, h1) read: their x channels and the
    whole B and C (every head of a group reads its group's).  ``t`` itself
    for every head (None)."""
    if heads is None:
        return t
    d_inner, _, hd, _, _ = ssm_dims(cfg)
    return torch.cat([t[..., heads[0] * hd: heads[1] * hd], t[..., d_inner:]], dim=-1)


def project(params: Params, x: torch.Tensor) -> torch.Tensor:
    """The input projection (B, S, 2 d_inner + 2 G N + H) of x (B, S, d)."""
    return x @ params["in_proj"].to(x.dtype)


def split_proj(proj: torch.Tensor, cfg: ModelConfig, heads=None) -> tuple:
    """(z, xbc_raw, dt_raw) of the projection for heads [h0, h1) (every head
    for None): their z and dt columns, and their x channels of xbc with the
    whole B and C (:func:`xbc_part`)."""
    d_inner, n_heads, hd, _, _ = ssm_dims(cfg)
    z = _heads(proj[..., :d_inner], heads, hd)
    xbc_raw = xbc_part(proj[..., d_inner:-n_heads], cfg, heads)
    return z, xbc_raw, _heads(proj[..., -n_heads:], heads)


def conv(xbc_raw: torch.Tensor, params: Params, cfg: ModelConfig, heads=None) -> torch.Tensor:
    """The activated depthwise causal conv of the channels heads [h0, h1)
    read (:func:`xbc_part`), from the whole ``conv_w`` / ``conv_b``."""
    dt_ = xbc_raw.dtype
    w = xbc_part(params["conv_w"].to(dt_), cfg, heads)
    b = xbc_part(params["conv_b"].to(dt_), cfg, heads)
    return F.silu(_causal_conv(xbc_raw, w, b))


def conv_step(tail: torch.Tensor, row: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step of the causal conv on a channel range: the rolling
    window [``tail`` (B, K-1, C), ``row`` (B, 1, C)] against ``w`` (K, C)
    and ``b`` (C,) of the same channels.  Returns (the activated row
    (B, 1, C), the new tail)."""
    win = torch.cat([tail, row], dim=1)  # (B, K, C)
    conv_out = torch.einsum("bkc,kc->bc", win, w) + b
    return F.silu(conv_out)[:, None, :], win[:, 1:, :]


def _split_xbc(xbc: torch.Tensor, cfg: ModelConfig, heads=None):
    """(x (B, S, h, P), B, C (B, S, h, N)) of heads [h0, h1) (every head for
    None) from their xbc channels (:func:`xbc_part`)."""
    d_inner, n_heads, hd, n_groups, d_state = ssm_dims(cfg)
    nx = d_inner if heads is None else (heads[1] - heads[0]) * hd
    x = xbc[..., :nx]
    bmat = xbc[..., nx: nx + n_groups * d_state]
    cmat = xbc[..., nx + n_groups * d_state:]
    bsz, s = x.shape[:2]
    x = x.reshape(bsz, s, nx // hd, hd)
    rep = n_heads // n_groups
    bmat = bmat.reshape(bsz, s, n_groups, d_state).repeat_interleave(rep, dim=2)
    cmat = cmat.reshape(bsz, s, n_groups, d_state).repeat_interleave(rep, dim=2)
    if heads is not None:
        bmat, cmat = bmat[:, :, heads[0]: heads[1]], cmat[:, :, heads[0]: heads[1]]
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


def scan(params: Params, xs: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
         dt_raw: torch.Tensor, cfg: ModelConfig, heads=None) -> tuple:
    """The chunked scan of heads [h0, h1) (every head for None) with their
    skip term: (y (B, S, h P), the final state (B, h, N, P))."""
    dt_ = xs.dtype
    dt = F.softplus(dt_raw.to(torch.float32) + _heads(params["dt_bias"], heads).to(torch.float32))
    a = -torch.exp(_heads(params["a_log"], heads).to(torch.float32))
    y, hlast = ssd_scan(xs, dt, a, bmat, cmat, cfg.ssm.chunk)
    y = y + xs * _heads(params["d_skip"], heads).to(dt_)[None, None, :, None]
    return y.reshape(*xs.shape[:2], -1), hlast


def gated_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor, eps: float,
               mean_sq=None) -> torch.Tensor:
    """``rms_norm(y * silu(z), w)``.  With ``mean_sq`` the mean of squares
    is ``mean_sq`` of the float32 sum of squares of this part of the row
    (a norm whose row is split across ranks: the caller sums the parts and
    divides by the whole width)."""
    g = y * F.silu(z)
    if mean_sq is None:
        return rms_norm(g, w, eps)
    dt = g.dtype
    gf = g.to(torch.float32)
    var = mean_sq(torch.sum(torch.square(gf), dim=-1, keepdim=True))
    return ((gf * torch.rsqrt(var + eps)) * w.to(torch.float32)).to(dt)


def ssd_block(params: Params, x: torch.Tensor, cfg: ModelConfig, return_cache: bool = False):
    """Full-sequence Mamba-2 block (training / prefill).  x: (B, S, d).

    With ``return_cache`` also returns the decode cache (final SSM state +
    causal-conv tail) so prefill can hand off to ``ssd_decode``.  Its steps
    (:func:`project`, :func:`split_proj`, :func:`conv`, :func:`_split_xbc`,
    :func:`scan`, :func:`gated_norm`, the output projection) take a head
    range, which the tensor-parallel block (``launch/tp_model.py``) runs
    on one rank's heads.
    """
    dt_ = x.dtype
    proj = project(params, x)
    z, xbc_raw, dt_raw = split_proj(proj, cfg)
    xs, bmat, cmat = _split_xbc(conv(xbc_raw, params, cfg), cfg)
    y, hlast = scan(params, xs, bmat, cmat, dt_raw, cfg)
    y = gated_norm(y, z, params["norm_w"], cfg.rms_eps)
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


def state_step(params: Params, xs: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
               dt_raw: torch.Tensor, state: torch.Tensor, heads=None) -> tuple:
    """One token of the exact recurrence for heads [h0, h1) (every head for
    None), from their state (B, h, N, P): (y (B, 1, h P), the new state)."""
    dt_ = xs.dtype
    dt = F.softplus(
        dt_raw.to(torch.float32) + _heads(params["dt_bias"], heads).to(torch.float32)
    )[:, 0]  # (B,h)
    a = -torch.exp(_heads(params["a_log"], heads).to(torch.float32))
    decay = torch.exp(dt * a[None, :])  # (B,h)
    xs32 = xs.to(torch.float32)[:, 0]
    b32 = bmat.to(torch.float32)[:, 0]
    c32 = cmat.to(torch.float32)[:, 0]
    state = state * decay[..., None, None] + torch.einsum(
        "bh,bhn,bhp->bhnp", dt, b32, xs32
    )
    y = torch.einsum("bhn,bhnp->bhp", c32, state).to(dt_)
    y = y + xs[:, 0] * _heads(params["d_skip"], heads).to(dt_)[None, :, None]
    return y.reshape(xs.shape[0], 1, -1), state


def ssd_decode(
    params: Params, x: torch.Tensor, cache: Params, cfg: ModelConfig
) -> tuple[torch.Tensor, Params]:
    """Single-token decode.  x: (B, 1, d); O(1) state update."""
    dt_ = x.dtype
    z, xbc, dt_raw = split_proj(project(params, x), cfg)
    # rolling causal-conv cache: window = [conv_cache, xbc_t]
    xbc_t, new_conv = conv_step(cache["conv"], xbc, params["conv_w"].to(dt_),
                                params["conv_b"].to(dt_))
    xs, bmat, cmat = _split_xbc(xbc_t, cfg)  # (B,1,H,P), (B,1,H,N)
    y, state = state_step(params, xs, bmat, cmat, dt_raw, cache["state"])
    y = gated_norm(y, z, params["norm_w"], cfg.rms_eps)
    return y @ params["out_proj"].to(dt_), {"state": state, "conv": new_conv}
