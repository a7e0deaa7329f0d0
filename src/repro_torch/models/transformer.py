"""Model assembly: init / forward / prefill / decode for every family.

Counterpart of ``repro.models.transformer``.  Parameters are nested dicts
with layer-stacked leaves (leading axis L), the reference's layout, so a
tree carries across by a plain map (``repro_torch.convert``) and
``repro_torch.traffic.apply_weight_ordering`` applies unchanged.  The
reference's ``lax.scan`` over that axis is a Python loop over it here.

The forward is differentiable for every family (``repro_torch.train``
takes the gradient of ``lm_loss(...) + aux`` with autograd): no in-place
write, ``.item()`` or integer round trip lies on a path that carries a
gradient.  ``cfg.remat`` and ``cfg.scan_layers`` are accepted and have no
effect: there is no traced loop to unroll, and autograd keeps every
layer's activations, and the bfloat16 copy of each float32 weight, for
the backward instead of recomputing them (what that costs at full width is
in PERF.md §5, phase 3g of ``chip_smoke.py``).

Families:
  dense / vlm      -- GQA attention + (Ge/Swi)GLU MLP stack
  moe              -- attention + top-k MoE MLP
  ssm              -- Mamba-2 / SSD stack (attention-free)
  hybrid           -- SSD stack with one SHARED attention+MLP block applied
                      after every ``shared_attn_every`` SSM layers (zamba2)
  encdec / audio   -- encoder (bidirectional) + causal decoder with
                      cross-attention (whisper); frame frontend is a stub

Entry points build on ``cuda`` unless the caller names another device
(``init_params(..., device=)``); the rest follow their inputs' device.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..kernels.backend import resolve_device
from .config import ModelConfig
from .layers import (
    _qkv,
    attention,
    attention_decode,
    cross_attention,
    dense_init,
    encode_kv,
    init_attention,
    init_mlp,
    mlp,
    normal,
    rms_norm,
    torch_dtype,
)
from .moe import init_moe, moe_block
from .ssd import init_ssd, init_ssd_cache, ssd_block, ssd_decode

Params = Dict[str, Any]

# the subtrees of a parameter tree whose leaves stack the layers on axis 0
STACKED = ("layers", "enc_layers", "trailing")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def _init_layer(gen, cfg: ModelConfig, kind: str, lead: tuple, device) -> Params:
    """One layer's parameters, every shape prefixed by ``lead``: ``(n,)``
    draws ``n`` layers at once, stacked on a leading axis."""
    pdt = torch_dtype(cfg.param_dtype)
    d = cfg.d_model

    def ones():
        return torch.ones((*lead, d), dtype=pdt, device=device)

    if kind == "ssm":
        return {"norm": ones(), "ssd": init_ssd(gen, cfg, lead, device)}
    p: Params = {"attn_norm": ones(), "attn": init_attention(gen, cfg, lead, device),
                 "mlp_norm": ones()}
    if kind == "moe":
        p["moe"] = init_moe(gen, cfg, lead, device)
    else:
        p["mlp"] = init_mlp(gen, cfg, cfg.d_ff, lead, device)
    if kind == "dec":
        p["cross_norm"] = ones()
        p["cross_attn"] = init_attention(gen, cfg, lead, device)
    return p


def init_params(
    cfg: ModelConfig, generator: torch.Generator | None, device: str | torch.device | None = None
) -> Params:
    """Random parameters with the reference's tree, shapes, dtypes and init
    scales (``dense_init``: normal / sqrt(fan-in); embeddings normal x
    0.02).  Values come from ``generator`` (drawn on its device, then
    moved to ``device``, ``cuda`` unless named), so they differ from the
    JAX RNG's: parity tests carry the reference's weights across."""
    dev = resolve_device(device)
    pdt = torch_dtype(cfg.param_dtype)
    p: Params = {
        "embed": (normal(generator, (cfg.vocab, cfg.d_model), dev) * 0.02).to(pdt),
        "final_norm": torch.ones((cfg.d_model,), dtype=pdt, device=dev),
    }
    if not cfg.tie_embeddings:
        p["head"] = dense_init(generator, (cfg.d_model, cfg.vocab), cfg.d_model,
                               cfg.param_dtype, dev)
    fam = cfg.family
    if fam in ("dense", "vlm"):
        p["layers"] = _init_layer(generator, cfg, "attn", (cfg.n_layers,), dev)
    elif fam == "moe":
        p["layers"] = _init_layer(generator, cfg, "moe", (cfg.n_layers,), dev)
    elif fam == "ssm":
        p["layers"] = _init_layer(generator, cfg, "ssm", (cfg.n_layers,), dev)
    elif fam == "hybrid":
        groups = cfg.n_layers // cfg.shared_attn_every
        trailing = cfg.n_layers % cfg.shared_attn_every
        p["layers"] = _init_layer(generator, cfg, "ssm", (groups * cfg.shared_attn_every,), dev)
        if trailing:
            p["trailing"] = _init_layer(generator, cfg, "ssm", (trailing,), dev)
        p["shared"] = _init_layer(generator, cfg, "attn", (), dev)
    elif fam in ("encdec", "audio"):
        p["enc_layers"] = _init_layer(generator, cfg, "attn", (cfg.n_enc_layers,), dev)
        p["enc_norm"] = torch.ones((cfg.d_model,), dtype=pdt, device=dev)
        p["layers"] = _init_layer(generator, cfg, "dec", (cfg.n_layers,), dev)
    else:
        raise ValueError(f"unknown family {fam}")
    return p


def param_shapes(cfg: ModelConfig) -> Params:
    """Abstract init (no allocation): the tree of ``meta`` tensors, each
    with the shape and dtype of its parameter."""
    return init_params(cfg, None, device="meta")


# --------------------------------------------------------------------------
# layer bodies
# --------------------------------------------------------------------------


def _layer(tree: Params, i: int) -> Params:
    """Layer ``i`` of a stacked tree (views, no copy).  A stacked leaf is a
    tensor with a leading layer axis, or the sequence of its layers (how
    ``repro_torch.train`` hands each layer to autograd as its own leaf)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _n_layers(tree: Params) -> int:
    for v in tree.values():
        return _n_layers(v) if isinstance(v, dict) else len(v)
    return 0


def _stack(trees: list) -> Any:
    """Stack a list of same-structured trees (or tensors) on a new axis 0."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _attn_layer(lp: Params, h, cfg: ModelConfig, positions, causal=True):
    a = attention(lp["attn"], rms_norm(h, lp["attn_norm"], cfg.rms_eps), cfg, positions, causal)
    h = h + a
    m = mlp(lp["mlp"], rms_norm(h, lp["mlp_norm"], cfg.rms_eps), cfg)
    return h + m


def _moe_layer(lp: Params, h, cfg: ModelConfig, positions):
    a = attention(lp["attn"], rms_norm(h, lp["attn_norm"], cfg.rms_eps), cfg, positions, True)
    h = h + a
    y, aux = moe_block(lp["moe"], rms_norm(h, lp["mlp_norm"], cfg.rms_eps), cfg)
    return h + y, aux


def _ssm_layer(lp: Params, h, cfg: ModelConfig):
    return h + ssd_block(lp["ssd"], rms_norm(h, lp["norm"], cfg.rms_eps), cfg)


def _dec_layer(lp: Params, h, ek, ev, cfg, positions):
    h = h + attention(lp["attn"], rms_norm(h, lp["attn_norm"], cfg.rms_eps), cfg, positions, True)
    h = h + cross_attention(lp["cross_attn"], rms_norm(h, lp["cross_norm"], cfg.rms_eps),
                            ek, ev, cfg)
    h = h + mlp(lp["mlp"], rms_norm(h, lp["mlp_norm"], cfg.rms_eps), cfg)
    return h


# --------------------------------------------------------------------------
# forward (training / full-sequence)
# --------------------------------------------------------------------------


def embed_tokens(params: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    h = F.embedding(tokens.long(), params["embed"]).to(torch_dtype(cfg.dtype))
    return h * math.sqrt(cfg.d_model)


def _positions(s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None, :]


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    causal: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decoder-only forward.  Returns (hidden (B,S,d), aux_loss)."""
    if inputs_embeds is not None and tokens is not None:
        text = embed_tokens(params, cfg, tokens)
        h = torch.cat([inputs_embeds.to(text.dtype), text], dim=1)
    elif tokens is not None:
        h = embed_tokens(params, cfg, tokens)
    else:
        h = inputs_embeds.to(torch_dtype(cfg.dtype))
    if positions is None:
        positions = _positions(h.shape[1], h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    fam = cfg.family
    layers = params.get("layers")

    if fam in ("dense", "vlm"):
        for i in range(_n_layers(layers)):
            h = _attn_layer(_layer(layers, i), h, cfg, positions, causal)
    elif fam == "moe":
        auxs = []
        for i in range(_n_layers(layers)):
            h, a = _moe_layer(_layer(layers, i), h, cfg, positions)
            auxs.append(a)
        aux = aux + torch.stack(auxs).sum()
    elif fam in ("ssm", "hybrid"):
        for tree, i in ssm_schedule(cfg):
            if tree == "shared":
                h = _attn_layer(params["shared"], h, cfg, positions)  # shared weights
            else:
                h = _ssm_layer(_layer(params[tree], i), h, cfg)
    else:
        raise ValueError(f"forward() does not handle family {fam}; use encdec_forward")
    return rms_norm(h, params["final_norm"], cfg.rms_eps), aux


# the cache's SSM state tree of each stacked tree of SSM layers
SSM_STATE = {"layers": "ssm", "trailing": "ssm_trailing"}


def ssm_schedule(cfg: ModelConfig):
    """The ssm and hybrid families' layer order, one step at a time:
    ("layers", i) for each SSM layer; in the hybrid family, after each group
    of ``shared_attn_every`` of them ("shared", g), the shared block's g-th
    use (its KV cache slot), and after the last group ("trailing", i) for
    each of the ``n_layers % shared_attn_every`` SSM layers left.  The first
    of each pair names the tree of ``params`` the layer lives in;
    ``SSM_STATE`` names its cache's state tree."""
    if cfg.family == "ssm":
        yield from (("layers", i) for i in range(cfg.n_layers))
        return
    per = cfg.shared_attn_every
    for g in range(cfg.n_layers // per):
        for j in range(per):
            yield "layers", g * per + j
        yield "shared", g
    for i in range(cfg.n_layers % per):
        yield "trailing", i


def _encode(params: Params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    enc = frames.to(torch_dtype(cfg.dtype))
    enc_pos = _positions(enc.shape[1], enc.device)
    for i in range(_n_layers(params["enc_layers"])):
        enc = _attn_layer(_layer(params["enc_layers"], i), enc, cfg, enc_pos, causal=False)
    return rms_norm(enc, params["enc_norm"], cfg.rms_eps)


def encdec_forward(
    params: Params,
    cfg: ModelConfig,
    frames: torch.Tensor,  # (B, S_enc, d) precomputed frontend embeddings (stub)
    dec_tokens: torch.Tensor,  # (B, S_dec)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Encoder-decoder forward (whisper).  Returns (dec hidden, aux)."""
    enc = _encode(params, cfg, frames)
    h = embed_tokens(params, cfg, dec_tokens)
    dec_pos = _positions(h.shape[1], h.device)
    for i in range(_n_layers(params["layers"])):
        lp = _layer(params["layers"], i)
        ek, ev = encode_kv(lp["cross_attn"], enc, cfg)
        h = _dec_layer(lp, h, ek, ev, cfg, dec_pos)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return rms_norm(h, params["final_norm"], cfg.rms_eps), aux


# --------------------------------------------------------------------------
# logits / loss
# --------------------------------------------------------------------------


def unembed(params: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return h @ w.to(h.dtype)


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sum of CE over valid (label >= 0) positions; returns (sum, count)."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.take_along_dim(lf, torch.clamp_min(labels, 0).long()[..., None], dim=-1)[..., 0]
    valid = labels >= 0
    ce = torch.where(valid, lse - gold, 0.0)
    return ce.sum(), valid.sum()


def lm_loss(params: Params, cfg: ModelConfig, h: torch.Tensor, labels: torch.Tensor):
    """Mean cross-entropy over valid (label >= 0) positions, differentiable
    in ``params`` and ``h``; optionally sequence-chunked (``logits_chunk``)
    to bound the forward's logits memory."""
    chunk = cfg.logits_chunk
    s = h.shape[1]
    if chunk and s % chunk == 0 and s > chunk:
        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        cnt = torch.zeros((), dtype=torch.int64, device=h.device)
        for c0 in range(0, s, chunk):
            cs, cn = _ce(unembed(params, cfg, h[:, c0: c0 + chunk]), labels[:, c0: c0 + chunk])
            tot, cnt = tot + cs, cnt + cn
        return tot / torch.clamp_min(cnt, 1)
    tot, cnt = _ce(unembed(params, cfg, h), labels)
    return tot / torch.clamp_min(cnt, 1)


# --------------------------------------------------------------------------
# prefill / decode (serving)
# --------------------------------------------------------------------------


def init_cache(
    cfg: ModelConfig, batch: int, max_len: int, enc_len: int = 0,
    device: str | torch.device | None = None,
) -> Params:
    """Zeroed cache for every family (``cuda`` unless ``device`` is named);
    ``pos`` is a 0-d int32 tensor, as the reference's."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    fam = cfg.family

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def ssm_stack(n):
        return {k: zeros(n, *v.shape, dtype=v.dtype)
                for k, v in init_ssd_cache(cfg, batch, dt, "meta").items()}

    cache: Params = {"pos": zeros(dtype=torch.int32)}
    if fam in ("dense", "vlm", "moe", "encdec", "audio"):
        cache["k"] = zeros(cfg.n_layers, batch, max_len, hkv, hd)
        cache["v"] = zeros(cfg.n_layers, batch, max_len, hkv, hd)
        if fam in ("encdec", "audio"):
            cache["cross_k"] = zeros(cfg.n_layers, batch, enc_len, hkv, hd)
            cache["cross_v"] = zeros(cfg.n_layers, batch, enc_len, hkv, hd)
    elif fam == "ssm":
        cache["ssm"] = ssm_stack(cfg.n_layers)
    elif fam == "hybrid":
        per = cfg.shared_attn_every
        groups = cfg.n_layers // per
        trailing = cfg.n_layers % per
        cache["ssm"] = ssm_stack(groups * per)
        if trailing:
            cache["ssm_trailing"] = ssm_stack(trailing)
        cache["k"] = zeros(groups, batch, max_len, hkv, hd)
        cache["v"] = zeros(groups, batch, max_len, hkv, hd)
    return cache


def prefill(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    max_len: int,
    frames: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, Params]:
    """Process a prompt, returning (last-position logits, populated cache).

    ``max_len`` is the cache capacity (>= prompt length).  For encdec,
    ``frames`` is the encoder input (stub frontend embeddings) and ``tokens``
    the decoder prompt.
    """
    fam = cfg.family
    eps = cfg.rms_eps
    dt = torch_dtype(cfg.dtype)
    if inputs_embeds is not None:
        text = embed_tokens(params, cfg, tokens)
        h = torch.cat([inputs_embeds.to(text.dtype), text], dim=1)
    else:
        h = embed_tokens(params, cfg, tokens)
    b, s = h.shape[0], h.shape[1]
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds cache capacity {max_len}")
    dev = h.device
    positions = _positions(s, dev)
    cache = init_cache(cfg, b, max_len, enc_len=frames.shape[1] if frames is not None else 0,
                       device=dev)
    pos = torch.tensor(s, dtype=torch.int32, device=dev)

    def pad_kv(k):  # (B, S, Hkv, D) -> (B, max_len, Hkv, D)
        return F.pad(k, (0, 0, 0, 0, 0, max_len - s)).to(dt)

    def kv_of(lp, x):
        _, k, v = _qkv(lp["attn"], rms_norm(x, lp["attn_norm"], eps), cfg, positions)
        return pad_kv(k), pad_kv(v)

    if fam in ("dense", "vlm", "moe"):
        # run the layer normally; re-project k/v from the normed input for
        # the cache (the reference's one code path)
        ks, vs = [], []
        layers = params["layers"]
        for i in range(_n_layers(layers)):
            lp = _layer(layers, i)
            k, v = kv_of(lp, h)
            if fam == "moe":
                h, _aux = _moe_layer(lp, h, cfg, positions)
            else:
                h = _attn_layer(lp, h, cfg, positions)
            ks.append(k)
            vs.append(v)
        cache.update(k=torch.stack(ks), v=torch.stack(vs), pos=pos)

    elif fam in ("ssm", "hybrid"):
        scs, ks, vs = {"layers": [], "trailing": []}, [], []
        for tree, i in ssm_schedule(cfg):
            if tree == "shared":
                k, v = kv_of(params["shared"], h)
                h = _attn_layer(params["shared"], h, cfg, positions)
                ks.append(k)
                vs.append(v)
                continue
            lp = _layer(params[tree], i)
            y, sc = ssd_block(lp["ssd"], rms_norm(h, lp["norm"], eps), cfg, return_cache=True)
            h = h + y
            scs[tree].append(sc)
        cache.update({SSM_STATE[t]: _stack(x) for t, x in scs.items() if x}, pos=pos)
        if ks:
            cache.update(k=torch.stack(ks), v=torch.stack(vs))

    elif fam in ("encdec", "audio"):
        enc = _encode(params, cfg, frames)
        ks, vs, eks, evs = [], [], [], []
        for i in range(_n_layers(params["layers"])):
            lp = _layer(params["layers"], i)
            ek, ev = encode_kv(lp["cross_attn"], enc, cfg)
            k, v = kv_of(lp, h)
            h = _dec_layer(lp, h, ek, ev, cfg, positions)
            ks.append(k)
            vs.append(v)
            eks.append(ek.to(dt))
            evs.append(ev.to(dt))
        cache.update(k=torch.stack(ks), v=torch.stack(vs), cross_k=torch.stack(eks),
                     cross_v=torch.stack(evs), pos=pos)
    else:
        raise ValueError(fam)

    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    return unembed(params, cfg, h[:, -1:, :]), cache


def decode_step(
    params: Params, cfg: ModelConfig, cache: Params, tokens: torch.Tensor
) -> tuple[torch.Tensor, Params]:
    """One decode step.  tokens: (B, 1).  Returns (logits (B,1,V), cache);
    the cache passed in is not modified."""
    h = embed_tokens(params, cfg, tokens)
    pos = cache["pos"]
    fam = cfg.family
    eps = cfg.rms_eps

    def attn_step(lp, h, ck, cv):
        y, nk, nv = attention_decode(lp["attn"], rms_norm(h, lp["attn_norm"], eps), ck, cv,
                                     pos, cfg)
        return h + y, nk, nv

    def ssm_step(lp, state, h):
        y, nsc = ssd_decode(lp["ssd"], rms_norm(h, lp["norm"], eps), state, cfg)
        return h + y, nsc

    if fam in ("dense", "vlm", "moe"):
        nks, nvs = [], []
        for i in range(_n_layers(params["layers"])):
            lp = _layer(params["layers"], i)
            h, nk, nv = attn_step(lp, h, cache["k"][i], cache["v"][i])
            x = rms_norm(h, lp["mlp_norm"], eps)
            if fam == "moe":
                m, _ = moe_block(lp["moe"], x, cfg, dropless=True)
            else:
                m = mlp(lp["mlp"], x, cfg)
            h = h + m
            nks.append(nk)
            nvs.append(nv)
        new_cache = {**cache, "k": torch.stack(nks), "v": torch.stack(nvs), "pos": pos + 1}

    elif fam in ("ssm", "hybrid"):
        new_cache = {**cache, "pos": pos + 1}
        if fam == "hybrid":
            # each use's new keys and values go straight into one stacked
            # copy: the cache passed in, that copy and one use's new rows are
            # alive at once (long_500k's cache is 25.8 GB)
            new_cache.update(k=torch.empty_like(cache["k"]), v=torch.empty_like(cache["v"]))
        nscs = {"layers": [], "trailing": []}
        for tree, i in ssm_schedule(cfg):
            if tree == "shared":
                shared = params["shared"]
                h, new_cache["k"][i], new_cache["v"][i] = attn_step(shared, h, cache["k"][i],
                                                                    cache["v"][i])
                h = h + mlp(shared["mlp"], rms_norm(h, shared["mlp_norm"], eps), cfg)
            else:
                h, nsc = ssm_step(_layer(params[tree], i), _layer(cache[SSM_STATE[tree]], i), h)
                nscs[tree].append(nsc)
        new_cache.update({SSM_STATE[t]: _stack(x) for t, x in nscs.items() if x})

    elif fam in ("encdec", "audio"):
        nks, nvs = [], []
        for i in range(_n_layers(params["layers"])):
            lp = _layer(params["layers"], i)
            h, nk, nv = attn_step(lp, h, cache["k"][i], cache["v"][i])
            x = rms_norm(h, lp["cross_norm"], eps)
            h = h + cross_attention(lp["cross_attn"], x, cache["cross_k"][i],
                                    cache["cross_v"][i], cfg)
            h = h + mlp(lp["mlp"], rms_norm(h, lp["mlp_norm"], eps), cfg)
            nks.append(nk)
            nvs.append(nv)
        new_cache = {**cache, "k": torch.stack(nks), "v": torch.stack(nvs), "pos": pos + 1}
    else:
        raise ValueError(fam)

    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    return unembed(params, cfg, h), new_cache
