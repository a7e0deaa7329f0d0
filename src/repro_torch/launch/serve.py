"""Placed serving: prefill, decode and greedy generation over a mesh.

Counterparts of ``models.transformer.prefill`` / ``decode_step`` and
``serve.loop.generate`` for the dense, vlm, MoE, ssm, hybrid and
encoder-decoder families under the reference's serving rules: the weights
split over "model" by ``param_spec`` (mode "serve"; a MoE's experts over
"model", run by ``tp_model.moe_block``: capacity-bounded in prefill,
dropless in decode, as ``models.transformer``'s; the SSD projections on
their contraction, run by ``tp_model.ssd_block`` / ``ssd_decode``), the
requests over the data-parallel axes by ``batch_shardings``, and the cache
by ``cache_shardings``.  An SSM layer's cache holds the state of the rank's
heads (all of them when "model" does not divide the heads) and, when the
rules split it, a contiguous ``d_xbc / m`` block of the conv tail's
channels, which does not line up with ``[x heads | B | C]``: the conv is
depthwise, so a rank convolves the new row's channels of its own block
with its own tail and all-gathers the activated row.  The KV cache (of
the dense, vlm, MoE and hybrid families):

  * ``hkv % m == 0``: the cache is split on its kv heads, and each rank's
    attention is ``models.layers.attention_decode`` on its own heads;
  * otherwise, with the cache's length divisible by m, its **sequence** is
    split over "model" (the reference's split-K rule).  Each rank keeps
    every kv head for its block of positions and attends its keys with
    every query head (``layers.decode_scores`` and ``block_stats``), and
    the partial results are merged across the group as
    ``layers._merge_blocks`` merges blocks: a MAX all-reduce of the score
    maxima, ``rescale_block``, one SUM all-reduce of the sums and
    accumulators.  Under a head split the query heads are all-gathered
    first and each rank keeps its own heads of the result; under
    attention's contraction split (``tp_model``: heads the axis does not
    divide) every rank already holds every query head.  The new token's
    keys are written by the rank whose block holds its position;
  * otherwise the cache is whole on every rank, and each rank attends
    (``layers.decode_attend``) over the kv heads its query heads use (all
    of them under the contraction split).

With a batch that the data-parallel axes do not divide (``long_500k``'s
one request), the rules split the KV cache's **sequence** over them
(sequence parallelism, SP) and its kv heads over "model": each rank
attends its heads over its block of positions, and the ranks merge over
the data-parallel group as split-K merges over "model" (a MAX, then one
SUM all-reduce).  The new token's keys and values are written by the data
rank whose block holds its position; the tokens and the SSM state are
replicated over the data-parallel axes, as GSPMD runs them.  A prompt
whose sequence the rules split (SP prefill) is refused by
:func:`shard_batch`: ``long_500k`` is a decode cell.

The encoder-decoder (whisper): prefill runs ``tp_model.encode`` on the
frames once (the frames split over the data-parallel axes by their rows,
as the prompts are), then, for each decoder layer, writes
``tp_model.cross_kv``'s keys and values of the rank's kv heads into the
cross cache (``cross_k`` / ``cross_v``, which ``cache_shardings`` places
on their kv heads as it places ``k`` / ``v``), fills the self-attention
cache as the other families do and runs ``tp_model.dec_layer``
(``models.transformer.prefill``'s order).  Decode runs the
self-attention as above, then ``tp_model.cross_block`` against the
rank's cross cache, then the MLP (``decode_step``'s order).  A cross
cache that the rules split any other way than on its kv heads is refused
(:func:`cross_mode`).

The vlm family (internvl2) serves as the dense family does behind its
precomputed patch embeddings: prefill puts a request's patches (split over
the data-parallel axes by their rows, as the prompts are) in front of its
text through ``tp_model.embed_inputs`` and fills the cache for every
position, patches first, as ``models.transformer.prefill`` does with
``inputs_embeds``; the cache's ``pos`` and length count them, so
:func:`generate`'s cache holds ``n_patches + prompt + new`` positions and
that length decides the cache's placement.  Decode is the dense family's.

Under the contraction split the whole queries come from the partial sum
of ``tp_model.contracted_qkv`` and the output from
``tp_model.contracted_out``, in prefill (through ``tp_model.layer``) as
in decode; the prompt's cache is built from the whole ``wk`` / ``wv``.

The logits come out as ``DryrunCase.shardings`` places them: this rank's
vocabulary block when "model" divides the vocabulary, else whole.  Greedy
decoding takes the argmax and its log-probability across the blocks (a MAX,
a MIN and a SUM all-reduce of per-request values): the lowest index of the
largest logit, as ``torch.argmax``.  Sampling and the traffic taps stay
with ``serve.loop.generate``.

On a (1, 1) mesh every function runs the one-process op sequence.  Every
collective goes through ``launch/tp.py``, so the meta dry run records a
serving step's collectives by running these functions on ``meta``
tensors over stand-in groups.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from .. import _obs_hooks
from .._tree import tree_map
from ..models.layers import (_finalize, attention_decode, block_stats, decode_attend,
                             decode_scores, decode_write, norm_rope, project_kv, rescale_block,
                             rms_norm, torch_dtype, write_kv)
from ..models.transformer import (SSM_STATE, _layer, _n_layers, _positions, _stack,
                                  init_cache, ssm_schedule)
from ..serve.loop import GenerateResult
from . import tp_model
from .mesh import dp_axes
from .sharding import batch_shardings, cache_shardings, params_shardings
from .step import block
from .tp import AxisGroup, all_reduce, axis_group, gather_from_model, reduce_from_model

__all__ = ["shard_params", "shard_batch", "kv_mode", "cross_mode", "sp_group", "prefill",
           "decode_step", "generate"]


def shard_params(cfg, mesh, params: Any) -> Any:
    """This rank's blocks of the serving weights (whole on every rank)."""
    return tree_map(block, params, params_shardings(cfg, mesh, params, mode="serve"))


def shard_batch(cfg, mesh, tensors: dict) -> dict:
    """This rank's requests (rows) of the whole batch ``tensors``."""
    sh = batch_shardings(cfg, mesh, tensors)
    for k, s in sh.items():
        if any(e is not None for e in s.spec[1:]):
            raise ValueError(f"{k!r} {tuple(tensors[k].shape)}: the rules split dims {s.spec}, "
                             f"not its rows; placed serving splits requests only")
    return {k: block(v, sh[k]) for k, v in tensors.items()}


def _kv_spec(cfg, mesh, batch: int, max_len: int):
    """The rules' spec of the KV cache's keys, padded to 5 dims, or None for
    a family with no KV cache."""
    shapes = init_cache(cfg, batch, max_len, device="meta")
    if "k" not in shapes:
        return None
    spec = cache_shardings(cfg, mesh, shapes)["k"].spec
    return tuple(spec) + (None,) * (5 - len(spec))


def kv_mode(cfg, mesh, batch: int, max_len: int) -> str:
    """How ``cache_shardings`` places the KV cache over "model": "heads",
    "seq" (split-K) or "whole"; "none" for a family with no KV cache."""
    spec = _kv_spec(cfg, mesh, batch, max_len)
    if spec is None:
        return "none"
    return "heads" if spec[3] == "model" else "seq" if spec[2] == "model" else "whole"


def cross_mode(cfg, mesh, batch: int, enc_len: int) -> str:
    """How ``cache_shardings`` places an encoder-decoder's cross cache over
    "model": "heads", the one placement served here; raises naming any
    other split.  "none" for a family with no cross cache."""
    shapes = init_cache(cfg, batch, 1, enc_len=enc_len, device="meta")
    if "cross_k" not in shapes:
        return "none"
    spec = cache_shardings(cfg, mesh, shapes)["cross_k"].spec
    spec = tuple(spec) + (None,) * (5 - len(spec))
    if spec[3] != "model" or spec[2] is not None:
        raise ValueError(f"{cfg.name}: the rules place the cross cache "
                         f"{tuple(shapes['cross_k'].shape)} as {spec}; placed serving takes it "
                         f"split on its kv heads only")
    return "heads"


def sp_group(cfg, mesh, batch: int, max_len: int) -> AxisGroup:
    """The data-parallel group over which ``cache_shardings`` splits the KV
    cache's sequence (SP: a batch the data-parallel axes do not divide);
    one rank when it does not."""
    spec = _kv_spec(cfg, mesh, batch, max_len)
    if spec is None or spec[2] in (None, "model"):
        return AxisGroup(1)
    return axis_group(mesh, dp_axes(mesh))


# --------------------------------------------------------------------------
# the cache's keys and values
# --------------------------------------------------------------------------


def _split(plan, mode: str, sp: AxisGroup) -> AxisGroup:
    """The group whose ranks hold the cache's blocks of positions: "model"
    under split-K, the data-parallel group under SP, else one rank."""
    return plan.model if mode == "seq" else sp


def _span(g: AxisGroup, length: int) -> tuple[int, int]:
    """The positions [a, b) of a cache of ``length`` split over ``g`` that
    this rank holds."""
    n = length // g.size
    return g.index * n, (g.index + 1) * n


def _cache_kv(lp, x, plan, positions, max_len: int, mode: str, sp: AxisGroup):
    """The prompt's keys and values for this rank's cache (from the normed
    ``x``, as ``models.prefill`` re-projects them), padded to its length:
    its own kv heads ("heads") or every kv head, of its block of positions
    (split-K, SP) or of all of them."""
    dt = torch_dtype(plan.cfg.dtype)
    s = x.shape[1]
    a, b = _span(_split(plan, mode, sp), max_len)
    length, a, b = b - a, min(a, s), min(b, s)
    k, v = project_kv(lp, x[:, a:b])
    _, k = norm_rope(lp, None, k, plan.cfg, positions[:, a:b])

    def pad(t):  # (B, b - a, H, D) -> (B, length, H, D)
        return F.pad(t, (0, 0, 0, 0, 0, length - (b - a))).to(dt)

    return pad(k), pad(v)


# --------------------------------------------------------------------------
# prefill / decode
# --------------------------------------------------------------------------


def prefill(params: dict, plan: tp_model.Plan, tokens: torch.Tensor, max_len: int,
            mode: str, sp: AxisGroup = AxisGroup(1), frames: torch.Tensor | None = None,
            patches: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """This rank's prompt rows ``tokens`` (and, for the encoder-decoder, the
    same rows of ``frames``; for the vlm family, of ``patches``, which go
    first) through its weight blocks: (last-position logits, placed as the
    module says; this rank's cache placed by ``mode`` and ``sp``, its cross
    cache on the rank's kv heads)."""
    cfg = plan.cfg
    eps = cfg.rms_eps
    h = tp_model.embed_inputs(params, plan, tokens, patches)
    s = h.shape[1]
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds cache capacity {max_len}")
    positions = _positions(s, h.device)
    cache = {"pos": torch.tensor(s, dtype=torch.int32, device=h.device)}
    ks, vs = [], []

    def attn_layer(lp, h):
        k, v = _cache_kv(lp["attn"], rms_norm(h, lp["attn_norm"], eps), plan, positions,
                         max_len, mode, sp)
        ks.append(k)
        vs.append(v)
        return tp_model.layer(lp, h, plan, positions)[0]

    def ssm_layer(lp, h, caches):
        y, c = tp_model.ssd_block(lp["ssd"], rms_norm(h, lp["norm"], eps), plan,
                                  return_cache=True)
        caches.append(c)
        return h + y

    layers = params["layers"]
    if cfg.family in ("encdec", "audio"):  # models.transformer.prefill's order
        if frames is None:
            raise ValueError(f"{cfg.name}: the encoder-decoder's prefill needs frames")
        dt = torch_dtype(cfg.dtype)
        enc = tp_model.encode(params, plan, frames)
        cks, cvs = [], []
        for i in range(_n_layers(layers)):
            lp = _layer(layers, i)
            ek, ev = tp_model.cross_kv(lp["cross_attn"], enc, plan)
            k, v = _cache_kv(lp["attn"], rms_norm(h, lp["attn_norm"], eps), plan, positions,
                             max_len, mode, sp)
            h = tp_model.dec_layer(lp, h, ek, ev, plan, positions)
            ks.append(k)
            vs.append(v)
            cks.append(ek.to(dt))
            cvs.append(ev.to(dt))
        cache.update(cross_k=torch.stack(cks), cross_v=torch.stack(cvs))
    elif cfg.family in ("ssm", "hybrid"):  # models.transformer.prefill's order
        scs = {"layers": [], "trailing": []}
        for tree, i in ssm_schedule(cfg):
            if tree == "shared":
                h = attn_layer(params["shared"], h)
            else:
                h = ssm_layer(_layer(params[tree], i), h, scs[tree])
        cache.update({SSM_STATE[t]: _stack(x) for t, x in scs.items() if x})
    else:
        for i in range(_n_layers(layers)):
            h = attn_layer(_layer(layers, i), h)
    if ks:
        cache.update(k=torch.stack(ks), v=torch.stack(vs))
    h = rms_norm(h, params["final_norm"], eps)
    return tp_model.logits(params, plan, h[:, -1:, :]), cache


def _attend_split(q, ck, cv, pos, start: int, g: AxisGroup):
    """``q`` (B, 1, H, D) over this rank's block of a cache split on its
    sequence (positions ``start`` on), merged across ``g`` as
    ``layers._merge_blocks`` merges blocks: a MAX all-reduce of the score
    maxima, each rank's partials rescaled to it, one SUM all-reduce of the
    sums and accumulators (float32)."""
    m, l, acc = block_stats(decode_scores(q, ck, pos, start), cv.to(torch.float32),
                            torch.float32)
    top = all_reduce(m.clone(), g, "max")
    l, acc = rescale_block(m, l, acc, top)
    both = all_reduce(torch.cat([l.reshape(-1), acc.reshape(-1)]), g)
    l, acc = both[: l.numel()].view_as(l), both[l.numel():].view_as(acc)
    return _finalize(top, l, acc).reshape(q.shape).to(q.dtype)


def _attn_decode(lp, x, ck, cv, pos, plan, mode: str, sp: AxisGroup):
    """One layer's decode attention of the normed, replicated ``x`` with
    this rank's cache blocks: (output, replicated; new cache blocks)."""
    cfg, g = plan.cfg, plan.model
    split = _split(plan, mode, sp)
    start = _span(split, ck.shape[1] * split.size)[0]

    def attend(q, k, v):  # over this rank's positions, merged across the split
        return (_attend_split(q, k, v, pos, start, split) if split.size > 1
                else decode_attend(q, k, v, pos))

    if mode == "heads" or plan.attn == "whole":
        if mode == "seq":
            raise ValueError(f"{cfg.name}: a split-K cache needs attention split over 'model'")
        if split.size == 1:
            y, ck, cv = attention_decode(lp, x, ck, cv, pos,
                                         plan.local if mode == "heads" else cfg)
        else:
            q, ck, cv = decode_write(lp, x, ck, cv, pos,
                                     plan.local if mode == "heads" else cfg, start)
            y = torch.einsum("bshk,hkd->bsd", attend(q, ck, cv), lp["wo"].to(x.dtype))
        return (reduce_from_model(y, g) if mode == "heads" else y), ck, cv
    # "whole" or "seq": this rank's cache holds every kv head, so every kv
    # head's new keys are written
    if plan.attn == "contraction":  # q holds every query head
        positions = pos.to(torch.int32).expand(x.shape[0], 1)
        q, k, v = tp_model.contracted_qkv(lp, x, plan, positions)
        ck, cv = write_kv(ck, cv, k, v, pos, start)
        return tp_model.contracted_out(lp, attend(q, ck, cv), plan), ck, cv
    # a head split: q holds this rank's query heads
    q, ck, cv = decode_write(lp, x, ck, cv, pos, cfg, start)
    if mode == "seq":
        hpl = q.shape[2]
        out = attend(gather_from_model(q, g, 2), ck, cv)
        out = out[:, :, g.index * hpl: (g.index + 1) * hpl]
    else:
        out = attend(q, tp_model.take_heads(ck, plan.kv_index, 2),
                     tp_model.take_heads(cv, plan.kv_index, 2))
    y = torch.einsum("bshk,hkd->bsd", out, lp["wo"].to(x.dtype))
    return reduce_from_model(y, g), ck, cv


def decode_step(params: dict, plan: tp_model.Plan, cache: dict, tokens: torch.Tensor,
                mode: str, sp: AxisGroup = AxisGroup(1)) -> tuple[torch.Tensor, dict]:
    """One decode step of this rank's requests ``tokens`` (B, 1) with its
    cache blocks: (logits, placed as the module says; the new cache
    blocks).  The cache passed in is not modified; the new keys and values
    are written layer by layer into one stacked copy."""
    cfg = plan.cfg
    eps = cfg.rms_eps
    h = tp_model.embed(params, plan, tokens)
    pos = cache["pos"]
    new = {**cache, "pos": pos + 1}
    if "k" in cache:
        new["k"], new["v"] = torch.empty_like(cache["k"]), torch.empty_like(cache["v"])

    def attn(lp, h, i):
        y, new["k"][i], new["v"][i] = _attn_decode(
            lp["attn"], rms_norm(h, lp["attn_norm"], eps), cache["k"][i], cache["v"][i], pos,
            plan, mode, sp)
        return h + y

    layers = params["layers"]
    if cfg.family in ("ssm", "hybrid"):  # models.transformer.decode_step's order
        states = {"layers": [], "trailing": []}
        for tree, i in ssm_schedule(cfg):
            if tree == "shared":
                shared = params["shared"]
                h = attn(shared, h, i)
                h = h + tp_model.mlp_block(shared["mlp"], rms_norm(h, shared["mlp_norm"], eps),
                                           plan)
                continue
            lp = _layer(params[tree], i)
            y, c = tp_model.ssd_decode(lp["ssd"], rms_norm(h, lp["norm"], eps),
                                       _layer(cache[SSM_STATE[tree]], i), plan)
            h = h + y
            states[tree].append(c)
        new.update({SSM_STATE[t]: _stack(x) for t, x in states.items() if x})
    else:
        for i in range(_n_layers(layers)):
            lp = _layer(layers, i)
            h = attn(lp, h, i)
            if "cross_attn" in lp:  # the encoder-decoder, against the rank's cross cache
                h = h + tp_model.cross_block(lp["cross_attn"], rms_norm(h, lp["cross_norm"], eps),
                                             cache["cross_k"][i], cache["cross_v"][i], plan)
            x = rms_norm(h, lp["mlp_norm"], eps)
            if cfg.family == "moe":
                m, _ = tp_model.moe_block(lp["moe"], x, plan, dropless=True)
            else:
                m = tp_model.mlp_block(lp["mlp"], x, plan)
            h = h + m
    h = rms_norm(h, params["final_norm"], eps)
    return tp_model.logits(params, plan, h), new


def _greedy(logits: torch.Tensor, plan: tp_model.Plan) -> tuple[torch.Tensor, torch.Tensor]:
    """(argmax token (B, 1), its log-probability (B,)) of the last position
    of placed logits."""
    lf = logits[:, -1].to(torch.float32)
    g = plan.model
    if plan.head != "vocab" or g.size == 1:
        tok = torch.argmax(lf, dim=-1)[:, None]
        return tok, torch.take_along_dim(torch.log_softmax(lf, dim=-1), tok, dim=-1)[:, 0]
    ix = torch.argmax(lf, dim=-1, keepdim=True)
    mx = torch.take_along_dim(lf, ix, dim=-1)[:, 0]
    top = all_reduce(mx.clone(), g, "max")
    last = torch.iinfo(torch.int64).max
    tok = all_reduce(torch.where(mx == top, ix[:, 0] + g.index * lf.shape[-1], last), g, "min")
    se = all_reduce(torch.sum(torch.exp(lf - top[:, None]), dim=-1), g)
    return tok[:, None], -torch.log(se)


@torch.no_grad()
def generate(params: dict, cfg, mesh, prompts: torch.Tensor, max_new_tokens: int,
             frames: torch.Tensor | None = None,
             patches: torch.Tensor | None = None) -> GenerateResult:
    """Greedy generation over ``mesh``: ``params`` are this rank's blocks
    (:func:`shard_params`), ``prompts`` the whole (B, S) batch on every
    rank (and for the encoder-decoder its whole (B, S_enc, d) ``frames``;
    for the vlm family its whole (B, P, d) ``patches``, in front of the
    prompts: the cache holds P + S + ``max_new_tokens`` positions).
    Returns this rank's requests' tokens and log-probabilities, as
    ``serve.loop.generate`` at temperature 0 (with ``inputs_embeds`` the
    patches)."""
    plan = tp_model.make_plan(cfg, mesh, "serve")
    extra = patches.shape[1] if patches is not None else 0
    max_len = extra + prompts.shape[1] + max_new_tokens
    mode = kv_mode(cfg, mesh, prompts.shape[0], max_len)
    sp = sp_group(cfg, mesh, prompts.shape[0], max_len)
    batch = {"tokens": prompts}
    if frames is not None:
        cross_mode(cfg, mesh, prompts.shape[0], frames.shape[1])
        batch["frames"] = frames
    if patches is not None:
        batch["patches"] = patches
    batch = shard_batch(cfg, mesh, batch)
    out_toks, out_lp = [], []
    with _obs_hooks.muted():
        logits, cache = prefill(params, plan, batch["tokens"], max_len, mode, sp,
                                batch.get("frames"), batch.get("patches"))
        for _ in range(max_new_tokens):
            tok, lp = _greedy(logits, plan)
            out_toks.append(tok[:, 0])
            out_lp.append(lp)
            logits, cache = decode_step(params, plan, cache, tok.to(torch.int32), mode, sp)
    return GenerateResult(tokens=torch.stack(out_toks, dim=1),
                          logprobs=torch.stack(out_lp, dim=1))
