"""Placed serving: prefill, decode and greedy generation over a mesh.

Counterparts of ``models.transformer.prefill`` / ``decode_step`` and
``serve.loop.generate`` for the dense and MoE families under the
reference's serving rules: the weights split over "model" by
``param_spec`` (mode "serve"; a MoE's experts over "model", run by
``tp_model.moe_block``: capacity-bounded in prefill, dropless in decode,
as ``models.transformer``'s),
the requests over the data-parallel axes by ``batch_shardings``, and the
KV cache by ``cache_shardings``:

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
from ..models.transformer import _layer, _n_layers, _positions, init_cache
from ..serve.loop import GenerateResult
from . import tp_model
from .sharding import batch_shardings, cache_shardings, params_shardings
from .step import block
from .tp import AxisGroup, all_reduce, gather_from_model, reduce_from_model

__all__ = ["shard_params", "shard_batch", "kv_mode", "prefill", "decode_step", "generate"]


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


def kv_mode(cfg, mesh, batch: int, max_len: int) -> str:
    """How ``cache_shardings`` places the KV cache over "model": "heads",
    "seq" (split-K) or "whole"."""
    shapes = init_cache(cfg, batch, max_len, device="meta")
    spec = cache_shardings(cfg, mesh, shapes)["k"].spec
    spec = tuple(spec) + (None,) * (5 - len(spec))
    if spec[2] is not None and spec[2] != "model":
        raise ValueError(f"cache spec {spec}: its sequence is split over the data-parallel axes "
                         f"(sequence parallelism), which placed serving does not run")
    return "heads" if spec[3] == "model" else "seq" if spec[2] == "model" else "whole"


# --------------------------------------------------------------------------
# the cache's keys and values
# --------------------------------------------------------------------------


def _span(plan, length: int) -> tuple[int, int]:
    """The positions [a, b) of a "seq" cache of ``length`` this rank holds."""
    n = length // plan.model.size
    return plan.model.index * n, (plan.model.index + 1) * n


def _cache_kv(lp, x, plan, positions, max_len: int, mode: str):
    """The prompt's keys and values for this rank's cache (from the normed
    ``x``, as ``models.prefill`` re-projects them), padded to its length:
    its own kv heads ("heads"), or every kv head of its block of positions
    ("seq") or of all of them ("whole")."""
    dt = torch_dtype(plan.cfg.dtype)
    s = x.shape[1]
    if mode == "heads":
        a, b, length = 0, s, max_len
    else:
        a, b = _span(plan, max_len) if mode == "seq" else (0, max_len)
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
            mode: str) -> tuple[torch.Tensor, dict]:
    """This rank's prompt rows ``tokens`` through its weight blocks:
    (last-position logits, placed as the module says; this rank's cache
    placed by ``mode``)."""
    cfg = plan.cfg
    h = tp_model.embed(params, plan, tokens)
    s = h.shape[1]
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds cache capacity {max_len}")
    positions = _positions(s, h.device)
    ks, vs = [], []
    layers = params["layers"]
    for i in range(_n_layers(layers)):
        lp = _layer(layers, i)
        k, v = _cache_kv(lp["attn"], rms_norm(h, lp["attn_norm"], cfg.rms_eps), plan,
                         positions, max_len, mode)
        h, _aux = tp_model.layer(lp, h, plan, positions)
        ks.append(k)
        vs.append(v)
    cache = {"pos": torch.tensor(s, dtype=torch.int32, device=h.device),
             "k": torch.stack(ks), "v": torch.stack(vs)}
    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
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


def _attn_decode(lp, x, ck, cv, pos, plan, mode: str):
    """One layer's decode attention of the normed, replicated ``x`` with
    this rank's cache blocks: (output, replicated; new cache blocks)."""
    cfg, g = plan.cfg, plan.model
    if mode == "heads":
        y, ck, cv = attention_decode(lp, x, ck, cv, pos, plan.local)
        return reduce_from_model(y, g), ck, cv
    if plan.attn == "whole":
        if mode == "seq":
            raise ValueError(f"{cfg.name}: a split-K cache needs attention split over 'model'")
        return attention_decode(lp, x, ck, cv, pos, cfg)
    # "whole" or "seq": this rank's cache holds every kv head, so every kv
    # head's new keys are written
    start = _span(plan, ck.shape[1] * g.size)[0] if mode == "seq" else 0
    if plan.attn == "contraction":  # q holds every query head
        positions = pos.to(torch.int32).expand(x.shape[0], 1)
        q, k, v = tp_model.contracted_qkv(lp, x, plan, positions)
        ck, cv = write_kv(ck, cv, k, v, pos, start)
        out = (_attend_split(q, ck, cv, pos, start, g) if mode == "seq"
               else decode_attend(q, ck, cv, pos))
        return tp_model.contracted_out(lp, out, plan), ck, cv
    # a head split: q holds this rank's query heads
    q, ck, cv = decode_write(lp, x, ck, cv, pos, cfg, start)
    if mode == "seq":
        hpl = q.shape[2]
        out = _attend_split(gather_from_model(q, g, 2), ck, cv, pos, start, g)
        out = out[:, :, g.index * hpl: (g.index + 1) * hpl]
    else:
        out = decode_attend(q, tp_model.take_heads(ck, plan.kv_index, 2),
                            tp_model.take_heads(cv, plan.kv_index, 2), pos)
    y = torch.einsum("bshk,hkd->bsd", out, lp["wo"].to(x.dtype))
    return reduce_from_model(y, g), ck, cv


def decode_step(params: dict, plan: tp_model.Plan, cache: dict, tokens: torch.Tensor,
                mode: str) -> tuple[torch.Tensor, dict]:
    """One decode step of this rank's requests ``tokens`` (B, 1) with its
    cache blocks: (logits, placed as the module says; the new cache
    blocks).  The cache passed in is not modified."""
    cfg = plan.cfg
    eps = cfg.rms_eps
    h = tp_model.embed(params, plan, tokens)
    pos = cache["pos"]
    nks, nvs = [], []
    layers = params["layers"]
    for i in range(_n_layers(layers)):
        lp = _layer(layers, i)
        y, nk, nv = _attn_decode(lp["attn"], rms_norm(h, lp["attn_norm"], eps), cache["k"][i],
                                 cache["v"][i], pos, plan, mode)
        h = h + y
        x = rms_norm(h, lp["mlp_norm"], eps)
        if cfg.family == "moe":
            m, _ = tp_model.moe_block(lp["moe"], x, plan, dropless=True)
        else:
            m = tp_model.mlp_block(lp["mlp"], x, plan)
        h = h + m
        nks.append(nk)
        nvs.append(nv)
    new = {**cache, "k": torch.stack(nks), "v": torch.stack(nvs), "pos": pos + 1}
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
def generate(params: dict, cfg, mesh, prompts: torch.Tensor, max_new_tokens: int) -> GenerateResult:
    """Greedy generation over ``mesh``: ``params`` are this rank's blocks
    (:func:`shard_params`), ``prompts`` the whole (B, S) batch on every
    rank.  Returns this rank's requests' tokens and log-probabilities, as
    ``serve.loop.generate`` at temperature 0."""
    plan = tp_model.make_plan(cfg, mesh, "serve")
    max_len = prompts.shape[1] + max_new_tokens
    mode = kv_mode(cfg, mesh, prompts.shape[0], max_len)
    prompts = shard_batch(cfg, mesh, {"tokens": prompts})["tokens"]
    out_toks, out_lp = [], []
    with _obs_hooks.muted():
        logits, cache = prefill(params, plan, prompts, max_len, mode)
        for _ in range(max_new_tokens):
            tok, lp = _greedy(logits, plan)
            out_toks.append(tok[:, 0])
            out_lp.append(lp)
            logits, cache = decode_step(params, plan, cache, tok.to(torch.int32), mode)
    return GenerateResult(tokens=torch.stack(out_toks, dim=1),
                          logprobs=torch.stack(out_lp, dim=1))
