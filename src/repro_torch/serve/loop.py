"""Serving loop: batched prefill + greedy/sampled decode with KV caches.

Counterpart of ``repro.serve.loop``.  The reference jits its prefill and
decode functions; here they run eagerly, inside ``_obs_hooks.muted()`` so
that a traffic tap inside the model (``moe.dispatch``) records nothing, as
the reference's tracer-dropping tap does under jit.  The loop's own taps
fire outside: ``serve.weights`` once before the decode loop (the decode
weight stream, multicast once per step) and ``serve.kv`` after every
decode step (that step's new KV / SSM-state bytes).

Before serving, ``repro_torch.traffic.apply_weight_ordering`` may permute
contraction axes so the decode weight stream has popcount-monotone rows
(a numeric no-op up to summation order).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from .. import _obs_hooks
from ..models import decode_step, prefill
from ..models.config import ModelConfig

Params = Any


def make_prefill_fn(cfg: ModelConfig, max_len: int):
    @torch.no_grad()
    def fn(params, tokens, frames=None, inputs_embeds=None):
        kw = {}
        if frames is not None:
            kw["frames"] = frames
        if inputs_embeds is not None:
            kw["inputs_embeds"] = inputs_embeds
        with _obs_hooks.muted():
            return prefill(params, cfg, tokens, max_len, **kw)

    return fn


def make_decode_fn(cfg: ModelConfig):
    @torch.no_grad()
    def fn(params, cache, tokens):
        with _obs_hooks.muted():
            return decode_step(params, cfg, cache, tokens)

    return fn


@dataclasses.dataclass
class GenerateResult:
    tokens: torch.Tensor  # (B, generated) int64
    logprobs: torch.Tensor  # (B, generated) float32


@torch.no_grad()
def generate(
    params: Params,
    cfg: ModelConfig,
    prompts: torch.Tensor,  # (B, S) integer token ids
    max_new_tokens: int,
    frames: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    temperature: float = 0.0,
    seed: int = 0,
    generator: Optional[torch.Generator] = None,
) -> GenerateResult:
    """Prefill the prompts, then decode ``max_new_tokens`` tokens: greedy
    (argmax) at ``temperature == 0``, else sampled from
    softmax(logits / temperature) with ``generator`` (default: a generator
    on the logits' device seeded with ``seed``).  Runs on the prompts'
    device."""
    b, s = prompts.shape
    extra = inputs_embeds.shape[1] if inputs_embeds is not None else 0
    max_len = s + extra + max_new_tokens
    prefill_fn = make_prefill_fn(cfg, max_len)
    decode_fn = make_decode_fn(cfg)
    logits, cache = prefill_fn(params, prompts, frames=frames, inputs_embeds=inputs_embeds)
    # traffic tap: the decode weight stream is multicast once per step —
    # one firing represents it
    _obs_hooks.tap("serve.weights", params=params)
    if temperature > 0 and generator is None:
        generator = torch.Generator(device=logits.device).manual_seed(seed)
    out_toks, out_lp = [], []
    for i in range(max_new_tokens):
        lf = logits[:, -1].to(torch.float32)
        if temperature > 0:
            probs = torch.softmax(lf / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)
        else:
            tok = torch.argmax(lf, dim=-1)[:, None]
        lp = torch.log_softmax(lf, dim=-1)
        out_lp.append(torch.take_along_dim(lp, tok, dim=-1)[:, 0])
        out_toks.append(tok[:, 0])
        logits, cache = decode_fn(params, cache, tok.to(torch.int32))
        # the new KV / SSM-state bytes of this step: the per-token traffic
        _obs_hooks.tap("serve.kv", cache=cache, step=i)
    return GenerateResult(tokens=torch.stack(out_toks, dim=1),
                          logprobs=torch.stack(out_lp, dim=1))
