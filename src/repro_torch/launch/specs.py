"""Dry-run case construction: abstract inputs (``meta`` tensors, no
allocation) + shardings + the function to run, per (arch x shape).

Counterpart of ``repro.launch.specs``.  ``train`` runs the full train step
(forward + backward + AdamW update, ``repro_torch.train``); ``prefill``
processes the prompt returning (logits, cache); ``decode`` runs one
``decode_step`` against a seq_len KV/SSM cache.  Every argument is a
``meta`` tensor, so the functions run on them with no memory behind them:
``dryrun.py`` counts their operations under ``FlopCounterMode``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..configs import get_config
from ..configs.shapes import SHAPES, ShapeSpec
from ..models import decode_step, init_cache, param_shapes, prefill
from ..models.config import ModelConfig
from ..models.layers import torch_dtype
from ..optim import AdamWConfig
from ..optim import init as opt_init
from ..train import make_train_step
from .mesh import dp_axes, mesh_axes
from .sharding import (
    P,
    NamedSharding,
    batch_shardings,
    cache_shardings,
    opt_shardings,
    params_shardings,
    replicated,
)

__all__ = ["DryrunCase", "build_case", "ENC_FRAMES", "TRAIN_MICROBATCHES",
           "DEFAULT_TRAIN_MICROBATCHES", "OPTIMIZED_PROFILES"]

ENC_FRAMES = 1500  # whisper stub frontend length (DESIGN.md §4)

# Gradient-accumulation microbatches per train cell, as the reference sets
# them for its production lowering (§Dry-run).
TRAIN_MICROBATCHES = {
    "gemma-7b": 4,
    "codeqwen1.5-7b": 4,
    "internvl2-26b": 8,
    "qwen3-moe-30b-a3b": 4,
}
DEFAULT_TRAIN_MICROBATCHES = 2

# The reference's optimized per-cell profiles (EXPERIMENTS.md §Perf):
# (cfg_overrides, mesh_shape | None, microbatches | None).
_SCAN_ATTN = {"attn_impl": "chunked", "attn_chunk": 4096}
OPTIMIZED_PROFILES: dict[tuple[str, str], tuple[dict, tuple | None, int | None]] = {
    ("mamba2-370m", "train_4k"): ({"pure_dp": True}, None, None),  # A3 base
    ("codeqwen1.5-7b", "prefill_32k"): (dict(_SCAN_ATTN), (32, 8), None),  # B5
    ("internlm2-1.8b", "train_4k"): (
        {"remat_policy": "save_block_io", "zero1": True}, (128, 2), None),  # C6
    ("granite-moe-3b-a800m", "train_4k"): ({"zero1": True}, (32, 8), 4),
    ("granite-moe-3b-a800m", "prefill_32k"): (dict(_SCAN_ATTN), (32, 8), None),
    ("internvl2-26b", "train_4k"): ({"fsdp": False, "zero1": True}, None, None),
    ("internvl2-26b", "prefill_32k"): (dict(_SCAN_ATTN), None, None),
    ("qwen3-moe-30b-a3b", "train_4k"): ({}, None, 8),
    ("qwen3-moe-30b-a3b", "prefill_32k"): (dict(_SCAN_ATTN), None, None),
    ("whisper-medium", "train_4k"): ({"logits_chunk": 512}, None, 4),
    ("qwen3-4b", "prefill_32k"): (dict(_SCAN_ATTN), None, None),
    ("zamba2-1.2b", "prefill_32k"): (dict(_SCAN_ATTN), None, None),
}

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=torch_dtype(dtype), device="meta")


@dataclasses.dataclass
class DryrunCase:
    arch: str
    shape: ShapeSpec
    cfg: ModelConfig
    kind: str
    fn: Callable
    args: tuple  # trees of meta tensors
    donate: tuple[int, ...]

    def shardings(self, mesh) -> tuple[Any, Any]:
        """(in_shardings, out_shardings) matching ``self.args`` / outputs."""
        cfg = self.cfg
        p_shapes = self.args[0]
        mode = "train" if self.kind == "train" else "serve"
        p_sh = params_shardings(cfg, mesh, p_shapes, mode=mode)
        if self.kind == "train":
            o_sh = opt_shardings(cfg, mesh, self.args[1], p_shapes)
            b_sh = batch_shardings(cfg, mesh, self.args[2])
            metrics_sh = {k: replicated(mesh) for k in ("loss", "grad_norm", "lr")}
            return (p_sh, o_sh, b_sh), (p_sh, o_sh, metrics_sh)
        if self.kind == "prefill":
            b_sh = batch_shardings(cfg, mesh, self.args[1])
            return (p_sh, b_sh), None  # cache / logits: not ruled (GSPMD's choice)
        # decode
        c_sh = cache_shardings(cfg, mesh, self.args[1])
        t_sh = batch_shardings(cfg, mesh, {"tokens": self.args[2]})["tokens"]
        dp = dp_axes(mesh)
        axes = mesh_axes(mesh)
        b, v = self.args[2].shape[0], cfg.vocab
        dpn = 1
        for a in dp:
            dpn *= axes[a]
        lspec = P(dp if b % dpn == 0 else None, None,
                  "model" if v % axes["model"] == 0 else None)
        return (p_sh, c_sh, t_sh), (NamedSharding(mesh, lspec), c_sh)


def build_case(arch: str, shape_name: str, **cfg_overrides) -> DryrunCase:
    cfg_overrides.setdefault("scan_layers", False)
    shape = SHAPES[shape_name]
    if shape.kind != "train":
        # serving stores weights in bf16; fp32 masters exist only in training
        cfg_overrides.setdefault("param_dtype", "bfloat16")
    cfg = get_config(arch, **cfg_overrides)
    p_shapes = param_shapes(cfg)
    s, gb = shape.seq_len, shape.global_batch
    fam = cfg.family

    if shape.kind == "train":
        opt_shapes = opt_init(p_shapes)
        batch: dict[str, torch.Tensor] = {}
        if fam in ("encdec", "audio"):
            batch["frames"] = _meta((gb, ENC_FRAMES, cfg.d_model), cfg.dtype)
            batch["tokens"] = _meta((gb, s), torch.int32)
            batch["labels"] = _meta((gb, s), torch.int32)
        elif fam == "vlm":
            nf = cfg.n_frontend_tokens
            batch["patches"] = _meta((gb, nf, cfg.d_model), cfg.dtype)
            batch["tokens"] = _meta((gb, s - nf), torch.int32)
            batch["labels"] = _meta((gb, s), torch.int32)
        else:
            batch["tokens"] = _meta((gb, s), torch.int32)
            batch["labels"] = _meta((gb, s), torch.int32)
        mb = TRAIN_MICROBATCHES.get(arch, DEFAULT_TRAIN_MICROBATCHES)
        step_fn = make_train_step(cfg, AdamWConfig(total_steps=10_000), microbatches=mb)
        return DryrunCase(arch, shape, cfg, "train", lambda p, o, b: step_fn(p, o, b),
                          (p_shapes, opt_shapes, batch), donate=(0, 1))

    if shape.kind == "prefill":
        batch = {}
        if fam in ("encdec", "audio"):
            batch["frames"] = _meta((gb, ENC_FRAMES, cfg.d_model), cfg.dtype)
            batch["tokens"] = _meta((gb, s), torch.int32)
            fn = lambda p, b: prefill(p, cfg, b["tokens"], s, frames=b["frames"])  # noqa: E731
        elif fam == "vlm":
            nf = cfg.n_frontend_tokens
            batch["patches"] = _meta((gb, nf, cfg.d_model), cfg.dtype)
            batch["tokens"] = _meta((gb, s - nf), torch.int32)
            fn = lambda p, b: prefill(p, cfg, b["tokens"], s,  # noqa: E731
                                      inputs_embeds=b["patches"])
        else:
            batch["tokens"] = _meta((gb, s), torch.int32)
            fn = lambda p, b: prefill(p, cfg, b["tokens"], s)  # noqa: E731
        return DryrunCase(arch, shape, cfg, "prefill", fn, (p_shapes, batch), donate=())

    # decode: one new token against a seq_len cache
    enc_len = ENC_FRAMES if fam in ("encdec", "audio") else 0
    cache_shapes = init_cache(cfg, gb, s, enc_len=enc_len, device="meta")
    tokens = _meta((gb, 1), torch.int32)
    fn = lambda p, c, t: decode_step(p, cfg, c, t)  # noqa: E731
    return DryrunCase(arch, shape, cfg, "decode", fn, (p_shapes, cache_shapes, tokens),
                      donate=(1,))
