"""Model configuration for the architecture zoo.

A copy of ``repro.models.config``, whose package loads JAX; pure
dataclasses, held equal to the reference by ``tests/test_torch_configs.py``.

One ``ModelConfig`` covers every assigned family: dense GQA transformers,
MoE, Mamba2/SSD, hybrid (SSM + shared attention), encoder-decoder (whisper)
and VLM backbones (frontends are stubs per the assignment: ``input_specs``
feeds precomputed frame/patch embeddings).
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional

Act = Literal["swiglu", "geglu", "gelu"]
BlockKind = Literal["attn", "ssm"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    capacity_factor: float = 1.5
    group_size: int = 512  # tokens per dispatch group (bounds dispatch memory)
    router_aux_weight: float = 0.01
    # experts are sharded over the "model" axis; pad to a multiple of it
    pad_experts_to: int | None = None

    @property
    def padded_experts(self) -> int:
        return self.pad_experts_to or self.num_experts


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 256  # SSD chunk length (matmul-friendly scan)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads (gemma: 256)
    act: Act = "swiglu"
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    # block pattern: None = all-attention; "ssm" = all-SSM (mamba2);
    # "hybrid" = SSM stack with a SHARED attention block every
    # ``shared_attn_every`` layers (zamba2)
    family: Literal["dense", "ssm", "hybrid", "encdec", "moe", "vlm", "audio"] = (
        "dense"
    )
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    shared_attn_every: int = 6  # hybrid only
    # encoder-decoder (whisper): encoder layer count; frontend supplies
    # precomputed frame embeddings (conv stem is a stub per the assignment)
    n_enc_layers: int = 0
    # vlm: leading positions of the sequence are precomputed patch embeddings
    n_frontend_tokens: int = 0
    # numerics / performance knobs (see EXPERIMENTS.md §Perf)
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"
    attn_impl: Literal["dense", "chunked", "chunked_skip"] = "chunked_skip"
    attn_chunk: int = 1024
    remat: bool = True
    # "full": recompute everything in backward (min memory, re-runs the TP
    # collectives).  "save_block_io": save the all-reduced attn/mlp outputs
    # so backward recompute skips the forward collectives (§Perf lever —
    # trades ~2 x (B,S,d) bytes/layer for ~1/3 of the all-reduce wire)
    remat_policy: Literal["full", "save_block_io"] = "full"
    logits_chunk: int = 0  # 0 = unchunked; >0 = sequence-chunked loss
    scan_layers: bool = True
    # FSDP (ZeRO-3-style): additionally shard params/optimizer over the
    # "data" axis for training — required for archs whose fp32 params +
    # Adam state exceed HBM under TP-only sharding (qwen3-moe, internvl2)
    fsdp: bool = False
    # pure data parallelism: replicate ALL params and shard the batch over
    # every mesh axis (incl. "model").  The right regime for small models
    # whose TP collectives dominate (mamba2-370m: §Perf iteration A1)
    pure_dp: bool = False
    # ZeRO-1: shard Adam m/v over the "data" axis (params keep their TP
    # sharding; GSPMD inserts the post-update weight all-gather).  Frees
    # 8 bytes/param of replicated state at low-TP mesh ratios (§Perf C6)
    zero1: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def q_rep(self) -> int:
        if self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"{self.name}: n_heads {self.n_heads} not divisible by "
                f"n_kv_heads {self.n_kv_heads}"
            )
        return self.n_heads // self.n_kv_heads

    def validate(self) -> "ModelConfig":
        if self.family in ("moe",) and self.moe is None:
            raise ValueError(f"{self.name}: family=moe requires moe config")
        if self.family in ("ssm", "hybrid") and self.ssm is None:
            raise ValueError(f"{self.name}: family={self.family} requires ssm config")
        if self.family == "encdec" and self.n_enc_layers <= 0:
            raise ValueError(f"{self.name}: encdec requires n_enc_layers")
        _ = self.q_rep
        return self

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for 6·N·D."""
        d, v = self.d_model, self.vocab
        hd = self.resolved_head_dim
        total = v * d * (1 if self.tie_embeddings else 2)
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d

        def mlp(ff: int) -> int:
            gates = 2 if self.act in ("swiglu", "geglu") else 1
            return d * ff * gates + ff * d

        if self.family in ("dense", "vlm"):
            total += self.n_layers * (attn + mlp(self.d_ff) + 2 * d)
        elif self.family == "moe":
            m = self.moe
            expert = d * m.d_ff_expert * 3  # gate/up/down
            total += self.n_layers * (
                attn + m.num_experts * expert + d * m.num_experts + 2 * d
            )
        elif self.family == "ssm":
            total += self.n_layers * self._ssm_block_params()
        elif self.family == "hybrid":
            n_shared = 1
            total += self.n_layers * self._ssm_block_params()
            total += n_shared * (attn + mlp(self.d_ff) + 2 * d)
        elif self.family in ("encdec", "audio"):
            total += (self.n_layers + self.n_enc_layers) * (
                attn + mlp(self.d_ff) + 2 * d
            )
            total += self.n_layers * attn  # decoder cross-attention
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of num_experts)."""
        if self.family != "moe":
            return self.param_count()
        m = self.moe
        d = self.d_model
        expert = d * m.d_ff_expert * 3
        total = self.param_count()
        total -= self.n_layers * m.num_experts * expert
        total += self.n_layers * (m.top_k + m.num_shared_experts) * expert
        return total

    def _ssm_block_params(self) -> int:
        s = self.ssm
        d = self.d_model
        d_inner = s.expand * d
        n_heads = d_inner // s.head_dim
        in_proj = d * (2 * d_inner + 2 * s.n_groups * s.d_state + n_heads)
        conv = s.d_conv * (d_inner + 2 * s.n_groups * s.d_state)
        out = d_inner * d
        return in_proj + conv + out + 2 * d_inner + 2 * n_heads + d
