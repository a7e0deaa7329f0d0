"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) vocab=151936,
MoE 128 experts top-8, expert d_ff=768, qk_norm, head_dim=128
[hf:Qwen/Qwen3-30B-A3B].

Experts shard 128/16 = 8 per device on the "model" mesh axis (EP).
"""

from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab=151936,
    act="swiglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    logits_chunk=512,
    fsdp=True,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768, capacity_factor=1.5,
                  group_size=256),
).validate()

SMOKE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=64, vocab=256, logits_chunk=0,
             moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64,
                           capacity_factor=2.0, group_size=32))
