"""qwen3-4b [dense]: 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936.

qk_norm per-head RMSNorm on q/k before RoPE; head_dim=128 (qwen3 family)
[hf:Qwen/Qwen3-8B assignment source].
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab=151936,
    act="swiglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    logits_chunk=512,
).validate()

SMOKE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=128, vocab=256, logits_chunk=0)
