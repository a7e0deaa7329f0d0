"""codeqwen1.5-7b [dense]: 32L d_model=4096 32H (kv=32) d_ff=13440
vocab=92416 [hf:Qwen/CodeQwen1.5-7B].  qwen1.5 architecture (MHA at kv=32),
SwiGLU, long-context rope theta 1e6.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab=92416,
    act="swiglu",
    rope_theta=1_000_000.0,
).validate()

SMOKE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256)
