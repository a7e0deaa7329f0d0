"""gemma-7b [dense]: 28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000.

GeGLU activation, head_dim=256 (> d_model / n_heads) [arXiv:2403.08295; hf].
The 256k vocab makes the unembedding the memory hot-spot: logits are
sequence-chunked (cfg.logits_chunk).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab=256000,
    act="geglu",
    rope_theta=10000.0,
    tie_embeddings=True,  # gemma ties embeddings
    logits_chunk=512,
).validate()

SMOKE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32,
             d_ff=128, vocab=256, logits_chunk=0)
