"""internvl2-26b [vlm]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553 [arXiv:2404.16821] — InternLM2-20B language backbone.

The InternViT frontend is a STUB per the assignment: input_specs() provides
1024 precomputed patch embeddings (B, 1024, d) prepended to the text tokens;
seq_len counts patches + text.
"""

from ..models.config import ModelConfig

N_PATCHES = 1024

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92553,
    act="swiglu",
    rope_theta=1_000_000.0,
    n_frontend_tokens=N_PATCHES,
    logits_chunk=512,
    fsdp=True,
).validate()

SMOKE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab=256, n_frontend_tokens=8, logits_chunk=0)
