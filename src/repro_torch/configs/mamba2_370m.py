"""mamba2-370m [ssm]: 48L d_model=1024 (attn-free) vocab=50280, ssm_state=128.

SSD (state-space duality) [arXiv:2405.21060].  d_inner = 2*1024 = 2048,
SSM head_dim 64 -> 32 SSM heads.  The attention fields are unused
(family="ssm" has no attention blocks) but kept valid for the config schema.
"""

from ..models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1, d_conv=4, chunk=256),
    tie_embeddings=True,  # mamba2 ties in/out embeddings
).validate()

SMOKE = dict(
    n_layers=4, d_model=64, vocab=128,
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, n_groups=1, d_conv=4, chunk=16),
)
