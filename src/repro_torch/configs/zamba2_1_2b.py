"""zamba2-1.2b [hybrid]: 38L d_model=2048, Mamba2 backbone + SHARED attention
block (32H kv=32, head_dim=64, d_ff=8192 MLP), vocab=32000, ssm_state=64
[arXiv:2411.15242].

Structure (DESIGN.md §4): 6 groups of 6 SSM layers, each followed by ONE
shared attention+MLP block (same weights every invocation), plus 2 trailing
SSM layers = 38 SSM layers total.  Zamba2 alternates two shared blocks; we
model one (noted fidelity delta, DESIGN.md §8).
"""

from ..models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=32000,
    act="swiglu",
    shared_attn_every=6,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, n_groups=1, d_conv=4, chunk=256),
).validate()

SMOKE = dict(
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    vocab=256, shared_attn_every=2,
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, n_groups=1, d_conv=4, chunk=16),
)
