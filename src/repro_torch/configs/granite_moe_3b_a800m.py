"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) vocab=49155,
MoE 40 experts top-8, expert d_ff=512 [ibm-granite assignment spec].

NOTE: the assignment line reads "MoE 40e top-8" while its trailing note says
"32 experts" (hf granite-3.0-1b-a400m has 32); we follow the primary spec:
40 experts.  40 does not divide the 16-wide "model" axis, so experts are
PADDED to 48 (pad_experts_to) and the router masks the 8 padded experts to
-inf — shardable without changing routing semantics (DESIGN.md §5).
"""

from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    act="swiglu",
    moe=MoEConfig(num_experts=40, top_k=8, d_ff_expert=512, capacity_factor=1.5,
                  group_size=256, pad_experts_to=48),
).validate()

SMOKE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64, vocab=256,
             moe=MoEConfig(num_experts=5, top_k=2, d_ff_expert=64,
                           capacity_factor=2.0, group_size=32, pad_experts_to=8))
