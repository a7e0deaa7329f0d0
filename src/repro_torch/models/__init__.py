# The model zoo (counterpart of repro.models): every family's forward,
# prefill and decode, with the reference's parameter trees, differentiable
# for training (repro_torch.train), and the in-repo LeNet (models/lenet.py).
from .config import ModelConfig, MoEConfig, SSMConfig
from .transformer import (
    decode_step,
    encdec_forward,
    forward,
    init_cache,
    init_params,
    lm_loss,
    param_shapes,
    prefill,
    unembed,
)

__all__ = [
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "init_params",
    "param_shapes",
    "forward",
    "encdec_forward",
    "lm_loss",
    "unembed",
    "prefill",
    "decode_step",
    "init_cache",
]
