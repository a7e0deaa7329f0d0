# The model zoo (counterpart of repro.models).  Only the configuration
# dataclasses are ported so far; layers, transformer, moe, ssd and lenet
# are a later slice.
from .config import ModelConfig, MoEConfig, SSMConfig

__all__ = ["ModelConfig", "MoEConfig", "SSMConfig"]
