# Optimizers (counterpart of repro.optim): AdamW and the compressed,
# popcount-ordered gradient all-reduce.
from .adamw import AdamWConfig, OptState, global_norm, init, lr_schedule, update
from .compress import CompressionConfig, compressed_psum, init_error_buffer

__all__ = [
    "AdamWConfig",
    "OptState",
    "init",
    "update",
    "lr_schedule",
    "global_norm",
    "CompressionConfig",
    "compressed_psum",
    "init_error_buffer",
]
