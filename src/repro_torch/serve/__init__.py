# Serving (counterpart of repro.serve): the prefill / decode loop and the
# int8 KV-cache quantizer.
from .kv_quant import cache_bytes, dequantize_cache, quantize_cache
from .loop import GenerateResult, generate, make_decode_fn, make_prefill_fn

__all__ = [
    "generate",
    "make_prefill_fn",
    "make_decode_fn",
    "GenerateResult",
    "quantize_cache",
    "dequantize_cache",
    "cache_bytes",
]
