"""whisper-medium [audio]: enc-dec, 24L enc + 24L dec, d_model=1024 16H
d_ff=4096 vocab=51865 [arXiv:2212.04356].

The conv frontend is a STUB per the assignment: input_specs() provides
precomputed frame embeddings (B, 1500, d).  Adaptation notes (DESIGN.md §8):
RoPE replaces whisper's learned/sinusoidal positions; the assigned shapes'
seq_len applies to the DECODER sequence, encoder frames fixed at 1500.
"""

from ..models.config import ModelConfig

ENC_FRAMES = 1500  # 30 s of audio at 50 Hz after the (stubbed) conv stem

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    act="gelu",
).validate()

SMOKE = dict(n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
             d_ff=128, vocab=256)
