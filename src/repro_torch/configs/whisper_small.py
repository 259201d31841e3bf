"""whisper-small [audio] — enc-dec, conv frontend (stub).

[arXiv:2212.04356; unverified]
12 encoder + 12 decoder layers; the conv frontend is a stub: input_specs()
provides 1500 precomputed frame embeddings.  Decode shapes run mechanically
with a 32k self-KV cache (beyond Whisper's trained 448 ctx — noted; the
shapes are the assignment).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec",
    n_layers=12, n_enc_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865, head_dim=64,
    frontend_tokens=1500,
    rope_theta=10_000.0,
)
