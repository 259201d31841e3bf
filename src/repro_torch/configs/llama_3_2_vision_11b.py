"""llama-3.2-vision-11b [vlm] — 40L cross-attn image layers.

[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
Backbone only; the vision frontend is a stub: input_specs() provides 1601
precomputed patch embeddings of width d_model.  Pure full attention ->
long_500k skipped (DESIGN.md §Arch-applicability).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256, head_dim=128,
    cross_attn_every=5,           # 8 cross-attention layers among 40
    frontend_tokens=1601,         # stubbed image patch embeddings
    tie_embeddings=False,
)
