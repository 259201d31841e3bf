"""mixtral-8x22b [moe] — 8 experts top-2, SWA.  [arXiv:2401.04088; hf]

SWA (per the assignment) -> sub-quadratic -> long_500k runs.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=32768, head_dim=128,
    n_experts=8, top_k=2,
    swa_window=4096,
    tie_embeddings=False,
)
