"""grok-1-314b [moe] — 8 experts top-2.  [hf:xai-org/grok-1; unverified]

Full attention -> long_500k skipped.  Fitting 314B on v5e-512 needs the
8-bit optimizer-state option (EXPERIMENTS.md §Dry-run).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab=131072, head_dim=128,
    n_experts=8, top_k=2,
    tie_embeddings=False,
)
