"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242; hf]
38 Mamba2 layers (ssm_state=64) with ONE shared attention+MLP block applied
every 6 layers (parameter sharing a la Zamba).  long_500k runs.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000, head_dim=64,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
    attn_every=6,
)
