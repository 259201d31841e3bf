"""h2o-danube-1.8b [dense] — llama+mistral mix, SWA.  [arXiv:2401.16818; hf]

Sliding-window attention (4096) -> sub-quadratic -> long_500k runs.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab=32000, head_dim=80,
    swa_window=4096,
)
