"""mamba2-370m [ssm] — SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified]
48L d_model=1024, ssm_state=128; d_inner = 2*1024 = 2048, 32 SSD heads of
dim 64.  Attention-free -> the paper's attention-sharding STTs are
inapplicable (DESIGN.md §Arch-applicability); STT schedules the SSD chunk
matmuls and projections instead.  long_500k runs (O(1) state decode).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=16, n_kv_heads=16,  # attn dims unused
    d_ff=0, vocab=50280, head_dim=64,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
)
