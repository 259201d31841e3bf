"""Model zoo, every family (dense, moe, ssm, hybrid, encdec, vlm):
shared blocks, attention and cross-attention, the MLP and the MoE, the
Mamba-2 block, forward, prefill and decode, plus the graph slice's
reference chains (``chains``) and dense-layer oracle."""
from . import attention, chains, common, decode, mlp, ssm, transformer
from .decode import decode_step, init_cache, prefill
from .transformer import compute_params, encode, forward, init_params

__all__ = ["attention", "chains", "common", "decode", "mlp", "ssm",
           "transformer", "decode_step", "init_cache", "prefill",
           "compute_params", "encode", "forward", "init_params"]
