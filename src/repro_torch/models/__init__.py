"""Model zoo, dense family: shared blocks, attention, MLP, forward,
prefill and decode, plus the graph slice's reference chains
(``chains``) and dense-layer oracle.  The MoE, SSM/hybrid and
encdec/vlm families arrive with their slices."""
from . import attention, chains, common, decode, mlp, transformer
from .decode import decode_step, init_cache, prefill
from .transformer import compute_params, forward, init_params

__all__ = ["attention", "chains", "common", "decode", "mlp", "transformer",
           "decode_step", "init_cache", "prefill", "compute_params",
           "forward", "init_params"]
