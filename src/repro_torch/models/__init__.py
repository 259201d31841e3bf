"""Model zoo, dense, ssm and hybrid families: shared blocks, attention,
MLP, the Mamba-2 block, forward, prefill and decode, plus the graph
slice's reference chains (``chains``) and dense-layer oracle.  The MoE
and encdec/vlm families arrive with their slices."""
from . import attention, chains, common, decode, mlp, ssm, transformer
from .decode import decode_step, init_cache, prefill
from .transformer import compute_params, forward, init_params

__all__ = ["attention", "chains", "common", "decode", "mlp", "ssm",
           "transformer", "decode_step", "init_cache", "prefill",
           "compute_params", "forward", "init_params"]
