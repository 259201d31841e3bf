"""Prefill and single-token decode: the dense, SSM and hybrid families.

The port of the reference's ``models/decode.py`` for those families.
The decode cache layout:

    {"pos":    int, or a (B,) int tensor — absolute position of the NEXT
               token (a (B,) tensor gives every sequence its own position,
               which is what lets the serving slot engine mix sequences
               of different lengths in one decode batch),
     "self":   {"k", "v"} (L, B, S_c, kv_dim) in the compute dtype  dense
     "ssm":    {"conv" (L, B, k-1, conv_dim), "state" (L, B, H, N, P)},
               fp32 whatever the compute dtype             ssm / hybrid
     "shared": {"k", "v"} (n_groups, B, S_c, kv_dim)       hybrid}

SWA archs use rolling caches of ``window`` slots; prefill fills them with
the last ``window`` positions.  ``decode_step`` writes each attention
layer's new K/V row into the cache tensors in place and returns a cache
dict that holds the same K/V tensors with ``pos`` advanced (the
reference returns new arrays); the SSM conv windows and states come back
as new tensors, the given ones untouched.  The other families raise
``NotImplementedError`` naming their slice.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..compile.pipeline import torch_dtype
from ..configs.base import ModelConfig
from . import attention as attn
from . import mlp as mlp_mod
from . import ssm as ssm_mod
from .common import rmsnorm
from .transformer import (_shared_block, _ssm_block, _stack, forward_hidden,
                          hybrid_groups, layer_params, logits_from_hidden,
                          require_family, shared_after)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def cache_len(cfg: ModelConfig, max_len: int) -> int:
    """Slots of the decode cache for a context budget of ``max_len``:
    ``min(max_len, window)`` for SWA archs, ``max_len`` otherwise."""
    return max_len if cfg.swa_window is None else min(max_len,
                                                      cfg.swa_window)


def _fit_cache(kv: Dict[str, torch.Tensor], window: Optional[int],
               max_len: int, s0: int) -> Dict[str, torch.Tensor]:
    """Resize collected (.., S0, kv_dim) K/V to the decode cache layout.

    Rolling caches (SWA) keep ``min(max_len, window)`` slots with slot
    ``i == abs_pos % s_cache`` (a roll re-aligns when s_cache does not
    divide S0); linear caches pad to ``max_len`` slots."""
    s_cache = max_len if window is None else min(max_len, window)

    def fit(a):
        if s0 >= s_cache:
            a = a[:, :, s0 - s_cache:]
            shift = s0 % s_cache
            if shift:
                return torch.roll(a, shift, dims=2)
            return a.contiguous()
        return F.pad(a, (0, 0, 0, s_cache - s0))

    return {k: fit(v) for k, v in kv.items()}


def prefill(params: Dict[str, Any], tokens: torch.Tensor, cfg: ModelConfig,
            *, frontend: Optional[torch.Tensor] = None,
            max_len: Optional[int] = None,
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the full prompt, return (last-position logits (B, V), decode
    cache).

    ``max_len`` is the total context budget (prompt + generated); the cache
    allocates min(max_len, swa_window) slots.  Only the last position is
    projected to logits (the reference projects every position and keeps
    the last; the row is the same)."""
    if frontend is not None:
        raise NotImplementedError("frontend inputs arrive with the "
                                  "encdec/vlm slice")
    b, s = tokens.shape
    max_len = max_len or s
    x, _, caches = forward_hidden(params, tokens, cfg, collect_cache=True)
    logits = logits_from_hidden(params, x[:, -1], cfg)
    cache: Dict[str, Any] = {"pos": s}
    if "self" in caches:
        cache["self"] = _fit_cache(caches["self"], cfg.swa_window, max_len, s)
    if "ssm" in caches:
        cache["ssm"] = caches["ssm"]
    if "shared" in caches:
        cache["shared"] = _fit_cache(caches["shared"], cfg.swa_window,
                                     max_len, s)
    return logits, cache


def init_cache(params: Dict[str, Any], cfg: ModelConfig, batch: int,
               seq_len: int, *, frontend: Optional[torch.Tensor] = None,
               dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Empty decode cache for a maximum context of ``seq_len``, on
    ``device`` (default: the parameters' device).  K/V leaves take
    ``dtype``; the SSM leaves are fp32 whatever ``dtype`` says, as in the
    reference.  A ``"meta"`` device gives the leaf shapes and dtypes
    without memory."""
    require_family(cfg)
    if frontend is not None:
        raise NotImplementedError("frontend inputs arrive with the "
                                  "encdec/vlm slice")
    device = params["embed"].device if device is None else device
    s_c = cache_len(cfg, seq_len)

    def kv(n):
        shape = (n, batch, s_c, cfg.kv_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    cache: Dict[str, Any] = {"pos": 0}
    if cfg.family == "dense":
        cache["self"] = kv(cfg.n_layers)
        return cache
    one = ssm_mod.make_ssm_cache(cfg, batch, device=device)
    cache["ssm"] = {k: v[None].expand(cfg.n_layers, *v.shape).contiguous()
                    for k, v in one.items()}
    if cfg.family == "hybrid":
        cache["shared"] = kv(hybrid_groups(cfg)[0])
    return cache


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------

def decode_step(params: Dict[str, Any], tokens: torch.Tensor,
                cache: Dict[str, Any], cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens: (B, 1) int — one new token per sequence.

    ``cache["pos"]`` may be an int (all sequences at the same position,
    the classic batched decode) or a ``(B,)`` tensor (per-sequence
    positions, continuous batching); rope, validity masks and cache writes
    vectorize accordingly and each row computes exactly what it would with
    that row's scalar position.

    Returns (logits (B, vocab) fp32, cache with pos + 1; its K/V tensors
    are the given ones, updated in place; its SSM leaves are new
    tensors)."""
    require_family(cfg)
    compute = torch_dtype(cfg.dtype)
    pos = cache["pos"]
    x = params["embed"][tokens].to(compute)
    new_cache: Dict[str, Any] = {"pos": pos + 1}
    if cfg.family == "dense":
        ck, cv = cache["self"]["k"], cache["self"]["v"]
        for i in range(ck.shape[0]):
            pl_ = layer_params(params["layers"], i)
            h, _ = attn.apply_attention(
                pl_["attn"], rmsnorm(x, pl_["ln1"], cfg.norm_eps), cfg,
                cache={"k": ck[i], "v": cv[i]}, pos=pos)
            x = x + h
            h = mlp_mod.apply_mlp(pl_["ffn"], rmsnorm(x, pl_["ln2"],
                                                      cfg.norm_eps), cfg)
            x = x + h
        new_cache["self"] = {"k": ck, "v": cv}
    else:
        conv, state = cache["ssm"]["conv"], cache["ssm"]["state"]
        lanes = []
        for i in range(conv.shape[0]):
            x, c = _ssm_block(layer_params(params["layers"], i), x, cfg,
                              cache={"conv": conv[i], "state": state[i]})
            lanes.append(c)
            gi = shared_after(cfg, i)
            if gi is not None:
                x, _ = _shared_block(
                    params["shared"], x, cfg, pos=pos,
                    cache={"k": cache["shared"]["k"][gi],
                           "v": cache["shared"]["v"][gi]})
        new_cache["ssm"] = _stack(lanes)
        if cfg.family == "hybrid":
            new_cache["shared"] = cache["shared"]
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_from_hidden(params, x, cfg)
    return logits[:, 0], new_cache
