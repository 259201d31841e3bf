"""Prefill and single-token decode for every family.

The port of the reference's ``models/decode.py``.  The decode cache
layout:

    {"pos":    int, or a (B,) int tensor — absolute position of the NEXT
               token (a (B,) tensor gives every sequence its own position,
               which is what lets the serving slot engine mix sequences
               of different lengths in one decode batch),
     "self":   {"k", "v"} (L, B, S_c, kv_dim) in the compute dtype
                                             dense / moe / encdec / vlm
     "ssm":    {"conv" (L, B, k-1, conv_dim), "state" (L, B, H, N, P)},
               fp32 whatever the compute dtype             ssm / hybrid
     "shared": {"k", "v"} (n_groups, B, S_c, kv_dim)       hybrid
     "cross":  {"k", "v"} (L | n_cross, B, F, kv_dim) bf16, static
                                                           encdec / vlm}

SWA archs use rolling caches of ``window`` slots; prefill fills them with
the last ``window`` positions.  ``decode_step`` writes each attention
layer's new K/V row into the cache tensors in place and returns a cache
dict that holds the same K/V tensors with ``pos`` advanced (the
reference returns new arrays); the SSM conv windows and states come back
as new tensors, the given ones untouched; the static cross K/V come back
as they were given.  On a mesh (``launch.mesh.set_mesh``) prefill and
decode take global inputs and return global logits, and every cache
holds the rank's batch rows (``explicit_tp``'s rank model).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..compile.pipeline import torch_dtype
from ..configs.base import ModelConfig
from . import attention as attn
from . import explicit_tp as etp
from . import ssm as ssm_mod
from .common import rmsnorm
from .transformer import (_cross_block, _decoder_block, _dense_block,
                          _shared_block, _ssm_block, _stack, encode,
                          forward_hidden, hybrid_groups, layer_params,
                          logits_from_hidden, require_family, shared_after)


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


def _cross_cache(params: Dict[str, Any], cfg: ModelConfig, *,
                 enc: Optional[torch.Tensor] = None,
                 img: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """The static cross K/V, ``(n, B, F, kv_dim)`` bf16: one entry per
    decoder layer from the encoder output ``enc`` (encdec), one per cross
    layer from the image embeddings ``img`` (vlm)."""
    if cfg.family == "encdec":
        ps, src = params["layers"]["cross"], enc
    else:
        ps, src = params["cross_layers"]["attn"], img
    return _stack([attn.precompute_cross_cache(layer_params(ps, i), src, cfg)
                   for i in range(ps["wq"].shape[0])])


def prefill(params: Dict[str, Any], tokens: torch.Tensor, cfg: ModelConfig,
            *, frontend: Optional[torch.Tensor] = None,
            max_len: Optional[int] = None,
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the full prompt, return (last-position logits (B, V), decode
    cache).

    ``max_len`` is the total context budget (prompt + generated); the cache
    allocates min(max_len, swa_window) slots.  ``frontend`` is the encdec
    or vlm stub input (B, F, D).  Only the last position is projected to
    logits (the reference projects every position and keeps the last; the
    row is the same)."""
    b, s = tokens.shape
    max_len = max_len or s
    x, _, caches = forward_hidden(params, tokens, cfg, frontend=frontend,
                                  collect_cache=True)
    lay = etp.layout_for(b, s, cfg)
    logits = etp.gather_rows(logits_from_hidden(params, x[:, -1], cfg), lay)
    cache: Dict[str, Any] = {"pos": s}
    if "self" in caches:
        cache["self"] = _fit_cache(caches["self"], cfg.swa_window, max_len, s)
    if "ssm" in caches:
        cache["ssm"] = caches["ssm"]
    if "shared" in caches:
        cache["shared"] = _fit_cache(caches["shared"], cfg.swa_window,
                                     max_len, s)
    if cfg.family == "encdec":
        cache["cross"] = _cross_cache(params, cfg, enc=caches["enc_out"])
    if cfg.family == "vlm":
        cache["cross"] = _cross_cache(
            params, cfg, img=etp.local_rows(frontend, lay).to(
                torch_dtype(cfg.dtype)))
    return logits, cache


def init_cache(params: Dict[str, Any], cfg: ModelConfig, batch: int,
               seq_len: int, *, frontend: Optional[torch.Tensor] = None,
               dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Empty decode cache for a maximum context of ``seq_len``, on
    ``device`` (default: the parameters' device).  K/V leaves take
    ``dtype``; the SSM leaves are fp32 and the cross leaves bf16 whatever
    ``dtype`` says, as in the reference.  The encdec/vlm cross K/V are
    computed from ``frontend`` (B, F, D) as the reference does; without
    it they are zeros of their shape, ``(L | n_cross, batch,
    frontend_tokens, kv_dim)`` — the slot engine's template, which runs
    no encoder.  A ``"meta"`` device gives the leaf shapes and dtypes
    without memory."""
    require_family(cfg)
    device = params["embed"].device if device is None else device
    s_c = cache_len(cfg, seq_len)

    def kv(n, s=s_c, dt=dtype):
        shape = (n, batch, s, cfg.kv_dim)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}

    cache: Dict[str, Any] = {"pos": 0}
    if cfg.family in ("dense", "moe", "encdec", "vlm"):
        cache["self"] = kv(cfg.n_layers)
    if cfg.family in ("encdec", "vlm"):
        if frontend is None:
            n = (cfg.n_layers if cfg.family == "encdec"
                 else cfg.n_layers // cfg.cross_attn_every)
            cache["cross"] = kv(n, cfg.frontend_tokens, torch.bfloat16)
        elif cfg.family == "encdec":
            cache["cross"] = _cross_cache(params, cfg,
                                          enc=encode(params, frontend, cfg))
        else:
            cache["cross"] = _cross_cache(
                params, cfg, img=frontend.to(torch_dtype(cfg.dtype)))
    if cfg.family in ("ssm", "hybrid"):
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
    tensors; its cross K/V are the given ones, unchanged).  On a mesh
    the tokens and positions are global, the cache is the rank's batch
    rows (as prefill on the mesh made it) and the logits are global."""
    require_family(cfg)
    compute = torch_dtype(cfg.dtype)
    new_cache: Dict[str, Any] = {"pos": cache["pos"] + 1}
    rows = etp.layout_for(tokens.shape[0], 1, cfg)
    pos = cache["pos"]
    if isinstance(pos, torch.Tensor):
        pos = etp.local_rows(pos, rows)
    x = params["embed"][etp.local_rows(tokens, rows)].to(compute)
    with etp.activation(rows):
        x, new_cache = _decode_blocks(params, x, pos, cache, new_cache, cfg)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = etp.gather_rows(logits_from_hidden(params, x, cfg), rows)
    return logits[:, 0], new_cache


def _decode_blocks(params, x, pos, cache, new_cache, cfg):
    """Every block of one decode step: (x, the new cache)."""
    lay = params["layers"]
    if cfg.family in ("dense", "moe", "encdec", "vlm"):
        ck, cv = cache["self"]["k"], cache["self"]["v"]
        cross = cache.get("cross")
        for i in range(ck.shape[0]):
            self_kv = {"k": ck[i], "v": cv[i]}
            if cfg.family == "encdec":
                x, _ = _decoder_block(
                    layer_params(lay, i), x, cfg, cache=self_kv, pos=pos,
                    cross={"k": cross["k"][i], "v": cross["v"][i]})
                continue
            if cfg.family == "vlm" and i % cfg.cross_attn_every == 0:
                gi = i // cfg.cross_attn_every
                x = _cross_block(
                    layer_params(params["cross_layers"], gi), x, cfg,
                    cross={"k": cross["k"][gi], "v": cross["v"][gi]})
            x, _, _ = _dense_block(layer_params(lay, i), x, cfg,
                                   cache=self_kv, pos=pos)
        new_cache["self"] = {"k": ck, "v": cv}
        if cross is not None:
            new_cache["cross"] = cross
    else:
        conv, state = cache["ssm"]["conv"], cache["ssm"]["state"]
        lanes = []
        for i in range(conv.shape[0]):
            x, c = _ssm_block(layer_params(lay, i), x, cfg,
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
    return x, new_cache
