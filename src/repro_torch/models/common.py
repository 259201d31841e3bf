"""Shared model machinery: initializers, norms, RoPE, the loss.

The port of the reference's ``models/common.py``.  Parameters are plain
nested dicts of tensors with the reference's keys and layouts (weights
``(in, out)``, per-layer leaves stacked ``(L, ...)``), so a reference
parameter tree carries across leaf for leaf (``convert.params_from_
reference``).  The reference's logical-axis leaves and its ``shard`` /
``shard_pinned`` constraints are GSPMD's: the port has no counterpart
for them; on a mesh its layout is explicit (``explicit_tp``).

Initializers draw from a ``torch.Generator`` on the generator's device,
with the reference's scales; the numbers differ from ``jax.random``'s
for the same seed, so parity tests carry the reference's parameters
across instead of drawing their own.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def normal(gen: torch.Generator, shape: Tuple[int, ...]) -> torch.Tensor:
    """Standard-normal fp32 draw on the generator's device."""
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else (1.0 / in_dim) ** 0.5
    return normal(gen, (in_dim, out_dim)) * scale


def stacked_dense_init(gen: torch.Generator, n: int, in_dim: int,
                       out_dim: int, scale: Optional[float] = None
                       ) -> torch.Tensor:
    scale = scale if scale is not None else (1.0 / in_dim) ** 0.5
    return normal(gen, (n, in_dim, out_dim)) * scale


def zeros_init(gen: torch.Generator, shape: Tuple[int, ...]) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=gen.device)


def ones_init(gen: torch.Generator, shape: Tuple[int, ...]) -> torch.Tensor:
    return torch.ones(shape, dtype=torch.float32, device=gen.device)


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gamma).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding.  x: (..., L, D even), positions: (L,) or (B, L)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs   # (..., L, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    # broadcast across head dims: x (..., H, L, D) vs ang (L, half)/(B,L,half)
    while cos.dim() < x.dim():
        cos, sin = cos[..., None, :, :], sin[..., None, :, :]
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean cross-entropy in fp32 (the reference's): ``logsumexp``
    of the logits minus the target's logit; with ``mask``, the masked
    mean over at least one token."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.to(nll.dtype)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(nll)
