"""Shared model machinery: initializers, norms, RoPE, the loss.

The port of the reference's ``models/common.py``.  Parameters are plain
nested dicts of tensors with the reference's keys and layouts (weights
``(in, out)``, per-layer leaves stacked ``(L, ...)``), so a reference
parameter tree carries across leaf for leaf (``convert.params_from_
reference``).  The reference builds each parameter as a ``Leaf(value,
logical axes)``; the port keeps the values and the axes apart: the
initializers draw the values, ``transformer.param_axes(cfg)`` gives the
same keys with a :class:`Logical` each, and :class:`AxisRules` maps them
to mesh axes as the reference's does (``DEFAULT_RULES``), which is how
``train.trainer`` places a train state on a mesh.  The reference's
``shard`` / ``shard_pinned`` activation constraints are GSPMD's: on a
mesh the port's activation layout is explicit (``explicit_tp``).

Initializers draw from a ``torch.Generator`` on the generator's device,
with the reference's scales; the numbers differ from ``jax.random``'s
for the same seed, so parity tests carry the reference's parameters
across instead of drawing their own.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch

from ..dist.comm_engine import Spec


# ---------------------------------------------------------------------------
# Logical axes and the rules that map them to mesh axes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Logical:
    """Logical axis names of one parameter, one a dimension (None: no
    name)."""
    axes: Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """logical axis -> mesh axis (or tuple of mesh axes)."""
    rules: Dict[str, Union[str, Tuple[str, ...], None]]

    def spec_for(self, axes: Logical, shape: Tuple[int, ...],
                 mesh_shape: Mapping[str, int]) -> Spec:
        out = []
        for dim, name in zip(shape, axes.axes):
            mesh_ax = self.rules.get(name) if name else None
            if mesh_ax is None:
                out.append(None)
                continue
            size = 1
            for ax in ((mesh_ax,) if isinstance(mesh_ax, str) else mesh_ax):
                size *= mesh_shape.get(ax, 1)
            # divisibility fallback: replicate rather than force padding
            out.append(mesh_ax if dim % size == 0 else None)
        return Spec(*out)

    def specs(self, axes_tree: Any, shapes_tree: Any,
              mesh_shape: Mapping[str, int]) -> Any:
        """A :class:`Spec` for every leaf of equally keyed nested dicts of
        :class:`Logical` and of tensors (anything with ``.shape``)."""
        if isinstance(axes_tree, dict):
            return {k: self.specs(axes_tree[k], shapes_tree[k], mesh_shape)
                    for k in axes_tree}
        return self.spec_for(axes_tree, tuple(shapes_tree.shape),
                             mesh_shape)


#: default rules for the production mesh (pod, data, model):
#:   fsdp  — parameter & optimizer-state sharding over the data axis (ZeRO-3)
#:   tp    — tensor-parallel over the model axis
DEFAULT_RULES = AxisRules({
    "embed": "data",        # d_model dim of weights: FSDP
    "heads": "model",       # attention heads / q projection out-dim
    "kv": "model",          # kv projection out-dim (flattened kv_dim)
    "mlp": "model",         # d_ff
    "vocab": "model",       # embedding table / logits
    "layers": None,         # stacked-scan layer dim stays unsharded
    "expert": None,         # experts replicated; TP inside experts ("mlp")
    "ssm_inner": "model",   # mamba d_inner
    "ssm_state": None,
    "batch": ("pod", "data"),
    "seq": "model",         # sequence parallelism for residual activations
})


def stacked(n: Optional[int], *axes: Optional[str]) -> Logical:
    """The axes of a parameter stacked over ``n`` layers (``("layers",
    *axes)``), or of one layer's when ``n`` is None (the hybrid's shared
    block)."""
    return Logical(axes if n is None else ("layers", *axes))


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
