"""Feed-forward layers: the dense SwiGLU MLP.

The port of the reference's ``models/mlp.py`` dense path.  Weights are
``(in, out)`` and stacked ``(L, ...)`` as there.  The reference casts
its fp32 master weights to the compute dtype on every call; here
``.to(compute)`` is a no-op on weights the engines cast once
(``transformer.compute_params``), and the values are the same.  The
reference's explicit-collective (mesh) branches have no counterpart on
one device; ``apply_moe`` arrives with the MoE slice.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..compile.pipeline import torch_dtype
from ..configs.base import ModelConfig
from .common import stacked_dense_init


def init_mlp(gen: torch.Generator, cfg: ModelConfig, n_layers: int
             ) -> Dict[str, torch.Tensor]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wg": stacked_dense_init(gen, n_layers, d, f),
        "wu": stacked_dense_init(gen, n_layers, d, f),
        "wd": stacked_dense_init(gen, n_layers, f, d),
    }


def apply_mlp(p: Dict[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU: ``(silu(x Wg) * (x Wu)) Wd`` in the compute dtype, silu in
    fp32, the down projection accumulated in fp32 and cast to x's dtype."""
    if cfg.explicit_collectives:
        raise NotImplementedError(
            "explicit_collectives (explicit_tp) arrives with the mesh slice")
    compute = torch_dtype(cfg.dtype)
    xc = x.to(compute)
    g = xc @ p["wg"].to(compute)
    u = xc @ p["wu"].to(compute)
    h = torch.nn.functional.silu(g.to(torch.float32)).to(compute) * u
    return (h @ p["wd"].to(compute)).to(x.dtype)


def apply_moe(p, x, cfg):
    raise NotImplementedError("the MoE family (apply_moe) arrives with the "
                              "MoE slice")
