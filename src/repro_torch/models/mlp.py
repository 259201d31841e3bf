"""Feed-forward layers: the dense SwiGLU MLP and the top-k MoE with
capacity dispatch.

The port of the reference's ``models/mlp.py``.  Weights are ``(in,
out)`` and stacked ``(L, ...)`` as there; expert weights carry an
expert axis after the layer axis, ``(L, E, in, out)``.  The reference
casts its fp32 master weights to the compute dtype on every call; here
``.to(compute)`` is a no-op on weights the engines cast once
(``transformer.compute_params``), and the values are the same.  The
router stays fp32 (``compute_params`` keeps it), as the reference routes
from the fp32 master.

The MoE dispatches by index: tokens are grouped by batch row, each group
with its own capacity, and ``_dispatch_indices`` gives every group an
``(E, C)`` table of the choices that won a place (token order, then
slot; the rest are dropped).  The reference ``vmap``s its per-group
expert products; here each product is one batched product over all
groups, ``(E, G * C, D) @ (E, D, F)``, so the expert weights are read
once a call.  The combine gathers each token's kept contributions and
sums them in slot order, so a token's output does not depend on the
other groups.  The reference's explicit-collective (mesh) branches call
``explicit_tp``'s helpers, which return None with no mesh; on a mesh
they run the rank model that module describes.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..compile.pipeline import torch_dtype
from ..configs.base import ModelConfig
from . import explicit_tp as etp
from .common import Logical, normal, stacked, stacked_dense_init


def init_mlp(gen: torch.Generator, cfg: ModelConfig, n_layers: int
             ) -> Dict[str, torch.Tensor]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wg": stacked_dense_init(gen, n_layers, d, f),
        "wu": stacked_dense_init(gen, n_layers, d, f),
        "wd": stacked_dense_init(gen, n_layers, f, d),
    }


def mlp_axes(n_layers: Optional[int]) -> Dict[str, Logical]:
    """The logical axes of :func:`init_mlp`'s leaves (one layer's when
    ``n_layers`` is None), the reference's."""
    return {"wg": stacked(n_layers, "embed", "mlp"),
            "wu": stacked(n_layers, "embed", "mlp"),
            "wd": stacked(n_layers, "mlp", "embed")}


def apply_mlp(p: Dict[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU: ``(silu(x Wg) * (x Wu)) Wd`` in the compute dtype, silu in
    fp32, the down projection accumulated in fp32 and cast to x's dtype.

    With ``cfg.explicit_collectives`` the reference's manual branches run
    first (``explicit_tp.mlp_manual``, the gather, ``project_scatter``);
    with no mesh they return None and this is the one-device MLP, bit
    for bit.  On a mesh x and the result are in the stream's layout."""
    compute = torch_dtype(cfg.dtype)
    lay = etp.current_layout()
    manual = cfg.explicit_collectives and cfg.sequence_parallel
    if manual:
        # fully-manual dataflow: gather + dots + reduce-scatter in one
        res = etp.mlp_manual(x, p["wg"], p["wu"], p["wd"], compute, lay)
        if res is not None:
            return res.to(x.dtype)
    # SP -> TP boundary: gather the compute-dtype sequence shards here
    xc = x.to(compute)
    xg = etp.gather_seq(xc, lay) if cfg.explicit_collectives else None
    xc = xg if xg is not None else etp.full_seq(xc, lay)
    g = xc @ p["wg"].to(compute)
    u = xc @ p["wu"].to(compute)
    h = torch.nn.functional.silu(g.to(torch.float32)).to(compute) * u
    wd = p["wd"].to(compute)
    if manual:
        res = etp.project_scatter(etp.model_block(h, 2), wd, lay)
        if res is not None:
            return res.to(x.dtype)
    return etp.to_layout((h @ wd).to(x.dtype), lay)


# ---------------------------------------------------------------------------
# MoE (top-k, capacity-based, gather/scatter dispatch)
# ---------------------------------------------------------------------------

def init_moe(gen: torch.Generator, cfg: ModelConfig, n_layers: int
             ) -> Dict[str, torch.Tensor]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts

    def expert_w(din, dout):
        # scaled in place: an expert stack is the largest leaf there is
        return normal(gen, (n_layers, e, din, dout)).mul_((1.0 / din) ** 0.5)

    return {
        "router": stacked_dense_init(gen, n_layers, d, e,
                                     scale=(1.0 / d) ** 0.5),
        "wg": expert_w(d, f),
        "wu": expert_w(d, f),
        "wd": expert_w(f, d),
    }


def moe_axes() -> Dict[str, Logical]:
    """The logical axes of :func:`init_moe`'s leaves, the reference's:
    experts replicated, tensor-parallel inside each over ``mlp``."""
    return {"router": Logical(("layers", "embed", None)),
            "wg": Logical(("layers", "expert", "embed", "mlp")),
            "wu": Logical(("layers", "expert", "embed", "mlp")),
            "wd": Logical(("layers", "expert", "mlp", "embed"))}


def capacity(cfg: ModelConfig, s: int) -> int:
    """Expert slots per group of ``s`` tokens."""
    return int(s * cfg.top_k / cfg.n_experts * cfg.capacity_factor + 1)


def _dispatch(top_idx: torch.Tensor, n_experts: int, capacity: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`_dispatch_indices`, plus each choice's place in its
    expert's queue ``(..., T, K)`` (>= capacity when dropped)."""
    *lead, t, k = top_idx.shape
    g = top_idx.reshape(-1, t * k).long()                      # (G, T*K)
    n = g.shape[0]
    pos = F.one_hot(g, n_experts).cumsum(dim=1) - 1            # slot in expert
    my_pos = pos.gather(2, g[..., None])[..., 0]
    keep = my_pos < capacity
    # dropped choices go to a spare row and column that are cut off, so
    # no index depends on the data's count of drops
    e_idx = torch.where(keep, g, torch.full_like(g, n_experts))
    c_idx = torch.where(keep, my_pos, torch.full_like(my_pos, capacity))
    buf = torch.full((n, n_experts + 1, capacity + 1), t * k,
                     dtype=torch.int32, device=g.device)
    rows = torch.arange(n, device=g.device)[:, None].expand(n, t * k)
    ids = torch.arange(t * k, dtype=torch.int32, device=g.device)
    buf[rows, e_idx, c_idx] = ids.expand(n, t * k)
    return (buf[:, :n_experts, :capacity].reshape(*lead, n_experts, capacity),
            keep.reshape(*lead, t, k), my_pos.reshape(*lead, t, k))


def _dispatch_indices(top_idx: torch.Tensor, n_experts: int, capacity: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """top_idx: (..., T, K) expert choice per token/slot, one group per
    leading index.

    Returns (token_slot (..., E, C) int32 index into the group's T*K flat
    choices — entries equal to T*K are empty —, keep_mask (..., T, K)
    bool for choices that won the capacity race).  Priority: token
    order, then slot (GShard-style)."""
    return _dispatch(top_idx, n_experts, capacity)[:2]


def route(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router in fp32: (logits (B, S, E), probs, gates (B, S, K)
    renormalised over the top k, top_idx (B, S, K))."""
    logits = x.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gates, top_idx = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, gates, top_idx


def _aux_terms(logits, probs, top_idx, cfg):
    """The Switch-style load-balance loss's ``me`` (mean router
    probability an expert), ``ce`` (share of choices an expert) and the
    router z-loss's mean ``logsumexp^2``."""
    e = cfg.n_experts
    me = probs.mean(dim=(0, 1))
    n = top_idx.numel()
    ce = torch.zeros((e,), dtype=torch.float32,
                     device=logits.device).index_add_(
        0, top_idx.reshape(-1),
        torch.full((n,), 1.0 / n, device=logits.device))
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return me, ce, z


def router_aux(logits, probs, top_idx, cfg) -> torch.Tensor:
    """aux load-balance loss (Switch-style) + router z-loss, fp32 0-d."""
    me, ce, z = _aux_terms(logits, probs, top_idx, cfg)
    return cfg.n_experts * torch.sum(me * ce) + 1e-3 * z


def expert_inputs(x: torch.Tensor, top_idx: torch.Tensor, cfg: ModelConfig,
                  compute: torch.dtype):
    """Dispatch each batch row's choices to its experts' queues: (xin (E,
    B*C, D) in ``compute``, keep (B, S, K), my_pos (B, S, K), C)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, s)
    slots, keep, my_pos = _dispatch(top_idx, e, cap)      # (B, E, C)
    valid = slots < s * k
    token_of = torch.clamp(slots.long() // k, max=s - 1)
    rows = torch.arange(b, device=x.device)[:, None, None]
    xin = torch.where(valid[..., None], x[rows, token_of],
                      torch.zeros((), dtype=x.dtype, device=x.device))
    # one batched product per weight over every group: (E, B*C, D)
    xin = xin.to(compute).transpose(0, 1).reshape(e, b * cap, d)
    return xin, keep, my_pos, cap


def combine(out_e: torch.Tensor, top_idx: torch.Tensor, gates: torch.Tensor,
            keep: torch.Tensor, my_pos: torch.Tensor, cap: int
            ) -> torch.Tensor:
    """Each token gathers its kept choices' expert outputs ``out_e`` (E, B,
    C, D), weighted by their gates, summed in slot order: (B, S, D)
    fp32."""
    b = top_idx.shape[0]
    rows = torch.arange(b, device=out_e.device)[:, None, None]
    c_idx = torch.clamp(my_pos, max=cap - 1)
    contrib = (out_e[top_idx, rows, c_idx].to(torch.float32)
               * gates[..., None])
    contrib = torch.where(keep[..., None], contrib,
                          torch.zeros((), device=out_e.device))
    out = contrib[:, :, 0]
    for j in range(1, top_idx.shape[-1]):
        out = out + contrib[:, :, j]
    return out


def apply_moe(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out in x's dtype, aux_loss fp32 0-d).

    Tokens are grouped by batch row (G = B groups of S tokens), with the
    capacity per group; a choice that lost the capacity race contributes
    nothing.  With ``cfg.explicit_collectives`` and sequence parallelism
    ``explicit_tp.moe_manual`` runs first (None with no mesh).  On a mesh
    the fallback runs the rank's batch rows on the whole sequence and
    averages each aux term over the batch axes (the global loss)."""
    compute = torch_dtype(cfg.dtype)
    lay = etp.current_layout()
    if cfg.explicit_collectives and cfg.sequence_parallel:
        res = etp.moe_manual(x, p, cfg, compute, lay)
        if res is not None:
            return res[0].to(x.dtype), res[1]
    x = etp.full_seq(x, lay)                          # SP -> TP gather
    b, s, d = x.shape
    e = cfg.n_experts
    logits, probs, gates, top_idx = route(p, x, cfg)
    me, ce, z = _aux_terms(logits, probs, top_idx, cfg)
    n = etp.batch_shards() if lay is not None else 1
    if n > 1 and lay.batch % n == 0:
        me, ce, z = (etp.psum_batch(t) / n for t in (me, ce, z))
    aux = e * torch.sum(me * ce) + 1e-3 * z

    xin, keep, my_pos, cap = expert_inputs(x, top_idx, cfg, compute)
    h = F.silu((xin @ p["wg"].to(compute)).to(torch.float32)).to(compute)
    h = h * (xin @ p["wu"].to(compute))
    out_e = (h @ p["wd"].to(compute)).reshape(e, b, cap, d)
    out = combine(out_e, top_idx, gates, keep, my_pos, cap)
    return etp.to_layout(out.to(x.dtype), lay), aux
