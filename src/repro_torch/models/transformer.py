"""Model assembly and the public forward pass: the dense, SSM and
hybrid families.

The port of the reference's ``models/transformer.py`` for

    dense  — decoder-only, uniform layers
    ssm    — Mamba-2 stack (attention-free)
    hybrid — Mamba-2 backbone + ONE shared attn+MLP block applied after
             every ``attn_every`` layers (Zamba2-style parameter sharing),
             each application with its own KV cache entry

and its graph-expressible layer oracle ``dense_layer_forward``.
Parameters are nested dicts of tensors with the reference's keys;
per-layer leaves are stacked ``(L, ...)`` and the reference's ``scan``
over layers is a Python loop.  The other families raise
``NotImplementedError`` naming their slice: moe (the MoE slice), encdec
and vlm (the encdec/vlm slice).

``compute_params`` casts the fp32 master weights to the compute dtype
once (the reference casts them on every call; the values are the same),
which the serving engines do when they are built.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..compile.pipeline import torch_dtype
from ..configs.base import ModelConfig
from ..kernels import epilogue as epilogue_mod
from ..kernels.ops import resolve_device
from ..kernels.stt_gemm import _fp32_product
from . import attention as attn
from . import mlp as mlp_mod
from . import ssm as ssm_mod
from .common import normal, ones_init, rmsnorm

#: the families the port runs
FAMILIES = ("dense", "ssm", "hybrid")
#: the family each later slice brings
LATER_FAMILIES = {"moe": "MoE", "encdec": "encdec/vlm", "vlm": "encdec/vlm"}


def require_family(cfg: ModelConfig) -> None:
    """Raise for a family the port does not run yet, naming its slice."""
    if cfg.family not in FAMILIES:
        if cfg.family in LATER_FAMILIES:
            raise NotImplementedError(
                f"the {cfg.family} family arrives with the "
                f"{LATER_FAMILIES[cfg.family]} slice")
        raise ValueError(cfg.family)


def hybrid_groups(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_groups, group_size, tail) of the zamba2 grouping: the shared
    block follows each of the first ``n_groups`` groups of
    ``group_size`` SSM layers; ``tail`` SSM layers follow the last."""
    g = cfg.attn_every
    n_apps = cfg.n_layers // g
    return n_apps, g, cfg.n_layers - n_apps * g


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    """fp32 master parameters on the generator's device, with the
    reference's keys, shapes and initializer scales.  The hybrid's shared
    block is unstacked (no leading layer axis), as in the reference."""
    require_family(cfg)
    d, L = cfg.d_model, cfg.n_layers
    p: Dict[str, Any] = {
        "embed": 0.02 * normal(gen, (cfg.vocab, d)),
        "final_norm": ones_init(gen, (d,)),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = (1.0 / d ** 0.5) * normal(gen, (d, cfg.vocab))
    if cfg.family == "dense":
        p["layers"] = {
            "ln1": ones_init(gen, (L, d)),
            "ln2": ones_init(gen, (L, d)),
            "attn": attn.init_attention(gen, cfg, L),
            "ffn": mlp_mod.init_mlp(gen, cfg, L),
        }
        return p
    p["layers"] = {
        "ln1": ones_init(gen, (L, d)),
        "ssm": ssm_mod.init_ssm(gen, cfg, L),
    }
    if cfg.family == "hybrid":
        p["shared"] = {
            "ln1": ones_init(gen, (d,)),
            "ln2": ones_init(gen, (d,)),
            "attn": layer_params(attn.init_attention(gen, cfg, 1), 0),
            "mlp": layer_params(mlp_mod.init_mlp(gen, cfg, 1), 0),
        }
    return p


#: leaves that stay fp32 under ``compute_params``: the norm gains and the
#: SSM block's conv, decay, skip, dt-bias and gate-norm parameters, which
#: the reference applies in fp32 (only ``in_proj``/``out_proj`` of an SSM
#: block go to the compute dtype), and the prepared output projection
_FP32_LEAVES = ("ln1", "ln2", "final_norm", "w_out", "conv_w", "conv_b",
                "a_log", "d_skip", "dt_bias", "norm_g")


def compute_params(params: Dict[str, Any], cfg: ModelConfig
                   ) -> Dict[str, Any]:
    """The parameters a serving engine runs: every weight cast to the
    compute dtype once, the norm gains kept fp32, and ``w_out`` — the
    output projection ``(d, vocab)`` rounded to the compute dtype and
    held in fp32, the operand of the logits product.  The masters are
    not changed."""
    compute = torch_dtype(cfg.dtype)

    def cast(tree):
        return {k: (cast(v) if isinstance(v, dict) else
                    v if k in _FP32_LEAVES else v.to(compute))
                for k, v in tree.items()}

    out = cast(params)
    out["w_out"] = _w_out(params, cfg)
    return out


def _w_out(params: Dict[str, Any], cfg: ModelConfig) -> torch.Tensor:
    w = params.get("w_out")
    if w is None:
        w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
        w = w.to(torch_dtype(cfg.dtype)).to(torch.float32)
    return w


def logits_from_hidden(params: Dict[str, Any], x: torch.Tensor,
                       cfg: ModelConfig) -> torch.Tensor:
    """The output projection: x and the weights in the compute dtype,
    products and sums in fp32, fp32 logits (the reference's
    ``preferred_element_type=float32``)."""
    xc = x.to(torch_dtype(cfg.dtype)).to(torch.float32)
    return torch.matmul(xc, _w_out(params, cfg))


def layer_params(stacked: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    return {k: (layer_params(v, i) if isinstance(v, dict) else v[i])
            for k, v in stacked.items()}


# ---------------------------------------------------------------------------
# blocks (params already unstacked)
# ---------------------------------------------------------------------------

def _dense_block(pl_, x, cfg, *, causal=True, collect_kv=False):
    h, kv = attn.apply_attention(
        pl_["attn"], rmsnorm(x, pl_["ln1"], cfg.norm_eps), cfg,
        causal=causal, collect_kv=collect_kv)
    x = x + h
    h = mlp_mod.apply_mlp(pl_["ffn"], rmsnorm(x, pl_["ln2"], cfg.norm_eps),
                          cfg)
    return x + h, torch.zeros((), dtype=torch.float32, device=x.device), kv


def _ssm_block(pl_, x, cfg, *, cache=None, collect_cache=False):
    h, c = ssm_mod.apply_ssm(pl_["ssm"], rmsnorm(x, pl_["ln1"], cfg.norm_eps),
                             cfg, cache=cache, collect_cache=collect_cache)
    return x + h, c


def _shared_block(ps, x, cfg, *, cache=None, pos=None, collect_kv=False):
    h, kv = attn.apply_attention(ps["attn"],
                                 rmsnorm(x, ps["ln1"], cfg.norm_eps), cfg,
                                 cache=cache, pos=pos, collect_kv=collect_kv)
    x = x + h
    h = mlp_mod.apply_mlp(ps["mlp"], rmsnorm(x, ps["ln2"], cfg.norm_eps), cfg)
    return x + h, kv


def shared_after(cfg: ModelConfig, i: int) -> Optional[int]:
    """The shared application ``gi`` that follows SSM layer ``i`` of a
    hybrid (None for the ssm family and for layers inside a group or in
    the tail)."""
    if cfg.family != "hybrid":
        return None
    gi, r = divmod(i + 1, cfg.attn_every)
    return gi - 1 if r == 0 else None


def _stack(trees):
    """A list of equally keyed dicts of tensors -> one dict of stacks."""
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def forward_hidden(params: Dict[str, Any], tokens: torch.Tensor,
                   cfg: ModelConfig, *, collect_cache: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor,
                              Optional[Dict[str, Any]]]:
    """:func:`forward` up to the final norm: (hidden (B, S, D), aux_loss,
    caches|None)."""
    require_family(cfg)
    compute = torch_dtype(cfg.dtype)
    x = params["embed"][tokens].to(compute)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    n_layers = params["layers"]["ln1"].shape[0]
    if cfg.family == "dense":
        kvs = []
        for i in range(n_layers):
            x, aux_l, kv = _dense_block(layer_params(params["layers"], i),
                                        x, cfg, collect_kv=collect_cache)
            aux = aux + aux_l
            kvs.append(kv)
        caches = {"self": _stack(kvs)} if collect_cache else None
        return rmsnorm(x, params["final_norm"], cfg.norm_eps), aux, caches

    ssm_caches, shared_kv = [], []
    for i in range(n_layers):
        x, c = _ssm_block(layer_params(params["layers"], i), x, cfg,
                          collect_cache=collect_cache)
        ssm_caches.append(c)
        if shared_after(cfg, i) is not None:
            x, kv = _shared_block(params["shared"], x, cfg,
                                  collect_kv=collect_cache)
            shared_kv.append(kv)
    caches = None
    if collect_cache:
        caches = {"ssm": _stack(ssm_caches)}
        if shared_kv:
            caches["shared"] = _stack(shared_kv)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps), aux, caches


def forward(params: Dict[str, Any], tokens: torch.Tensor, cfg: ModelConfig,
            *, frontend: Optional[torch.Tensor] = None,
            collect_cache: bool = False,
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict[str, Any]]]:
    """tokens: (B, S) int -> (logits (B, S, V) fp32, aux_loss, caches|None).

    With ``collect_cache`` the caches are, for the dense family,
    ``{"self": {"k", "v"}}`` of rotated K / V, ``(L, B, S, kv_dim)`` each;
    for ssm/hybrid ``{"ssm": {"conv" (L, B, k-1, conv_dim), "state" (L,
    B, H, N, P)}}`` in fp32, and for the hybrid also ``{"shared": {"k",
    "v"}}`` ``(n_groups, B, S, kv_dim)``.  ``frontend`` (the encdec/vlm
    stub input) is not taken by these families."""
    if frontend is not None:
        raise NotImplementedError("frontend inputs arrive with the "
                                  "encdec/vlm slice")
    x, aux, caches = forward_hidden(params, tokens, cfg,
                                    collect_cache=collect_cache)
    return logits_from_hidden(params, x, cfg), aux, caches


# ---------------------------------------------------------------------------
# Graph-expressible layer oracle (dense family)
# ---------------------------------------------------------------------------


def dense_layer_forward(x, wq, wk, wv_t, wo, w1, b1, w2,
                        dtype: str = "float32", device=None
                        ) -> torch.Tensor:
    """One simplified dense-family layer, stage for stage the graph
    :func:`repro_torch.graph.from_model.transformer_layer_graph` builds:
    single head, no RoPE/GQA/norms, weights in the paper's ``(out, in)``
    storage so every projection is ``X @ W.T``; ``wv_t`` holds the value
    projection pre-transposed ``(dv, d)``.  Each stage accumulates in
    fp32, applies its epilogue in fp32, then casts to ``dtype`` — the
    flush the fused megakernel and the sequential dispatcher perform.

    Tensors stay on their device; array-likes go to ``device`` (the card
    by default).  Returns the post-MLP residual stream ``(l, d)``.
    """
    dt = torch_dtype(dtype)
    f32 = torch.float32
    dev = (x.device if isinstance(x, torch.Tensor)
           else resolve_device(device))

    def t(a):
        return torch.as_tensor(a, device=dev)

    def proj(a, w, epi=(), bias=None):
        acc = _fp32_product(t(a).to(dt), t(w).to(dt).T)
        if epi:
            acc = epilogue_mod.apply_epilogue(acc, epi, bias=bias)
        return acc.to(dt)

    d = t(x).shape[-1]
    q = proj(x, wq)
    k = proj(x, wk)
    vt = proj(wv_t, x)                     # (dv, l): values, born transposed
    p = proj(q, k, epi=(f"scale:{1.0 / math.sqrt(d)}", "softmax"))
    a = proj(p, vt)                        # vt lands on the rhs: p @ vt.T
    o = proj(a, wo)
    r1 = (o.to(f32) + t(x).to(f32)).to(dt)
    h = proj(r1, w1, epi=("bias", "gelu"), bias=t(b1).to(f32))
    y = proj(h, w2)
    return (y.to(f32) + r1.to(f32)).to(dt)
