"""Model assembly and the public forward pass for every family.

The port of the reference's ``models/transformer.py``:

    dense / moe — decoder-only, uniform layers (moe: top-k experts in
                  place of the MLP)
    ssm         — Mamba-2 stack (attention-free)
    hybrid      — Mamba-2 backbone + ONE shared attn+MLP block applied
                  after every ``attn_every`` layers (Zamba2-style
                  parameter sharing), each application with its own KV
                  cache entry
    encdec      — whisper-style: bidirectional encoder over stub frame
                  embeddings + causal decoder with per-layer
                  cross-attention to the encoder output
    vlm         — llama-3.2-vision-style: causal decoder, a gated
                  cross-attention block (to stub image embeddings)
                  before every ``cross_attn_every`` layers

and its graph-expressible layer oracle ``dense_layer_forward``.
Parameters are nested dicts of tensors with the reference's keys;
per-layer leaves are stacked ``(L, ...)`` and the reference's ``scan``
over layers is a Python loop.  The vlm's gated residual ``x +
tanh(gate) * h`` is fp32 from the first cross block on, as the
reference's is: JAX promotes the bf16 stream against the fp32 0-d gate,
torch would not, so the port promotes explicitly.

``compute_params`` casts the fp32 master weights to the compute dtype
once (the reference casts them on every call; the values are the same),
which the serving engines do when they are built.

The entry points read a parameter tree through ``models.placed``'s
accessors, so they take whole trees and trees of a rank's blocks
(``placed.place_params``) alike (the outer ones, :func:`forward`,
``decode.prefill``, ``decode.init_cache``, ``decode.decode_step`` and
``train.trainer.rank_loss``, hand the tree through ``placed.on_mesh``
once; :func:`forward_hidden`, :func:`encode` and :func:`logit_block`
read it as they are handed it): on a model mesh each layer's weights
are gathered over the batch axes just before the layer runs, each leaf
keeping the rank's ``model`` block, and dropped after it (a whole tree's
blocks are views); the blocks compute on them (``explicit_tp``'s rank
model), the embedding looks the tokens up on the rank's vocab rows and
the logits are computed on its vocab block, which serving gathers.

Training differentiates :func:`forward` with autograd.  With
``cfg.remat`` and autograd recording, every block (a layer, the hybrid's
shared block, a vlm cross block, an encoder layer) runs under
``torch.utils.checkpoint`` (non-reentrant): its activations are
recomputed in the backward, as the reference's ``jax.checkpoint`` of
each scanned layer does.  A block is handed a call that gives its
weights, made inside the checkpoint: on a placed tree the layer is
gathered there and gathered again in the recompute, so the checkpoint
holds only the rank's blocks (FSDP's reshard after forward), and the
gathered weights' gradient is summed onto the blocks when the layer's
backward ends (``placed.GatherLeaf``).  Serving runs under ``no_grad``
and calls the blocks as they are.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..compile.pipeline import torch_dtype
from ..configs.base import ModelConfig
from ..kernels import epilogue as epilogue_mod
from ..kernels.ops import resolve_device
from ..kernels.stt_gemm import _fp32_product
from . import attention as attn
from . import explicit_tp as etp
from . import mlp as mlp_mod
from . import placed as pp
from . import ssm as ssm_mod
from .common import Logical, normal, ones_init, rmsnorm, zeros_init

#: the families the port runs
FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def require_family(cfg: ModelConfig) -> None:
    """Raise for a family no model here has."""
    if cfg.family not in FAMILIES:
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
    block is unstacked (no leading layer axis), as in the reference; the
    vlm's cross gates start at 0, so at init the image changes no
    logit."""
    require_family(cfg)
    d, L = cfg.d_model, cfg.n_layers
    p: Dict[str, Any] = {
        "embed": 0.02 * normal(gen, (cfg.vocab, d)),
        "final_norm": ones_init(gen, (d,)),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = (1.0 / d ** 0.5) * normal(gen, (d, cfg.vocab))

    def decoder(n, init_ffn):
        return {"ln1": ones_init(gen, (n, d)), "ln2": ones_init(gen, (n, d)),
                "attn": attn.init_attention(gen, cfg, n),
                "ffn": init_ffn(gen, cfg, n)}

    if cfg.family in ("dense", "moe", "vlm"):
        p["layers"] = decoder(L, mlp_mod.init_moe if cfg.family == "moe"
                              else mlp_mod.init_mlp)
        if cfg.family == "vlm":
            n_cross = L // cfg.cross_attn_every
            p["cross_layers"] = {
                "ln": ones_init(gen, (n_cross, d)),
                "attn": attn.init_attention(gen, cfg, n_cross),
                "gate": zeros_init(gen, (n_cross,)),
            }
        return p
    if cfg.family == "encdec":
        p["encoder"] = decoder(cfg.n_enc_layers, mlp_mod.init_mlp)
        p["enc_norm"] = ones_init(gen, (d,))
        p["layers"] = {
            "ln1": ones_init(gen, (L, d)),
            "ln2": ones_init(gen, (L, d)),
            "ln3": ones_init(gen, (L, d)),
            "attn": attn.init_attention(gen, cfg, L),
            "cross": attn.init_attention(gen, cfg, L),
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
            "attn": pp.layer_params(attn.init_attention(gen, cfg, 1), 0),
            "mlp": pp.layer_params(mlp_mod.init_mlp(gen, cfg, 1), 0),
        }
    return p


def param_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical axes of :func:`init_params`'s leaves: the same keys,
    a ``common.Logical`` each — the reference's ``common.split(
    init_params(key, cfg))[1]``.  ``train.trainer`` places a train state
    on a mesh from them."""
    require_family(cfg)
    L = cfg.n_layers
    ln = Logical(("layers", "embed"))
    p: Dict[str, Any] = {"embed": Logical(("vocab", "embed")),
                         "final_norm": Logical(("embed",))}
    if not cfg.tie_embeddings:
        p["unembed"] = Logical(("embed", "vocab"))
    if cfg.family in ("dense", "moe", "vlm"):
        p["layers"] = {"ln1": ln, "ln2": ln,
                       "attn": attn.attention_axes(cfg, L),
                       "ffn": (mlp_mod.moe_axes() if cfg.family == "moe"
                               else mlp_mod.mlp_axes(L))}
        if cfg.family == "vlm":
            p["cross_layers"] = {"ln": ln,
                                 "attn": attn.attention_axes(cfg, L),
                                 "gate": Logical(("layers",))}
    elif cfg.family == "encdec":
        p["encoder"] = {"ln1": ln, "ln2": ln,
                        "attn": attn.attention_axes(cfg, L),
                        "ffn": mlp_mod.mlp_axes(L)}
        p["enc_norm"] = Logical(("embed",))
        p["layers"] = {"ln1": ln, "ln2": ln, "ln3": ln,
                       "attn": attn.attention_axes(cfg, L),
                       "cross": attn.attention_axes(cfg, L),
                       "ffn": mlp_mod.mlp_axes(L)}
    else:
        p["layers"] = {"ln1": ln, "ssm": ssm_mod.ssm_axes()}
        if cfg.family == "hybrid":
            p["shared"] = {"ln1": Logical(("embed",)),
                           "ln2": Logical(("embed",)),
                           "attn": attn.attention_axes(cfg, None),
                           "mlp": mlp_mod.mlp_axes(None)}
    return p


#: leaves that stay fp32 under ``compute_params``: the norm gains, the
#: MoE router and the vlm's cross gates (the reference routes and gates
#: from the fp32 masters), the SSM block's conv, decay, skip, dt-bias and
#: gate-norm parameters, which the reference applies in fp32 (only
#: ``in_proj``/``out_proj`` of an SSM block go to the compute dtype), and
#: the prepared output projection
_FP32_LEAVES = ("ln1", "ln2", "ln3", "ln", "final_norm", "enc_norm",
                "router", "gate", "w_out", "conv_w", "conv_b", "a_log",
                "d_skip", "dt_bias", "norm_g")


def compute_params(params: Dict[str, Any], cfg: ModelConfig
                   ) -> Dict[str, Any]:
    """The parameters a serving engine runs: every weight cast to the
    compute dtype once, the norm gains kept fp32, and on a whole tree
    ``w_out`` — the output projection ``(d, vocab)`` rounded to the
    compute dtype and held in fp32, the operand of the logits product.
    A placed tree (``placed.Placed``) stays the rank's blocks, cast
    alike; its output projection is made from the rank's block at each
    projection, never whole.  The masters are not changed."""
    compute = torch_dtype(cfg.dtype)

    def cast(k, v):
        return v if k in _FP32_LEAVES else v.to(compute)

    if isinstance(params, pp.Placed):
        return params.map(cast)

    def walk(tree):
        return {k: (walk(v) if isinstance(v, dict) else cast(k, v))
                for k, v in tree.items()}

    out = walk(params)
    out["w_out"] = _w_out(params, cfg)[0]
    return out


def _w_out(params: Dict[str, Any], cfg: ModelConfig
           ) -> Tuple[torch.Tensor, Any, Tuple[str, ...], int]:
    """(the output projection, fp32 of compute-dtype values; the mesh,
    the axes its vocab dim is split over and the block's first column,
    ``placed.out_projection``'s): ``w_out`` as prepared, else made from
    ``unembed`` or ``embed.T`` (a placed tree's vocab block, gathered
    over its ``embed`` axes)."""
    w, rm, axes, start = pp.out_projection(params, cfg.tie_embeddings)
    if "w_out" not in params:
        w = w.to(torch_dtype(cfg.dtype)).to(torch.float32)
    return w, rm, axes, start


def logit_block(params: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Any, Tuple[str, ...], int]:
    """(the logits of ``x`` on the rank's vocab block, fp32; the mesh, the
    axes the vocab is split over, the block's first column): x and the
    weights in the compute dtype, products and sums in fp32 (the
    reference's ``preferred_element_type=float32``).  Whole, with no
    axes, off a model mesh."""
    xc = x.to(torch_dtype(cfg.dtype)).to(torch.float32)
    w, rm, axes, start = _w_out(params, cfg)
    return torch.matmul(xc, w), rm, axes, start


def logits_from_hidden(params: Dict[str, Any], x: torch.Tensor,
                       cfg: ModelConfig) -> torch.Tensor:
    """The output projection (:func:`logit_block`), every logit: on a
    model mesh the rank projects onto its vocab block and the blocks are
    gathered over the vocab axes, so every rank gets every logit of its
    rows (the sampler's input)."""
    logits, rm, axes, _ = logit_block(params, x, cfg)
    for a in reversed(axes):
        logits = etp._AllGather.apply(logits, rm, a, logits.dim() - 1)
    return logits


#: layer ``i`` of a stacked tree, as views (``models.placed``'s; the name
#: stays here for its callers)
layer_params = pp.layer_params


# ---------------------------------------------------------------------------
# blocks (params already unstacked)
# ---------------------------------------------------------------------------

def _dense_block(pl_, x, cfg, *, causal=True, cache=None, pos=None,
                 collect_kv=False):
    """Attention + MLP (or MoE) with pre-norms: (x, aux, kv)."""
    h, kv = attn.apply_attention(
        pl_["attn"], rmsnorm(x, pl_["ln1"], cfg.norm_eps), cfg,
        causal=causal, cache=cache, pos=pos, collect_kv=collect_kv)
    x = x + h
    xn = rmsnorm(x, pl_["ln2"], cfg.norm_eps)
    if "router" in pl_["ffn"]:
        h, aux = mlp_mod.apply_moe(pl_["ffn"], xn, cfg)
    else:
        h = mlp_mod.apply_mlp(pl_["ffn"], xn, cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + h, aux, kv


def _decoder_block(pl_, x, cfg, *, enc=None, cross=None, cache=None,
                   pos=None, collect_kv=False):
    """An encdec decoder layer: causal self-attention, cross-attention to
    the encoder output ``enc`` (prefill) or to its static cross cache
    ``cross`` (decode), MLP: (x, kv)."""
    h, kv = attn.apply_attention(
        pl_["attn"], rmsnorm(x, pl_["ln1"], cfg.norm_eps), cfg,
        cache=cache, pos=pos, collect_kv=collect_kv)
    x = x + h
    # with a static cache, kv_x only marks the block as cross-attention
    h, _ = attn.apply_attention(
        pl_["cross"], rmsnorm(x, pl_["ln2"], cfg.norm_eps), cfg,
        kv_x=x if enc is None else enc, causal=False, cache=cross)
    x = x + h
    h = mlp_mod.apply_mlp(pl_["ffn"], rmsnorm(x, pl_["ln3"], cfg.norm_eps),
                          cfg)
    return x + h, kv


def _cross_block(cl, x, cfg, *, img=None, cross=None):
    """A vlm gated cross-attention block to the image embeddings ``img``
    (prefill) or to their static cross cache ``cross`` (decode).  The
    sum takes the promoted dtype of x and the fp32 gate, as the
    reference's does."""
    h, _ = attn.apply_attention(
        cl["attn"], rmsnorm(x, cl["ln"], cfg.norm_eps), cfg,
        kv_x=x if img is None else img, causal=False, cache=cross)
    dt = torch.promote_types(x.dtype, cl["gate"].dtype)
    return x.to(dt) + torch.tanh(cl["gate"]).to(dt) * h.to(dt)


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


def _run(block, cfg: ModelConfig, weights, *args, **kw):
    """``block(weights(), *args, **kw)``, checkpointed when ``cfg.remat``
    and autograd records (the reference's per-layer ``jax.checkpoint``):
    ``weights`` is called inside the checkpoint, so a placed layer is
    gathered there and again in the recomputation, and the checkpoint
    keeps no gathered weight; the recomputation sees the stream's layout
    of the forward."""
    if cfg.remat and torch.is_grad_enabled():
        lay = etp.current_layout()

        def body(*a, **k):
            with etp.activation(lay):
                return block(weights(), *a, **k)
        return checkpoint(body, *args, use_reentrant=False, **kw)
    return block(weights(), *args, **kw)


def _at(seq, i: int):
    """A call that gives ``seq[i]`` (a placed layer is gathered then)."""
    return lambda: seq[i]


def _stack(trees):
    """A list of equally keyed dicts of tensors -> one dict of stacks."""
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def encode(params: Dict[str, Any], frontend: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """encdec: the bidirectional encoder over the stub frame embeddings
    ``frontend`` (B, F, D), after ``enc_norm``, in the compute dtype.  On
    a mesh the frames are a stream of their own: the result is the
    rank's batch rows, every frame."""
    lay = etp.layout_for(frontend.shape[0], frontend.shape[1], cfg)
    h = etp.to_layout(etp.local_rows(frontend, lay).to(
        torch_dtype(cfg.dtype)), lay)
    enc = pp.layers(params, "encoder")
    with etp.activation(lay):
        for i in range(len(enc)):
            h, _, _ = _run(_dense_block, cfg, _at(enc, i), h, cfg,
                           causal=False)
    return etp.full_seq(rmsnorm(h, pp.whole(params, "enc_norm"),
                                cfg.norm_eps), lay)


def forward_hidden(params: Dict[str, Any], tokens: torch.Tensor,
                   cfg: ModelConfig, *,
                   frontend: Optional[torch.Tensor] = None,
                   collect_cache: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor,
                              Optional[Dict[str, Any]]]:
    """:func:`forward` up to the final norm: (hidden (B, S, D), aux_loss,
    caches|None).  On a mesh (``launch.mesh.set_mesh``) every rank takes
    the global inputs, keeps its batch rows (``explicit_tp``'s rank
    model), runs the blocks in the residual layout and hands back its
    rows' hidden states over the whole sequence, and their caches."""
    require_family(cfg)
    if frontend is None and cfg.family in ("encdec", "vlm"):
        raise ValueError(f"the {cfg.family} family needs frontend "
                         f"embeddings (B, {cfg.frontend_tokens}, "
                         f"{cfg.d_model})")
    compute = torch_dtype(cfg.dtype)
    lay = etp.layout_for(tokens.shape[0], tokens.shape[1], cfg)
    x = pp.embed(params, etp.local_rows(tokens, lay)).to(compute)
    x = etp.to_layout(x, lay)
    with etp.activation(lay):
        x, aux, caches = _blocks(params, x, cfg, frontend, collect_cache)
    x = etp.full_seq(rmsnorm(x, pp.whole(params, "final_norm"),
                             cfg.norm_eps), lay)
    return x, aux, caches if collect_cache else None


def _blocks(params, x, cfg, frontend, collect_cache):
    """Every block of the stack on the embedded stream x: (x, aux,
    caches).  Each block is handed a call to ``placed.layers`` for its
    weights (:func:`_run`): on a placed tree one layer is gathered at a
    time, inside the block's checkpoint, and dropped when its block
    returns (the hybrid's shared block once an application)."""
    compute = torch_dtype(cfg.dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = pp.layers(params, "layers")
    caches: Dict[str, Any] = {}
    if cfg.family in ("dense", "moe", "vlm"):
        img = None if cfg.family != "vlm" else etp.local_rows(
            frontend, etp.current_layout()).to(compute)
        cross = [] if img is None else pp.layers(params, "cross_layers")
        kvs = []
        for i in range(len(layers)):
            if img is not None and i % cfg.cross_attn_every == 0:
                x = _run(_cross_block, cfg,
                         _at(cross, i // cfg.cross_attn_every), x, cfg,
                         img=img)
            x, aux_l, kv = _run(_dense_block, cfg, _at(layers, i), x, cfg,
                                collect_kv=collect_cache)
            aux = aux + aux_l
            kvs.append(kv)
        if collect_cache:
            caches["self"] = _stack(kvs)
    elif cfg.family == "encdec":
        enc = encode(params, frontend, cfg)
        kvs = []
        for i in range(len(layers)):
            x, kv = _run(_decoder_block, cfg, _at(layers, i), x, cfg,
                         enc=enc, collect_kv=collect_cache)
            kvs.append(kv)
        if collect_cache:
            caches["self"] = _stack(kvs)
            caches["enc_out"] = enc
    else:
        ssm_caches, shared_kv = [], []
        for i in range(len(layers)):
            x, c = _run(_ssm_block, cfg, _at(layers, i), x, cfg,
                        collect_cache=collect_cache)
            ssm_caches.append(c)
            if shared_after(cfg, i) is not None:
                x, kv = _run(_shared_block, cfg,
                             lambda: pp.whole(params, "shared"), x, cfg,
                             collect_kv=collect_cache)
                shared_kv.append(kv)
        if collect_cache:
            caches["ssm"] = _stack(ssm_caches)
            if shared_kv:
                caches["shared"] = _stack(shared_kv)
    return x, aux, caches


def forward(params: Dict[str, Any], tokens: torch.Tensor, cfg: ModelConfig,
            *, frontend: Optional[torch.Tensor] = None,
            collect_cache: bool = False,
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict[str, Any]]]:
    """tokens: (B, S) int -> (logits (B, S, V) fp32, aux_loss, caches|None).

    ``frontend`` feeds the stubbed modality input: encdec (B, F, D) audio
    frames, vlm (B, F, D) image patch embeddings; the other families
    ignore it.  With ``collect_cache`` the caches are, for the
    attention families, ``{"self": {"k", "v"}}`` of rotated K / V, ``(L,
    B, S, kv_dim)`` each, and for encdec also ``{"enc_out": (B, F, D)}``;
    for ssm/hybrid ``{"ssm": {"conv" (L, B, k-1, conv_dim), "state" (L,
    B, H, N, P)}}`` in fp32, and for the hybrid also ``{"shared": {"k",
    "v"}}`` ``(n_groups, B, S, kv_dim)``.  On a mesh every rank returns
    the global logits (gathered over the batch axes) and its own rows'
    caches."""
    params = pp.on_mesh(params, cfg)
    x, aux, caches = forward_hidden(params, tokens, cfg, frontend=frontend,
                                    collect_cache=collect_cache)
    lay = etp.layout_for(tokens.shape[0], tokens.shape[1], cfg)
    return (etp.gather_rows(logits_from_hidden(params, x, cfg), lay), aux,
            caches)


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
