"""Attention layers: GQA + RoPE + SWA + cross-attention + KV caches.

The port of the reference's ``models/attention.py``.  Three execution
paths:

* prefill on a CUDA tensor: the hand-written flash-attention kernel
  (``csrc/flash_attention.cu``), which the reference names its TPU
  hot-spot implementation — causal attention through
  ``kernels.ops.attention`` (which pads to whole blocks as the
  reference's wrapper does), non-causal attention (an encoder, or
  cross-attention to a frontend's ``Lkv`` tokens) through
  ``flash_attention.flash_attention`` itself, which masks a ragged
  ``Lkv`` (1500 frames, 1601 patches) where zero-padded keys would take
  part in the softmax;
* prefill on a CPU tensor: the plain full-scores path (``ref.
  attention_ref``) up to ``FULL_SCORES_MAX_LEN`` and the chunked
  online-softmax path above it, as the reference's models run them;
* decode: a single query over a (possibly rolling) KV cache, plain
  PyTorch on every device (the reference's is plain XLA too).

Decode writes the new K/V row into the given cache tensors **in place**
(the reference returns updated copies); the returned cache holds the
same tensors.  Cross-attention (``kv_x``) takes its K/V from the
frontend's tokens with no rope and no mask; in decode a **static** cross
cache (``precompute_cross_cache``, bf16 whatever the compute dtype) is
read whole and never written.

With ``cfg.explicit_collectives`` the reference's manual branches run
first (``explicit_tp.qkv_manual``, ``gather_seq``,
``chunked_attn_manual``); with no mesh each returns None and the block
is the one-device one, bit for bit.  On a mesh (``launch.mesh.set_mesh``)
x and the result are in the stream's layout, and a layer handed by
``models.placed`` holds the rank's ``model`` blocks: q, k and v are its
columns, K/V are gathered back to whole kv heads, a prefill attends on
the rank's q heads or query rows and the output projection is its
columns times its ``wo`` rows, reduced over ``model`` once
(``explicit_tp``'s rank model).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..compile.pipeline import torch_dtype
from ..configs.base import ModelConfig
from ..kernels import flash_attention as fa
from ..kernels import ops, ref
from ..kernels.stt_gemm import on_card
from . import common
from . import explicit_tp as etp
from .common import stacked_dense_init

#: a K/V cache or collected K/V: {"k": ..., "v": ...}
KV = Dict[str, torch.Tensor]

NEG_INF = float(-1e30)
FULL_SCORES_MAX_LEN = 8_192   # above this, the CPU uses the chunked path


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig, n_layers: int
                   ) -> Dict[str, torch.Tensor]:
    """Stacked attention params for ``n_layers`` layers."""
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = {
        "wq": stacked_dense_init(gen, n_layers, d, qd),
        "wk": stacked_dense_init(gen, n_layers, d, kvd),
        "wv": stacked_dense_init(gen, n_layers, d, kvd),
        "wo": stacked_dense_init(gen, n_layers, qd, d),
    }
    if cfg.qkv_bias:
        p["bq"] = common.zeros_init(gen, (n_layers, qd))
        p["bk"] = common.zeros_init(gen, (n_layers, kvd))
        p["bv"] = common.zeros_init(gen, (n_layers, kvd))
    return p


def attention_axes(cfg: ModelConfig, n_layers: Optional[int]
                   ) -> Dict[str, common.Logical]:
    """The logical axes of :func:`init_attention`'s leaves (one layer's
    when ``n_layers`` is None), the reference's."""
    st = common.stacked
    p = {"wq": st(n_layers, "embed", "heads"),
         "wk": st(n_layers, "embed", "kv"),
         "wv": st(n_layers, "embed", "kv"),
         "wo": st(n_layers, "heads", "embed")}
    if cfg.qkv_bias:
        p.update(bq=st(n_layers, "heads"), bk=st(n_layers, "kv"),
                 bv=st(n_layers, "kv"))
    return p


# ---------------------------------------------------------------------------
# Score paths
# ---------------------------------------------------------------------------

def _full_scores_attn(q, k, v, *, causal, window, q_offset=0):
    """(B, H, Lq, dh) x (B, Hkv, Lkv, dh); materializes (Lq, Lkv) scores."""
    return ref.attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)


def _chunked_attn(q, k, v, *, causal, window, q_offset=0, bkv: int = 1024):
    """Online softmax over kv chunks of ``bkv`` — O(Lq * bkv) memory: the
    flash kernel's plain version, which is this computation."""
    return fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    bkv=bkv, q_offset=q_offset)


def _decode_valid(pos, s: int, window, cache_len: int, device
                  ) -> torch.Tensor:
    """The slots of an ``s``-slot cache that a decode query at ``pos``
    attends to, shaped to broadcast over (B, heads, group, S) scores.

    With a rolling (SWA) cache the entries are position-tagged modulo the
    cache length, so validity is derived from absolute positions.  ``pos``
    may be an int (one shared position, the classic batched decode) or a
    ``(B,)`` tensor (per-slot positions, continuous batching): the masks
    vectorize over the batch."""
    slots = torch.arange(s, device=device)
    pos_t = torch.as_tensor(pos, device=device)
    if pos_t.dim():
        pos_b, slots = pos_t[:, None], slots[None, :]    # (B, 1) x (1, S)
    else:
        pos_b = pos_t
    if window is None:
        valid = slots <= pos_b                           # linear cache
    elif cache_len > window:
        valid = (slots <= pos_b) & (slots > pos_b - window)  # linear + SWA
    else:
        # rolling cache: slot holds absolute position p iff p = pos - ((pos -
        # slot) mod S); valid iff within window and <= pos (always true once
        # warm).  Entries beyond pos when cold (pos < S) are invalid.
        abs_pos = pos_b - ((pos_b - slots) % s)
        valid = (abs_pos >= 0) & (abs_pos > pos_b - window)
    return (valid[:, None, None, :] if pos_t.dim()
            else valid[None, None, None, :])


def _decode_attn(q, k_cache, v_cache, *, pos, window, cache_len):
    """q: (B, Hq, 1, dh); caches (B, Hkv, S, dh); attend to entries < pos+1
    (:func:`_decode_valid`); each row computes exactly what it would with
    that row's scalar position.  The q heads of one kv head are
    multiplied as a group against that head (the reference repeats the
    kv heads first; the products are the same).
    """
    b, hq, _, dh = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    scale = 1.0 / (dh ** 0.5)
    kf = k_cache.to(torch.float32)
    vf = v_cache.to(torch.float32)
    qg = (q.to(torch.float32) * scale).reshape(b, hkv, group, dh)
    scores = torch.matmul(qg, kf.transpose(-1, -2))     # (B, Hkv, group, S)
    valid = _decode_valid(pos, s, window, cache_len, q.device)
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.matmul(p, vf).reshape(b, hq, 1, dh)
    return out.to(q.dtype)


def _placed_decode_attn(q, k_blk, v_blk, cols: Tuple[int, int], hkv: int,
                        *, pos, window, cache_len):
    """:func:`_decode_attn` on a cache placed over ``model``: ``k_blk`` /
    ``v_blk`` (B, S, w) hold the rank's columns ``cols = [c0, c1)`` of the
    (B, S, kv_dim) cache (``explicit_tp.feature_block``); q (B, Hq, 1, dh)
    is whole, of ``hkv`` kv heads.  Where ``w`` is whole heads the rank
    runs :func:`_decode_attn` on its kv heads and their q heads, one
    card's computation on them.  Else each kv head the block touches
    scores on the rank's columns of it (part of one head, or across a
    head boundary), each head's partial scores are summed over the ranks
    that share it before the softmax (``explicit_tp.sum_head_partials``),
    and ``P · V_block`` gives the rank's columns of each q head's output.
    Either way the rank's part of the output is gathered over ``model``
    into head order.  Returns (B, Hq,
    1, dh)."""
    b, hq, _, dh = q.shape
    c0, c1 = cols
    w, s = c1 - c0, k_blk.shape[1]
    group = hq // hkv
    h0, h1 = c0 // dh, (c1 - 1) // dh + 1               # heads touched
    if w % dh == 0:
        def heads(t):
            return t.reshape(b, s, h1 - h0, dh).transpose(1, 2)
        out = _decode_attn(q[:, h0 * group:h1 * group], heads(k_blk),
                           heads(v_blk), pos=pos, window=window,
                           cache_len=cache_len)
        return etp.gather_model(out, 1)
    scale = 1.0 / (dh ** 0.5)
    kf = k_blk.to(torch.float32)
    vf = v_blk.to(torch.float32)
    # q in the cache's column order: column h·dh + j of group member g is
    # q head h·group + g, dim j
    qc = (q.to(torch.float32) * scale).reshape(b, hkv, group, dh).transpose(
        1, 2).reshape(b, group, hkv * dh)[:, :, c0:c1]
    spans = [(max(c0, h * dh) - c0, min(c1, (h + 1) * dh) - c0)
             for h in range(h0, h1)]
    scores = torch.stack([torch.matmul(qc[..., a:z],
                                       kf[..., a:z].transpose(-1, -2))
                          for a, z in spans], dim=1)    # (B, nh, group, S)
    # a head's columns lie on several ranks: sum its partial scores over
    # them
    scores = etp.sum_head_partials(scores, dh, hkv * dh)
    valid = _decode_valid(pos, s, window, cache_len, q.device)
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.cat([torch.matmul(p[:, i], vf[..., a:z])
                     for i, (a, z) in enumerate(spans)], dim=-1)
    out = etp.gather_model(out.to(q.dtype), 2)          # (B, group, kv_dim)
    return out.reshape(b, group, hkv, dh).transpose(1, 2).reshape(
        b, hq, 1, dh)


# ---------------------------------------------------------------------------
# Block apply
# ---------------------------------------------------------------------------

def make_kv_cache(cfg: ModelConfig, batch: int, seq_len: int,
                  dtype=torch.bfloat16, device=None
                  ) -> Dict[str, torch.Tensor]:
    """Rolling cache for SWA archs (window slots), linear otherwise."""
    s = seq_len if cfg.swa_window is None else min(seq_len, cfg.swa_window)
    shape = (batch, s, cfg.kv_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _positions(pos, b: int, lq: int, device) -> torch.Tensor:
    if pos is None:
        return torch.arange(lq, device=device)
    pos_t = torch.as_tensor(pos, device=device).to(torch.int32)
    if pos_t.dim():
        # per-slot positions (continuous batching): (B, lq) rope
        return pos_t[:, None].expand(b, lq)
    return pos_t.reshape(1).expand(lq)


def apply_attention(p: Dict[str, torch.Tensor], x: torch.Tensor,
                    cfg: ModelConfig, *,
                    kv_x: Optional[torch.Tensor] = None,
                    causal: bool = True,
                    positions: Optional[torch.Tensor] = None,
                    cache: Optional[KV] = None,
                    pos=None,
                    collect_kv: bool = False,
                    ) -> Tuple[torch.Tensor, Optional[KV]]:
    """One attention block on per-layer (already unstacked) params.

    x: (B, Lq, D).  Self-attention when ``kv_x`` is None, else
    cross-attention to ``kv_x`` (B, Lkv, D): no rope, no window, not
    causal.  With ``cache`` and self-attention (decode): Lq == 1, the new
    K/V row is written into the cache in place at ``pos`` (an int, or a
    ``(B,)`` tensor of per-slot positions) and attention runs over the
    cache.  With ``cache`` and ``kv_x`` (decode against a static cross
    cache, ``kv_x`` only marks the block as cross): the cache is
    attended in full and left as it is.  With ``collect_kv`` (prefill)
    the rotated K / V come back as ``(B, Lq, kv_dim)``.  Returns (out,
    cache_or_None).
    """
    b, lq, _ = x.shape
    is_self = kv_x is None
    static_cross = cache is not None and not is_self
    compute = torch_dtype(cfg.dtype)
    lay = etp.current_layout()

    def heads(t, n):
        return t.reshape(b, -1, n, cfg.head_dim).transpose(1, 2)

    sq, sk = etp.span(p, "wq"), etp.span(p, "wk")
    q = k = v = None
    if cfg.explicit_collectives and is_self and not static_cross:
        # fully-manual SP -> TP dataflow: gather + q/k/v dots in one
        res = etp.qkv_manual(x, p["wq"], p["wk"], p["wv"], compute, lay, cfg)
        if res is not None:
            q, k, v = res
    if q is None:
        # SP -> TP boundary: gather the compute-dtype sequence shards
        xq = x.to(compute)
        gathered = (etp.gather_seq(xq, lay) if cfg.explicit_collectives
                    else None)
        xq = gathered if gathered is not None else etp.full_seq(xq, lay)
        q = xq @ p["wq"].to(compute)
        if not static_cross:
            xkv = xq if is_self else kv_x.to(compute)
            k = xkv @ p["wk"].to(compute)
            v = xkv @ p["wv"].to(compute)
    # q, k and v are the rank's columns where their weights are blocks
    # (the biases are the same blocks)
    if cfg.qkv_bias:
        q = q + p["bq"].to(compute)
        if not static_cross:
            k, v = k + p["bk"].to(compute), v + p["bv"].to(compute)
    lq = q.shape[1]
    if is_self and positions is None:
        positions = _positions(pos, b, lq, x.device)

    def rotate(t):
        # rope on the (B, L, kv_dim) keys, by heads
        t = heads(t, cfg.n_kv_heads)
        return common.rope(t, positions, cfg.rope_theta) if is_self else t

    def from_cache(c):
        return c.reshape(b, c.shape[1], cfg.n_kv_heads, cfg.head_dim
                         ).transpose(1, 2).to(compute)

    # decode on a model mesh: the cache holds the rank's columns
    placed = None if cache is None else etp.feature_block(cfg.kv_dim)
    if placed is not None and cache["k"].shape[-1] != placed[1] - placed[0]:
        raise ValueError(
            f"decode on a model mesh takes the cache placed by "
            f"cache_shardings: {placed[1] - placed[0]} of {cfg.kv_dim} K/V "
            f"columns a rank, got {cache['k'].shape[-1]}")

    def flat(t):
        return t.transpose(1, 2).reshape(b, t.shape[2], -1)

    new_cache = None
    if cache is None and etp.model_size() > 1 and lay is not None:
        # prefill on a model axis: K/V gathered back to whole kv heads,
        # attention on this rank's heads or query rows
        kh = rotate(_whole_cols(k, sk))
        vh = heads(_whole_cols(v, sk), cfg.n_kv_heads)
        blk, full = _mesh_prefill(q, kh, vh, sq, cfg, positions, lay,
                                  causal=causal and is_self,
                                  window=cfg.swa_window if is_self else None,
                                  rope=is_self)
        kv = None
        if collect_kv:
            # the rank's cache columns, copied (a view would keep the
            # whole K / V alive in the cache)
            kv = {n: etp.feature_copy(flat(t), 2)
                  for n, t in (("k", kh), ("v", vh))}
        return _project_out(p, blk, full, cfg, lay, x.dtype), kv

    # one query (decode) or one device: q whole, by heads
    qh = heads(_whole_cols(q, sq), cfg.n_heads)   # (B, Hq, Lq, dh)
    if is_self:
        qh = common.rope(qh, positions, cfg.rope_theta)

    def attend_cache(ck, cv, pos, window, s_cache):
        if placed is not None:
            return _placed_decode_attn(qh, ck.to(compute), cv.to(compute),
                                       placed, cfg.n_kv_heads,
                                       pos=pos, window=window,
                                       cache_len=s_cache)
        return _decode_attn(qh, from_cache(ck), from_cache(cv), pos=pos,
                            window=window, cache_len=s_cache)

    if static_cross:
        # read-only precomputed cross K/V (e.g. whisper's encoder
        # output): non-causal attention over the whole cache
        s_cache = cache["k"].shape[1]
        out = attend_cache(cache["k"], cache["v"], s_cache - 1, None,
                           s_cache)
    elif cache is not None:
        ck, cv = cache["k"], cache["v"]
        s_cache = ck.shape[1]
        if placed is not None and sk is not None:
            # the rank's K/V columns are its cache block; keys rotate by
            # whole heads (a head the block splits is gathered and cut)
            v_flat = v
            dh = cfg.head_dim
            if sk.start % dh == 0 and (sk.stop - sk.start) % dh == 0:
                k_flat = flat(common.rope(
                    k.reshape(b, lq, -1, dh).transpose(1, 2), positions,
                    cfg.rope_theta))
            else:
                k_flat = flat(rotate(etp.gather_model(k, 2)))[
                    ..., sk.start:sk.stop]
        else:
            k_flat, v_flat = flat(rotate(k)), v
        pos_t = torch.as_tensor(pos)
        if pos_t.dim():
            # per-slot write positions: one row per batch lane
            slot = pos_t.to(device=x.device, dtype=torch.long) % s_cache
            rows = torch.arange(b, device=x.device)
            ck[rows, slot] = k_flat[:, 0].to(ck.dtype)
            cv[rows, slot] = v_flat[:, 0].to(cv.dtype)
        else:
            # the reference's dynamic_update_slice clamps the start so the
            # update fits
            slot = min(int(pos) % s_cache, s_cache - lq)
            ck[:, slot:slot + lq] = k_flat.to(ck.dtype)
            cv[:, slot:slot + lq] = v_flat.to(cv.dtype)
        new_cache = {"k": ck, "v": cv}
        # rope for cached keys is applied at write time (above); a rolling
        # cache stores *rotated* keys, which is fine because rope is
        # absolute-position — each key was rotated at its own position.
        out = attend_cache(ck, cv, pos, cfg.swa_window, s_cache)
    else:
        kh = rotate(_whole_cols(k, sk))
        vh = heads(_whole_cols(v, sk), cfg.n_kv_heads)
        out = _attend(qh, kh, vh, causal=causal and is_self,
                      window=cfg.swa_window if is_self else None)
        if collect_kv:
            new_cache = {n: etp.feature_copy(flat(t), 2)
                         for n, t in (("k", kh), ("v", vh))}

    out = out.transpose(1, 2).reshape(b, lq, cfg.q_dim)
    return _project_out(p, None, out, cfg, lay, x.dtype), new_cache


def _whole_cols(t: torch.Tensor, sp) -> torch.Tensor:
    """A (B, L, n) activation of a leaf's columns whole: gathered over
    ``model`` where ``sp`` (``explicit_tp.span``) says it is the rank's
    block."""
    return t if sp is None else etp.gather_model(t, 2)


def _attend(qh, kh, vh, *, causal, window, q_offset=0):
    """Prefill attention on the device's path
    (``kernels.stt_gemm.on_card``): the flash kernel on a CUDA tensor
    (causal through ``ops.attention``, which pads to whole blocks), the
    plain full-scores path on a CPU one up to ``FULL_SCORES_MAX_LEN`` and
    the chunked one above it; a ``meta`` tensor takes the path of the
    device it stands for.  q row i sits at ``q_offset + i``."""
    card = on_card(qh, kh, vh)
    if card and causal:
        return ops.attention(qh, kh, vh, causal=True, window=window,
                             q_offset=q_offset)
    if card:
        return fa.flash_attention(qh, kh, vh, causal=False, window=window,
                                  q_offset=q_offset)
    if kh.shape[2] <= FULL_SCORES_MAX_LEN:
        return _full_scores_attn(qh, kh, vh, causal=causal, window=window,
                                 q_offset=q_offset)
    return _chunked_attn(qh, kh, vh, causal=causal, window=window,
                         q_offset=q_offset)


def _mesh_prefill(q, kh, vh, sq, cfg: ModelConfig, positions, lay, *,
                  causal: bool, window, rope: bool):
    """Attention of one prefill on a ``model`` axis of ``m`` ranks, K/V
    whole (``kh``/``vh`` rotated).  ``q`` is (B, S, q_dim), or the rank's
    column block where ``sq`` (its ``placed.Span``) says so.  Above
    ``FULL_SCORES_MAX_LEN`` (explicit collectives) the rank takes its
    query rows through ``chunked_attn_manual``; else its q heads where
    ``n_heads % m == 0`` (its own columns, with their kv heads), its query
    rows where ``m`` divides the sequence (q gathered back: a block that
    splits a head, whisper's 12 heads on 16, holds no whole head), or
    everything.  Returns (the rank's column block of the (B, S, q_dim)
    output or None, a callable giving the whole output)."""
    b, s = q.shape[0], q.shape[1]
    m, idx = etp.model_size(), etp.model_index()
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def whole_q():
        return _whole_cols(q, sq)

    def qheads(t, n, pos):
        t = t.reshape(b, -1, n, dh).transpose(1, 2)
        return common.rope(t, pos, cfg.rope_theta) if rope else t

    rows = None
    if kh.shape[2] > FULL_SCORES_MAX_LEN and cfg.explicit_collectives:
        out = etp.chunked_attn_manual(qheads(whole_q(), hq, positions), kh,
                                      vh, causal=causal, window=window,
                                      lay=lay)
        if out is not None:
            rows = out
    if rows is None and hq % m == 0:
        hl = hq // m
        h0, group = idx * hl, hq // hkv
        qh = qheads(q if sq is not None else etp.model_block(q, 2), hl,
                    positions)
        if hl % group == 0:
            ks = kh[:, h0 // group:(h0 + hl) // group]
            vs = vh[:, h0 // group:(h0 + hl) // group]
        else:
            # the rank's q heads split a GQA group: give each its kv head
            ks = kh.repeat_interleave(group, dim=1)[:, h0:h0 + hl]
            vs = vh.repeat_interleave(group, dim=1)[:, h0:h0 + hl]
        out = _attend(qh, ks, vs, causal=causal, window=window)
        blk = out.transpose(1, 2).reshape(b, s, hl * dh)
        return blk, lambda: etp.gather_model(blk, 2)
    if rows is None and s % m == 0:
        n = s // m
        pos = (None if positions is None
               else positions[..., idx * n:(idx + 1) * n])
        rows = _attend(qheads(etp.model_block(whole_q(), 1), hq, pos), kh,
                       vh, causal=causal, window=window, q_offset=idx * n)
    if rows is not None:
        rows = rows.transpose(1, 2).reshape(b, -1, cfg.q_dim)
        return None, lambda: etp.gather_model(rows, 1)
    out = _attend(qheads(whole_q(), hq, positions), kh, vh, causal=causal,
                  window=window)
    return None, lambda: out.transpose(1, 2).reshape(b, s, cfg.q_dim)


def _project_out(p, blk, full, cfg: ModelConfig, lay, dtype):
    """The output projection.  Where ``wo`` is the rank's row block: the
    rank's output columns (``blk``, else cut from the whole output) times
    it, reduced over ``model`` once (``explicit_tp.row_parallel``).
    Where ``wo`` is whole: the whole product in the stream's layout.
    ``full`` is the (B, S, q_dim) output or a callable giving it."""
    wo = p["wo"].to(torch_dtype(cfg.dtype))
    so = etp.span(p, "wo")
    if so is None:
        full = full() if callable(full) else full
        return etp.to_layout((full @ wo).to(dtype), lay)
    if blk is None:
        full = full() if callable(full) else full
        blk = full[..., so.start:so.stop]
    return etp.row_parallel(blk, wo, cfg.explicit_collectives, lay).to(dtype)


def precompute_cross_cache(p: Dict[str, torch.Tensor], enc_out: torch.Tensor,
                           cfg: ModelConfig, dtype=torch.bfloat16) -> KV:
    """Project the frontend's tokens (an encoder's output, image patch
    embeddings) to K/V once, ``(B, F, kv_dim)`` in ``dtype`` (bf16
    whatever the compute dtype, as in the reference); decode steps read
    it statically.  On a model mesh the rank's cache columns
    (``explicit_tp.feature_block``): the product of its ``wk`` / ``wv``
    blocks."""
    compute = torch_dtype(cfg.dtype)
    xkv = enc_out.to(compute)
    k = xkv @ p["wk"].to(compute)
    v = xkv @ p["wv"].to(compute)
    if cfg.qkv_bias:
        k = k + p["bk"].to(compute)
        v = v + p["bv"].to(compute)
    return {"k": k.to(dtype), "v": v.to(dtype)}
