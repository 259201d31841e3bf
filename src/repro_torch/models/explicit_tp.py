"""Explicit (STT-scheduled) collectives for the transformer hot paths.

The port of the reference's ``models/explicit_tp.py``.  There, GSPMD
partitions the model and these helpers are ``shard_map`` islands whose
collectives are written out: the three schedules the classification
picks for the LM stack,

  * ``gather_seq``          — SP -> TP boundary: all-gather of the
                              sequence shards (multicast dataflow),
  * ``project_scatter``     — TP -> SP boundary: local partial dot +
                              reduce-scatter (reduction tree, scattered),
  * ``chunked_attn_manual`` — attention with q/out sharded over query
                              rows and K/V multicast (replicated),

and the fused ``mlp_manual`` / ``qkv_manual`` / ``moe_manual``.  Each
returns None where the manual layout does not apply, with the
reference's conditions: no mesh (or no layout) or a ``model`` axis of 1,
an activation that is not 3-D, a global sequence, ``d_ff`` or head
column count that the ``model`` axis does not divide, or a global batch
that the batch axes (``pod`` x ``data``) do not divide.  Each casts to
the compute dtype before it gathers and reduces its partials in that
dtype, as the reference's wire does.

**The rank model.**  The reference leaves every resharding to GSPMD; here
one process is one mesh position (``launch.mesh.set_mesh``; ranks from
``dist.spawn``) and the layout is explicit.  Departures from the
reference, all declared:

* every rank receives the global inputs and keeps its **batch rows** where
  the batch axes divide the batch (:func:`local_rows`), else all of them;
* the residual stream is **sequence-sharded** over ``model`` exactly where
  the reference's ``_residual_shard`` shards it (``sequence_parallel``
  and the sequence divisible), else whole; a :class:`Layout` records
  which, one per activation stream (the encoder's frames have their own),
  and the model entry points publish it (:func:`activation`);
* a rank **holds its blocks of the parameters** as the cells'
  ``param_shardings`` place them (``models.placed``) and computes on
  its ``model`` block of each: serving gathers each layer's weights over
  the batch axes just before the layer runs, each leaf keeping the
  rank's ``model`` block, and drops them after it (``train.trainer``'s
  sharded step the same, inside the layer's remat checkpoint, and sums
  the layer's gradient partials over the batch axes onto the rank's
  blocks in its backward: ``placed.GatherLeaf``); a whole tree on the
  mesh takes the same route, its blocks views (``placed.on_mesh``).
  The SSM mixer alone is gathered whole over ``model`` (declared,
  ``placed.WHOLE_OVER_MODEL``);
* q, k and v are the rank's ``heads`` / ``kv`` columns (:func:`span`
  gives each block's place), the MLP's and the experts' products its
  ``d_ff`` columns, the logits its vocab block; each row-parallel
  product (``wo``, ``wd``, the experts' ``wd`` after the gate-weighted
  combine) is reduced over ``model`` once (:func:`row_parallel`):
  reduce-scattered onto the sequence shard where the layout splits the
  sequence, else all-reduced; in fp32 with explicit collectives off (the
  reference constrains the raw fp32 dot output), in the compute dtype
  with them on, as ``project_scatter`` does.  A dim the divisibility
  fallback replicates is whole and no reduction runs;
* the helpers take activations **as the reference's ``in_specs`` hand
  them to the ``shard_map`` body** — the rank's sequence shard of ``x``
  (whole where the layout keeps it whole: the gather is then the rank's
  own data), the column block of ``h`` — and the rank's **weight
  blocks**; their checks read the global extents from ``cfg``;
  ``chunked_attn_manual`` takes every query row and keeps its block;
* where a helper returns None under a mesh the model gathers the
  sequence and computes on the same blocks; decode (``Lq == 1``) is
  always that case;
* K and V are gathered back over ``model`` where attention needs whole
  kv heads (the reference's ``shard(k, ..., None, None)``): a rank may
  hold part of a kv head's columns; q is gathered back where the rank's
  columns do not hold whole heads of its own;
* attention runs on the rank's q heads where ``n_heads`` divides the
  ``model`` axis, on its query rows otherwise (``ops.attention`` /
  ``flash_attention`` with ``q_offset`` on the card), and on its query
  rows through ``chunked_attn_manual`` above ``FULL_SCORES_MAX_LEN``;
* the logits are the rank's vocab block; serving gathers them over the
  vocab axes and over the batch axes, so every rank returns the global
  logits, and the train step takes the loss on the block
  (``train.trainer.rank_loss``);
* caches hold the rank's batch rows and, over ``model``, the feature block
  ``launch.specs.cache_shardings`` places (:func:`feature_block`: the K/V
  columns, the SSM conv channels and state heads; a leaf whose feature
  extent ``model`` does not divide stays whole, ``_fit``'s fallback).
  Decode computes the new token's q, k and v on the rank's blocks, so
  its K/V columns are its cache block (a kv head split by the block is
  gathered for rope and cut again), scores on them per kv head and sums
  a head's partial scores over the ranks that share it where a block
  splits one (:func:`sum_head_partials`); the heads' output columns and
  the SSM block's conv output and ``y`` are gathered back over
  ``model``;
* reduce-scatter is ``RankMesh.reduce_scatter``:
  ``dist.reduce_scatter_tensor`` on NCCL axes and one ``all_reduce``
  followed by the rank's slice on gloo axes (gloo's reduce-scatter
  differs across PyTorch releases); which one follows the axis group's
  backend (in a fake world, the backend it stands for), never a failure;
* the MoE's aux loss is averaged over the batch axes only, as the
  reference's ``moe_manual`` averages it; the model's fallback MoE
  averages each of its terms over the batch axes, which gives the
  global loss the reference's auto-partitioned path computes.

The collectives are ``torch.autograd.Function``\\ s over ``RankMesh``
axes: the all-gather's backward is a reduce-scatter and the
reduce-scatter's an all-gather.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from ..launch.mesh import current_mesh
from ..kernels.stt_gemm import _fp32_product

#: the mesh axes the batch shards over (major to minor) and the model axis
BATCH_AXES = ("pod", "data")
MODEL = "model"


# ---------------------------------------------------------------------------
# the mesh and the layout
# ---------------------------------------------------------------------------

def _mesh_info():
    """(mesh, batch axes, model axis size); (None, (), 1) without one."""
    mesh = current_mesh()
    if mesh is None or not mesh.axes:
        return None, (), 1
    batch_axes = tuple(a for a in BATCH_AXES if a in mesh.sizes)
    return mesh, batch_axes, mesh.sizes.get(MODEL, 1)


def _batch_shards(mesh, batch_axes) -> int:
    return math.prod(mesh.sizes[a] for a in batch_axes)


def _batch_ok(b: int, batch_axes, mesh) -> bool:
    n = _batch_shards(mesh, batch_axes)
    return b % n == 0 if n > 1 else True


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where this rank's block of a ``(B, S, ...)`` activation sits: the
    global batch and sequence, and whether the rank holds its sequence
    shard over ``model`` (else the whole sequence).  Its batch rows are
    the rank's block wherever the batch axes divide ``batch``."""

    batch: int
    seq: int
    seq_split: bool


def layout_for(b: int, s: int, cfg) -> Optional[Layout]:
    """The residual layout of a global ``(b, s)`` stream under the current
    mesh, or None when no mesh splits anything (no mesh, or neither a
    ``model`` axis above 1 nor batch axes above 1)."""
    mesh, bd, m = _mesh_info()
    if mesh is None or (m <= 1 and _batch_shards(mesh, bd) <= 1):
        return None
    return Layout(b, s, bool(cfg.sequence_parallel and m > 1
                             and s % m == 0))


#: each thread's stack of published layouts (a serving thread's prefill
#: and another's decode step each see their own stream)
_LAYOUTS = threading.local()


@contextlib.contextmanager
def activation(lay: Optional[Layout]) -> Iterator[None]:
    """Publish ``lay`` as the layout of the stream the model blocks run on
    in this thread for the ``with`` block (nested blocks for the encoder's
    frames)."""
    stack = _LAYOUTS.__dict__.setdefault("stack", [])
    stack.append(lay)
    try:
        yield
    finally:
        stack.pop()


def current_layout() -> Optional[Layout]:
    """This thread's innermost published layout; None outside every
    block."""
    stack = getattr(_LAYOUTS, "stack", None)
    return stack[-1] if stack else None


def model_size() -> int:
    return _mesh_info()[2]


def model_index() -> int:
    mesh = current_mesh()
    return mesh.coord[MODEL] if mesh is not None and MODEL in mesh.coord \
        else 0


def _block(t: torch.Tensor, dim: int, index: int, count: int
           ) -> torch.Tensor:
    step = t.shape[dim] // count
    return t.narrow(dim, index * step, step)


def model_block(t: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` over ``model`` (a view;
    ``t`` itself off a model axis)."""
    m = model_size()
    return t if m <= 1 else _block(t, dim, model_index(), m)


def feature_block(n: int) -> Optional[Tuple[int, int]]:
    """This rank's ``[start, stop)`` of a cache leaf's feature dim of
    extent ``n`` over ``model``, where ``launch.specs.cache_shardings``
    puts ``model`` on it; None (the leaf stays whole) off a ``model`` axis
    above 1 or where ``model`` does not divide ``n`` (``_fit``'s
    fallback)."""
    m = model_size()
    if m <= 1 or n % m:
        return None
    step = n // m
    i = model_index()
    return i * step, (i + 1) * step


def feature_copy(t: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's :func:`feature_block` of ``t``'s ``dim`` as a
    contiguous **copy** (never a view that would keep the whole of ``t``
    alive); ``t`` itself where it stays whole."""
    blk = feature_block(t.shape[dim])
    if blk is None:
        return t
    return t.narrow(dim, blk[0], blk[1] - blk[0]).clone(
        memory_format=torch.contiguous_format)


def local_rows(t: Optional[torch.Tensor], lay: Optional[Layout]
               ) -> Optional[torch.Tensor]:
    """This rank's batch rows of a global ``(B, ...)`` input (all of them
    where the batch axes do not divide ``B``)."""
    if t is None or lay is None or t.dim() == 0:
        return t
    mesh, bd, _ = _mesh_info()
    n = _batch_shards(mesh, bd)
    if n <= 1 or lay.batch % n:
        return t
    idx, _ = mesh.shard_of(bd)
    return _block(t, 0, idx, n)


def gather_rows(t: torch.Tensor, lay: Optional[Layout]) -> torch.Tensor:
    """The global ``(B, ...)`` from every rank's batch rows (the logits at
    the end of the forward)."""
    if lay is None:
        return t
    mesh, bd, _ = _mesh_info()
    n = _batch_shards(mesh, bd)
    if n <= 1 or lay.batch % n:
        return t
    for a in reversed(bd):
        if mesh.sizes[a] > 1:
            t = _AllGather.apply(t, mesh, a, 0)
    return t


def full_seq(x: torch.Tensor, lay: Optional[Layout]) -> torch.Tensor:
    """The whole sequence (dim 1) of a stream held in ``lay``: the
    model's gather where a helper declined."""
    if lay is None or not lay.seq_split:
        return x
    return _AllGather.apply(x, current_mesh(), MODEL, 1)


def to_layout(x: torch.Tensor, lay: Optional[Layout]) -> torch.Tensor:
    """Back from the whole sequence to the stream's layout: the rank's
    sequence shard where ``lay`` splits it."""
    if lay is None or not lay.seq_split:
        return x
    return model_block(x, 1)


def gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Concatenate the ranks' blocks of ``x`` along ``dim`` over
    ``model``."""
    if model_size() <= 1:
        return x
    return _AllGather.apply(x, current_mesh(), MODEL, dim)


def sum_head_partials(part: torch.Tensor, dh: int, n: int
                      ) -> torch.Tensor:
    """The sum over ``model`` of ``part`` (B, h, ...): this rank's
    partials of the ``h`` heads of ``dh`` columns that its
    :func:`feature_block` of ``n`` columns touches.  Each head's partials
    are exchanged with the ranks whose blocks touch that head, and with no
    other rank (``RankMesh.exchange``: point to point, the ranks that
    share a head rather than the whole axis).  Each head's terms are then
    summed in rank order, so every rank that shares a head gets the same
    sum.  Forward only (decode)."""
    mesh, m, i = current_mesh(), model_size(), model_index()
    w = n // m

    def heads(r):
        return r * w // dh, ((r + 1) * w - 1) // dh + 1
    h0, h1 = heads(i)
    shared = {}
    for j in range(m):
        lo, hi = max(heads(j)[0], h0), min(heads(j)[1], h1)
        if j != i and lo < hi:
            shared[j] = (lo, hi)
    got = mesh.exchange({j: part[:, lo - h0:hi - h0]
                         for j, (lo, hi) in shared.items()}, MODEL)
    got[i], shared[i] = part, (h0, h1)
    out = []
    for h in range(h0, h1):
        terms = [got[j][:, h - shared[j][0]] for j in sorted(got)
                 if shared[j][0] <= h < shared[j][1]]
        acc = terms[0]
        for t in terms[1:]:
            acc = acc + t
        out.append(acc)
    return torch.stack(out, dim=1)


def psum_batch(x: torch.Tensor) -> torch.Tensor:
    """Sum over the batch axes (a no-op without them)."""
    mesh, bd, _ = _mesh_info()
    axes = tuple(a for a in bd if mesh.sizes[a] > 1)
    return _AllReduce.apply(x, mesh, axes) if axes else x


def batch_shards() -> int:
    mesh, bd, _ = _mesh_info()
    return 1 if mesh is None else _batch_shards(mesh, bd)


def span(p, name: str):
    """The ``placed.Span`` of leaf ``name`` of a layer ``p`` as
    ``models.placed`` hands it, where the leaf is the rank's ``model``
    block; None where it is whole (a plain dict's leaves are)."""
    spans = getattr(p, "spans", None)
    return None if spans is None else spans.get(name)


def reduce_model(part: torch.Tensor, lay: Optional[Layout]) -> torch.Tensor:
    """The sum over ``model`` of a row-parallel product's partials:
    reduce-scattered onto the rank's sequence shard (dim 1) where ``lay``
    splits the sequence, else all-reduced."""
    mesh = current_mesh()
    if lay is not None and lay.seq_split:
        return _ReduceScatter.apply(part, mesh, MODEL, 1)
    return _AllReduce.apply(part, mesh, (MODEL,))


def row_parallel(h: torch.Tensor, w: torch.Tensor, explicit: bool,
                 lay: Optional[Layout]) -> torch.Tensor:
    """``h``'s column block times ``w``'s row block, reduced over
    ``model`` once (:func:`reduce_model`): the fp32 product and an fp32
    sum (explicit collectives off: the reference's raw fp32 dot output),
    or the product in ``h``'s dtype and the sum in it (on)."""
    part = torch.matmul(h, w) if explicit else _fp32_product(h, w)
    return reduce_model(part, lay)


# ---------------------------------------------------------------------------
# the collectives, differentiable
# ---------------------------------------------------------------------------

class _AllGather(torch.autograd.Function):
    """Tiled all-gather along ``dim`` over one axis; backward:
    reduce-scatter."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.reduce_scatter(g, ctx.axis, ctx.dim), None, None,
                None)


class _ReduceScatter(torch.autograd.Function):
    """Sum over one axis, scattered along ``dim``; backward: all-gather."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.reduce_scatter(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g, ctx.axis, ctx.dim), None, None, None


class _AllReduce(torch.autograd.Function):
    """Sum over ``axes``; backward: the same sum of the cotangents."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return mesh.psum(x, axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.psum(g, ctx.axes), None, None


# ---------------------------------------------------------------------------
# the helpers
# ---------------------------------------------------------------------------

def _manual(x_ndim: int, lay: Optional[Layout], *extents: int):
    """The mesh when the manual layout applies (the reference's checks on
    the global extents), else None."""
    mesh, bd, m = _mesh_info()
    if mesh is None or lay is None or m <= 1 or x_ndim != 3:
        return None
    if lay.seq % m or any(e % m for e in extents):
        return None
    if not _batch_ok(lay.batch, bd, mesh):
        return None
    return mesh


def _gathered(x: torch.Tensor, lay: Layout, mesh) -> torch.Tensor:
    """The whole sequence of ``x`` (the rank's shard where ``lay`` splits
    it, else already whole)."""
    return _AllGather.apply(x, mesh, MODEL, 1) if lay.seq_split else x


def gather_seq(x: torch.Tensor, lay: Optional[Layout]
               ) -> Optional[torch.Tensor]:
    """(B, S@model, D) -> (B, S, D) by an explicit all-gather (``x`` in the
    wire dtype the caller cast it to); None if the manual layout does not
    apply here."""
    mesh = _manual(x.dim(), lay)
    if mesh is None:
        return None
    return _gathered(x, lay, mesh)


def project_scatter(h: torch.Tensor, w: torch.Tensor,
                    lay: Optional[Layout], rows: int
                    ) -> Optional[torch.Tensor]:
    """h's column block (B, S, F/m) @ w's row block (F/m, D) -> (B,
    S@model, D): the local partial product (fp32 accumulation), cast to
    h's dtype, reduce-scattered over ``model`` along the sequence.
    ``rows``: the global ``F`` (``cfg.q_dim`` or ``cfg.d_ff``).  The
    reference's helper; the models reduce through :func:`row_parallel`,
    which is this product and sum wherever the layout splits the
    sequence."""
    mesh = _manual(h.dim(), lay, rows)
    if mesh is None:
        return None
    part = torch.matmul(h, w)
    return _ReduceScatter.apply(part.to(h.dtype), mesh, MODEL, 1)


def mlp_manual(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
               wd: torch.Tensor, compute: torch.dtype,
               lay: Optional[Layout], cfg) -> Optional[torch.Tensor]:
    """The whole SwiGLU MLP as one manual dataflow: all-gather(x over the
    sequence, in ``compute``) -> the rank's ``d_ff`` block of wg/wu,
    silu (fp32), its rows of wd -> reduce-scatter of the partial output
    (in ``compute``) back to sequence shards.  Weights: the rank's
    blocks; ``cfg.d_ff`` the global extent."""
    mesh = _manual(x.dim(), lay, cfg.d_ff)
    if mesh is None:
        return None
    xf = _gathered(x.to(compute), lay, mesh)
    g = xf @ wg.to(compute)
    u = xf @ wu.to(compute)
    h = F.silu(g.to(torch.float32)).to(compute) * u
    part = torch.matmul(h, wd.to(compute))
    return _ReduceScatter.apply(part.to(compute), mesh, MODEL, 1)


def qkv_manual(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
               wv: torch.Tensor, compute: torch.dtype,
               lay: Optional[Layout], cfg
               ) -> Optional[Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]]:
    """Gather(x over the sequence) + the q/k/v projections in one manual
    dataflow: each the rank's column block over ``model`` (the caller
    gathers the small K/V back).  Weights: the rank's blocks;
    ``cfg.q_dim`` / ``cfg.kv_dim`` the global extents."""
    mesh = _manual(x.dim(), lay, cfg.q_dim, cfg.kv_dim)
    if mesh is None:
        return None
    xf = _gathered(x.to(compute), lay, mesh)
    return tuple(xf @ w.to(compute) for w in (wq, wk, wv))


def moe_manual(x: torch.Tensor, p, cfg, compute: torch.dtype,
               lay: Optional[Layout]
               ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """The whole MoE layer as one manual dataflow: gather(x over the
    sequence) -> the router, top-k and capacity dispatch on the rank's
    batch rows (``mlp._dispatch``) -> the expert products on the rank's
    ``d_ff`` block -> the gate-weighted combine (fp32) -> one
    reduce-scatter (in ``compute``) that sums the ``d_ff`` partials and
    scatters back to sequence shards.  The aux loss is averaged over the
    batch axes only.  Expert weights: the rank's ``d_ff`` blocks (the
    router whole); ``cfg.d_ff`` the global extent."""
    mesh = _manual(x.dim(), lay, cfg.d_ff)
    if mesh is None:
        return None
    from .mlp import combine, expert_inputs, route, router_aux
    xf = _gathered(x.to(compute), lay, mesh)
    b, s, d = xf.shape
    logits, probs, gates, top_idx = route(p, xf, cfg)
    aux = router_aux(logits, probs, top_idx, cfg)
    n = batch_shards()
    if n > 1:
        aux = psum_batch(aux) / n
    xin, keep, my_pos, cap = expert_inputs(xf, top_idx, cfg, compute)
    e = cfg.n_experts
    h = F.silu((xin @ p["wg"].to(compute)).to(torch.float32)).to(compute)
    h = h * (xin @ p["wu"].to(compute))
    out_e = (h @ p["wd"].to(compute)).reshape(e, b, cap, d)
    out = combine(out_e, top_idx, gates, keep, my_pos, cap)
    return _ReduceScatter.apply(out.to(compute), mesh, MODEL, 1), aux


def chunked_attn_manual(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, window: Optional[int],
                        lay: Optional[Layout], bkv: int = 1024
                        ) -> Optional[torch.Tensor]:
    """Online-softmax attention with q/out sharded over query rows on
    ``model`` and K/V multicast (whole on every rank).  ``q`` (B, H, Lq,
    dh) holds every query row; the rank keeps rows ``[off, off + Lq/m)``
    and masks them as positions ``off + i`` (the flash kernel's
    ``q_offset`` on the card, the plain online softmax in kv blocks of
    ``bkv`` on the CPU).  Returns the rank's rows."""
    mesh, bd, m = _mesh_info()
    if mesh is None or lay is None or m <= 1:
        return None
    lq, lkv = q.shape[2], k.shape[2]
    if lq % m or lq // m < 1 or not _batch_ok(lay.batch, bd, mesh):
        return None
    if lkv % bkv:
        bkv = next((bb for bb in (512, 256, 128, 64, 1) if lkv % bb == 0), 1)
    from ..kernels import flash_attention as fa
    from ..kernels.stt_gemm import on_card
    rows = lq // m
    off = model_index() * rows
    q_rows = model_block(q, 2)
    if on_card(q_rows, k, v):
        return fa.flash_attention(q_rows, k, v, causal=causal, window=window,
                                  q_offset=off)
    return fa.flash_attention_plain(q_rows, k, v, causal=causal,
                                    window=window, bkv=bkv, q_offset=off)
