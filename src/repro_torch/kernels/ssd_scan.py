"""Mamba-2 SSD chunked scan — the port of the reference's
``kernels/ssd_scan.py``.

The SSD recurrence ``h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t^T``,
``y_t = C_t . h_t`` is computed chunk by chunk: a quadratic
(attention-like) intra-chunk term, plus the inter-chunk state carried
from one chunk to the next.  The reference's TPU kernel runs the chunks
as its sequential grid axis with the (N, P) state in VMEM scratch.  The
CUDA source (``csrc/ssd_scan.cu``) runs the chunk-parallel form that
``ref.ssd_chunked_ref`` writes in PyTorch, as three launches: the chunk
states (one CTA a chunk and head), the carry over chunks (the only
sequential walk, writing each chunk's entering state over its chunk
state in scratch, and the final state as a second output: the models'
prefill hands it to the decode cache), and the chunk outputs (one CTA a
chunk, group and block of heads, forming ``C B^T`` once for the block).
B and C are read at the head's group: no repeat to heads is made.

Layout: the kernels read the models' ``(B, L, H, P)`` operands where
they lie, through their strides (the models pass views of one
projection), where the reference's wrapper flattens (B, H) into one
axis first; the arithmetic is the same per (batch, head) sequence.

:func:`ssd_scan` takes the models' operands, runs the plain
``ref.ssd_chunked_ref`` on a CPU tensor, and on a CUDA tensor launches
the kernels, or raises.  It returns ``(y, h_final)``.  While autograd
records and an input requires grad, a call on the card goes through
:class:`SSDScanFn`, whose backward is a kernel too
(:func:`ssd_scan_backward`, four launches: the chunks' state gradients,
the reverse carry over chunks, the chunks' gradients, and the fixed-order
sums over a group's blocks of heads and over chunks, laid out by
:func:`backward_plan`; the reference differentiates its XLA scan
instead).  The forward's scratch, which ends holding every
chunk's entering state, is what the backward reads: the Function saves
it, so remat (``torch.utils.checkpoint``) recomputes it with the layer.
``ssd_scan_backward_plain`` writes the same chunked formulas in PyTorch.
``launches`` counts calls that launched the kernels: ``ssd_scan`` one
forward call (three kernel launches: the chunk states, the carry and the
chunk outputs; the carry alone when L is 0), ``ssd_scan_backward`` one
backward call.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build, ref
from ..core.hopper import H100
from .stt_gemm import _on_cpu, _stream, meta_launch

#: the kernels' limits: chunk length and state width
MAX_CHUNK, MAX_STATE = 64, 128
#: the most heads that share one C B^T in the chunk-output kernel, and
#: one CTA of the backward's chunk kernels
HEAD_BLOCK = 4
#: the backward chunk kernels' shared-memory layout, as
#: ``csrc/ssd_scan.cu`` defines it: the longest chunk, the row stride of
#: its 64-wide tiles, the per-head vectors of the chunk kernel, the warps
#: of a CTA
_QMAX, _TS, _VEC, _WARPS = 64, 68, 8, 8

#: calls that launched the kernels since the last ``reset_launches``
launches = {"ssd_scan": 0, "ssd_scan_backward": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def cost(bsz: int, length: int, heads: int, groups: int, state: int,
         head_dim: int, chunk: int, *, backward: bool = False,
         final: bool = False) -> Tuple[float, float]:
    """(operations, bytes) of one call in fp32, the counts behind the
    kernels' bounds (``csrc/ssd_scan.cu``'s note).

    Forward: per chunk C B^T's lower triangle once per group, Q(Q+1)/2 N
    multiply-adds; per head its masked product with x, Q(Q+1)/2 P, and
    the inter-chunk term and the state update, Q N P each; one multiply
    an element of x and of dt (dt scaling, dt * a).  Bytes: x, dt, a, y,
    B and C per group and the final state, each once.

    Backward: per chunk and head the two lower-triangle products with P,
    Q(Q+1)/2 2P multiply-adds, and four Q N P products; per chunk and
    group the three with N (C B^T, dC's and dB's terms of the heads'
    summed dCB); an element's dt scaling of dx and ``a`` scaling of ddt.
    Bytes: x, dy, dt, B, C, a, the forward's entering states and decays
    (and with ``final`` the final state's gradient), each once, and dx,
    ddt, dB, dC, da."""
    h, p, gr, n = heads, head_dim, groups, state
    q, nc = chunk, length // chunk
    tri = q * (q + 1) // 2
    if backward:
        macs = bsz * nc * (3 * gr * tri * n + h * (2 * tri * p
                                                   + 4 * q * n * p))
        elems = bsz * length * h * (p + 1)
        nbytes = 4.0 * (bsz * (3 * length * h * p + 2 * length * h
                               + 4 * length * gr * n
                               + nc * h * (n * p + 1)
                               + (h * n * p if final else 0))
                        + 2 * h)
        return 2.0 * macs + elems, nbytes
    macs = bsz * nc * (gr * tri * n + h * (tri * p + 2 * q * n * p))
    prep = bsz * length * h * (p + 1)
    nbytes = 4.0 * (bsz * (2 * length * h * p + length * h
                           + 2 * length * gr * n + h * n * p) + h)
    return 2.0 * macs + prep, nbytes


class Plan(NamedTuple):
    """One call's launch plan: chunks, heads per C B^T, scratch floats
    (the chunk states (B, nc, H, N, P), then the decays (B, nc, H))."""
    n_chunks: int
    head_block: int
    scratch: int


def launch_plan(bsz: int, length: int, heads: int, groups: int, state: int,
                head_dim: int, chunk: int) -> Plan:
    """The largest head block (``HEAD_BLOCK`` halved) whose chunk-output
    grid, ``n_chunks x groups x batch x ceil(heads per group / block)``,
    still gives every SM a CTA, or 1."""
    nc = length // chunk
    per_group = heads // groups
    hb = HEAD_BLOCK
    while hb > 1 and nc * groups * bsz * -(-per_group // hb) < H100.sms:
        hb //= 2
    return Plan(nc, hb, bsz * nc * heads * (state * head_dim + 1))


class BackwardPlan(NamedTuple):
    """The backward's launch plan.  ``head_block`` heads of a group share
    a CTA of the two chunk kernels (S_c and the chunk's gradients), whose
    grid is ``grid`` (chunks, groups x ``blocks``, batch); shared bytes
    of each a CTA, and CTAs an SM by shared memory (the launch bounds
    let registers hold 2); ``work`` floats of scratch: the chunks' state
    gradients (B, nc, H, N, P), their da terms (B, nc, H) rounded up to a
    multiple of 4, and where a group has more than one block the blocks'
    dB and dC (B, L, G x blocks, N) each."""
    n_chunks: int
    head_block: int
    blocks: int
    grid: Tuple[int, int, int]
    dstate_smem: int
    chunk_smem: int
    ctas_per_sm: int
    work: int


def _bwd_smem(state: int) -> Tuple[int, int]:
    """Shared bytes of the S_c kernel and of the chunk kernel at state
    width ``state`` (``dstate_smem``/``bwd_smem`` of the source)."""
    nr = 1 if state <= 64 else 2
    ns = 64 * nr + 4
    wide = max(64 * nr * _TS, _QMAX * ns)
    dstate = _QMAX * ns + _QMAX * _TS + HEAD_BLOCK * _QMAX
    chunk = 2 * wide + 2 * _QMAX * _TS + HEAD_BLOCK * (_VEC * _QMAX
                                                         + _WARPS)
    return 4 * dstate, 4 * chunk


def backward_plan(bsz: int, length: int, heads: int, groups: int,
                  state: int, head_dim: int, chunk: int,
                  head_block: Optional[int] = None) -> BackwardPlan:
    """The largest head block of ``HEAD_BLOCK``, halved, whose chunk
    grid, ``n_chunks x groups x ceil(heads per group / block) x batch``,
    still gives every SM a CTA, or 1 (the forward's rule);
    ``head_block`` (1..``HEAD_BLOCK``) overrides it."""
    nc = length // chunk
    per_group = heads // groups
    hb = HEAD_BLOCK if head_block is None else head_block
    if not 1 <= hb <= HEAD_BLOCK:
        raise ValueError(f"head_block {hb} outside 1..{HEAD_BLOCK}")
    while head_block is None and hb > 1 and \
            nc * groups * bsz * -(-per_group // hb) < H100.sms:
        hb //= 2
    blocks = -(-per_group // hb)
    dstate, chunk_bytes = _bwd_smem(state)
    ctas = min(8, H100.smem_per_sm_bytes // (
        chunk_bytes + H100.smem_reserved_per_block))
    terms = -(-bsz * nc * heads // 4) * 4
    partials = 2 * bsz * length * groups * blocks * state if blocks > 1 \
        else 0
    return BackwardPlan(nc, hb, blocks, (nc, groups * blocks, bsz), dstate,
                        chunk_bytes, ctas,
                        bsz * nc * heads * state * head_dim + terms
                        + partials)


def _check(x, dt, a, b, c, chunk) -> None:
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or b.dim() != 4 \
            or c.shape != b.shape:
        raise ValueError(f"ssd_scan takes x (B, L, H, P), dt (B, L, H), "
                         f"a (H,) and b, c (B, L, G, N), got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    bsz, l, h, _ = x.shape
    if (tuple(dt.shape) != (bsz, l, h) or tuple(a.shape) != (h,)
            or tuple(b.shape[:2]) != (bsz, l)):
        raise ValueError(f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"a {tuple(a.shape)} and b {tuple(b.shape)} "
                         f"disagree on (B, L, H)")
    if h % b.shape[2]:
        raise ValueError(f"heads {h} not divisible by groups {b.shape[2]}")
    if chunk < 1 or l % chunk:
        raise ValueError(f"L={l} not divisible by chunk={chunk}")


def _strides(x: torch.Tensor):
    return (ctypes.c_longlong * 3)(x.stride(0), x.stride(1), x.stride(2))


def _operands(x, dt, a, b, c):
    """fp32 operands as the kernels read them: x, b and c with a unit
    innermost stride, b and c with equal strides (others are copied)."""
    f32 = torch.float32
    xf, dtf, bf, cf = (t.to(f32) for t in (x, dt, b, c))
    af = a.to(f32).contiguous()
    if xf.stride(3) != 1:
        xf = xf.contiguous()
    if bf.stride() != cf.stride() or bf.stride(3) != 1:
        bf, cf = bf.contiguous(), cf.contiguous()
    return xf, dtf, af, bf, cf


def _check_card(x, dt, a, b, c, chunk) -> None:
    if len({x.device, dt.device, a.device, b.device, c.device}) != 1:
        raise ValueError(f"operands on {x.device}, {dt.device}, {a.device}, "
                         f"{b.device}, {c.device}")
    n = b.shape[3]
    if chunk > MAX_CHUNK or not 1 <= n <= MAX_STATE:
        raise ValueError(f"the SSD kernel takes chunks up to {MAX_CHUNK} "
                         f"and state widths 1..{MAX_STATE}, got chunk "
                         f"{chunk}, N {n}")


def _forward(x, dt, a, b, c, chunk):
    """The forward kernels on CUDA tensors: (y fp32, h_final, the scratch
    (every chunk's entering state, then the chunks' decays), the fp32
    operands as the kernels read them)."""
    _check_card(x, dt, a, b, c, chunk)
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    ops = _operands(x, dt, a, b, c)
    xf, dtf, af, bf, cf = ops
    f32 = torch.float32
    y = torch.empty((bsz, l, h, p), dtype=f32, device=x.device)
    state = torch.empty((bsz, h, n, p), dtype=f32, device=x.device)
    plan = launch_plan(bsz, l, h, g, n, p, chunk)
    scratch = torch.empty(plan.scratch, dtype=f32, device=x.device)
    if bsz == 0 or h == 0 or p == 0:
        return y, state, scratch, ops
    if x.is_meta:
        meta_launch(launches, "ssd_scan", *cost(bsz, l, h, g, n, p, chunk))
        return y, state, scratch, ops
    lib = _build.library("ssd_scan")
    _build.check(lib.ssd_scan_launch(
        xf.data_ptr(), _strides(xf), dtf.data_ptr(), _strides(dtf),
        af.data_ptr(), bf.data_ptr(), cf.data_ptr(), _strides(bf),
        y.data_ptr(), state.data_ptr(), scratch.data_ptr(), bsz, l, h, g,
        n, p, chunk, plan.head_block, _stream()), "ssd_scan_launch")
    launches["ssd_scan"] += 1
    return y, state, scratch, ops


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int = 64
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD: x (B, L, H, P), dt (B, L, H), a (H,), b/c (B, L, G, N)
    with H % G == 0 and L % chunk == 0.

    Returns (y (B, L, H, P) in x's dtype, h_final (B, H, N, P) fp32).
    On the card the kernels run in fp32 with ``chunk`` at most 64 and N
    at most 128; fp32 operands are read where they lie (x, b and c with
    a unit innermost stride, b and c with equal strides; others are
    copied), other types are converted first and y converted back.  On
    the card, while autograd records and an input requires grad, the
    call goes through :class:`SSDScanFn`.
    """
    _check(x, dt, a, b, c, chunk)
    if _on_cpu(x, dt, a, b, c):
        return ref.ssd_chunked_ref(x, dt, a, b, c, chunk=chunk)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, a, b, c)):
        return SSDScanFn.apply(x, dt, a, b, c, chunk)
    y, state, _, _ = _forward(x, dt, a, b, c, chunk)
    return y.to(x.dtype), state            # no copy for fp32 x


def _backward(xf, dtf, af, bf, cf, dy, dh_final, scratch, chunk):
    """The backward kernels on the fp32 operands the forward read and its
    scratch, laid out by :func:`backward_plan`: (dx, ddt, da, db, dc)
    fp32, contiguous."""
    bsz, l, h, p = xf.shape
    g, n = bf.shape[2], bf.shape[3]
    if tuple(dy.shape) != (bsz, l, h, p):
        raise ValueError(f"dy {tuple(dy.shape)} must have x's shape "
                         f"{(bsz, l, h, p)}")
    if dh_final is not None and tuple(dh_final.shape) != (bsz, h, n, p):
        raise ValueError(f"dh_final {tuple(dh_final.shape)} must be "
                         f"(B, H, N, P) = {(bsz, h, n, p)}")
    plan = launch_plan(bsz, l, h, g, n, p, chunk)
    if scratch.dtype != torch.float32 or scratch.numel() != plan.scratch:
        raise ValueError(f"the forward's scratch must hold {plan.scratch} "
                         f"fp32, got {scratch.numel()} {scratch.dtype}")
    f32, dev = torch.float32, xf.device
    dy = dy.to(f32).contiguous()
    if dh_final is not None:
        dh_final = dh_final.to(f32).contiguous()
    dx = torch.empty((bsz, l, h, p), dtype=f32, device=dev)
    ddt = torch.empty((bsz, l, h), dtype=f32, device=dev)
    da = torch.zeros((h,), dtype=f32, device=dev)
    db = torch.empty((bsz, l, g, n), dtype=f32, device=dev)
    dc = torch.empty((bsz, l, g, n), dtype=f32, device=dev)
    if bsz == 0 or h == 0 or p == 0:
        # y is empty: nothing depends on the inputs
        return dx, ddt.zero_(), da, db.zero_(), dc.zero_()
    bplan = backward_plan(bsz, l, h, g, n, p, chunk)
    work = torch.empty(bplan.work, dtype=f32, device=dev)
    if xf.is_meta:
        meta_launch(launches, "ssd_scan_backward", *cost(
            bsz, l, h, g, n, p, chunk, backward=True,
            final=dh_final is not None))
        return dx, ddt, da, db, dc
    lib = _build.library("ssd_scan")
    _build.check(lib.ssd_scan_backward_launch(
        xf.data_ptr(), _strides(xf), dtf.data_ptr(), _strides(dtf),
        af.data_ptr(), bf.data_ptr(), cf.data_ptr(), _strides(bf),
        dy.data_ptr(), None if dh_final is None else dh_final.data_ptr(),
        scratch.data_ptr(), dx.data_ptr(), ddt.data_ptr(), da.data_ptr(),
        db.data_ptr(), dc.data_ptr(), work.data_ptr(), bsz, l, h, g, n, p,
        chunk, bplan.head_block, _stream()), "ssd_scan_backward_launch")
    launches["ssd_scan_backward"] += 1
    return dx, ddt, da, db, dc


def _as_inputs(grads, dtypes):
    return tuple(gr.to(d) for gr, d in zip(grads, dtypes))


def ssd_scan_backward(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
                      dh_final: Optional[torch.Tensor] = None, *,
                      chunk: int = 64, scratch: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, ...]:
    """The gradients (dx, ddt, da, db, dc) of :func:`ssd_scan` at (x, dt,
    a, b, c), given dy (B, L, H, P), the gradient of y, and ``dh_final``
    (B, H, N, P), that of the final state (None: zero).  Each comes back
    in its input's dtype.  On the card four kernel launches, reading
    ``scratch``, the forward's scratch of these operands (None: the
    forward kernels run first to make it), laid out by
    :func:`backward_plan`; on the CPU :func:`ssd_scan_backward_plain`."""
    _check(x, dt, a, b, c, chunk)
    if _on_cpu(x, dt, a, b, c, dy):
        return ssd_scan_backward_plain(x, dt, a, b, c, dy, dh_final,
                                       chunk=chunk)
    _check_card(x, dt, a, b, c, chunk)
    if scratch is None:
        _, _, scratch, ops = _forward(x, dt, a, b, c, chunk)
    else:
        ops = _operands(x, dt, a, b, c)
    return _as_inputs(_backward(*ops, dy, dh_final, scratch, chunk),
                      (x.dtype, dt.dtype, a.dtype, b.dtype, c.dtype))


def ssd_scan_backward_plain(x: torch.Tensor, dt: torch.Tensor,
                            a: torch.Tensor, b: torch.Tensor,
                            c: torch.Tensor, dy: torch.Tensor,
                            dh_final: Optional[torch.Tensor] = None, *,
                            chunk: int = 64) -> Tuple[torch.Tensor, ...]:
    """The backward kernels' arithmetic in PyTorch: the chunked formulas
    of ``csrc/ssd_scan.cu``'s note, vectorized over chunks, with the
    forward and the reverse carries as loops over chunks.  Computes in
    the wider of fp32 and x's dtype; returns (dx, ddt, da, db, dc), each
    in its input's dtype."""
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep, q = h // g, chunk
    nc = l // q
    f = torch.promote_types(x.dtype, torch.float32)
    dtc = dt.to(f).reshape(bsz, nc, q, h)
    af = a.to(f)
    xc = x.to(f).reshape(bsz, nc, q, h, p)
    xd = xc * dtc[..., None]
    bc, cc = (t.to(f).repeat_interleave(rep, dim=2).reshape(bsz, nc, q, h, n)
              for t in (b, c))
    dyc = dy.to(f).reshape(bsz, nc, q, h, p)

    li = torch.cumsum(dtc * af, dim=2).permute(0, 1, 3, 2)   # (B,nc,H,Q)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    dmat = li[..., :, None] - li[..., None, :]
    m = torch.where(tri, torch.exp(torch.where(tri, dmat, 0.0)), 0.0)
    w = torch.einsum("bcihn,bcjhn->bchij", cc, bc) * m
    last = li[..., -1]                                         # (B,nc,H)
    decay = torch.exp(last)
    el = torch.exp(li).permute(0, 1, 3, 2)                     # (B,nc,Q,H)
    er = torch.exp(last[..., None] - li).permute(0, 1, 3, 2)

    # the forward carry (each chunk's entering state) and the reverse one
    # (the gradient of each chunk's leaving state)
    chunk_state = torch.einsum("bcjhn,bcjhp->bchnp", bc * er[..., None], xd)
    s_c = torch.einsum("bcihn,bcihp->bchnp", cc * el[..., None], dyc)
    hcur = xd.new_zeros((bsz, h, n, p))
    dcur = (xd.new_zeros((bsz, h, n, p)) if dh_final is None
            else dh_final.to(f))
    h_in, d_out = [], [None] * nc
    for ci in range(nc):
        h_in.append(hcur)
        hcur = decay[:, ci, :, None, None] * hcur + chunk_state[:, ci]
    for ci in reversed(range(nc)):
        d_out[ci] = dcur
        dcur = decay[:, ci, :, None, None] * dcur + s_c[:, ci]
    h_in = torch.stack(h_in, dim=1) if nc else xd.new_zeros(
        (bsz, 0, h, n, p))
    d_out = torch.stack(d_out, dim=1) if nc else h_in

    dw = torch.einsum("bcihp,bcjhp->bchij", dyc, xd) * tri
    dxd = (torch.einsum("bchij,bcihp->bcjhp", w, dyc)
           + er[..., None] * torch.einsum("bcjhn,bchnp->bcjhp", bc, d_out))
    t = dw * w
    dcb = dw * m
    dlc = t.sum(-1) - t.sum(-2)                                # (B,nc,H,Q)
    dc_inter = el[..., None] * torch.einsum("bchnp,bcihp->bcihn", h_in, dyc)
    dlc = dlc + torch.einsum("bcihn,bcihn->bchi", cc, dc_inter)
    dcc = dc_inter + torch.einsum("bchij,bcjhn->bcihn", dcb, bc)
    db_state = er[..., None] * torch.einsum("bchnp,bcjhp->bcjhn", d_out, xd)
    u = torch.einsum("bcjhn,bcjhn->bchj", bc, db_state)
    dbc = db_state + torch.einsum("bchij,bcihn->bcjhn", dcb, cc)
    extra = decay * (h_in * d_out).sum((-1, -2)) + u.sum(-1)  # at Q - 1
    dlc = dlc - u
    dlc = torch.cat([dlc[..., :-1], dlc[..., -1:] + extra[..., None]], -1)
    dda = torch.flip(torch.cumsum(torch.flip(dlc, (-1,)), -1), (-1,))
    dda = dda.permute(0, 1, 3, 2)                              # (B,nc,Q,H)

    dx = (dxd * dtc[..., None]).reshape(bsz, l, h, p)
    ddt = ((xc * dxd).sum(-1) + dda * af).reshape(bsz, l, h)
    da = (dda * dtc).sum((0, 1, 2))
    db_ = dbc.reshape(bsz, l, g, rep, n).sum(3)
    dc_ = dcc.reshape(bsz, l, g, rep, n).sum(3)
    return _as_inputs((dx, ddt, da, db_, dc_),
                      (x.dtype, dt.dtype, a.dtype, b.dtype, c.dtype))


class SSDScanFn(torch.autograd.Function):
    """The SSD scan with a hand-written backward: the forward kernels
    keep their scratch (each chunk's entering state, the decays) beside
    the fp32 operands, and the backward launches the backward kernels on
    them.  A gradient that does not reach the final state (the models'
    training) passes None: it is zero.  On CPU tensors both halves run
    their plain versions."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, chunk):
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        ctx.dtypes = (x.dtype, dt.dtype, a.dtype, b.dtype, c.dtype)
        if _on_cpu(x, dt, a, b, c):
            y, state = ref.ssd_chunked_ref(x, dt, a, b, c, chunk=chunk)
            ctx.save_for_backward(x, dt, a, b, c)
            return y, state
        y, state, scratch, ops = _forward(x, dt, a, b, c, chunk)
        ctx.save_for_backward(*ops, scratch)
        return y.to(x.dtype), state

    @staticmethod
    def backward(ctx, dy, dstate):
        saved = ctx.saved_tensors
        x = saved[0]
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        if len(saved) == 5:
            grads = ssd_scan_backward_plain(*saved, dy, dstate,
                                            chunk=ctx.chunk)
        else:
            grads = _backward(*saved[:5], dy, dstate, saved[5], ctx.chunk)
        return (*_as_inputs(grads, ctx.dtypes), None)
