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
the kernels, or raises.  It returns ``(y, h_final)``.  ``launches``
counts calls that launched the kernels: one call is three kernel
launches (the chunk states, the carry and the chunk outputs; the carry
alone when L is 0).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from . import _build, ref
from ..core.hopper import H100
from .stt_gemm import _no_backward, _on_cpu, _stream

#: the kernels' limits: chunk length and state width
MAX_CHUNK, MAX_STATE = 64, 128
#: the most heads that share one C B^T in the chunk-output kernel
HEAD_BLOCK = 4

#: calls that launched the kernels since the last ``reset_launches``
launches = {"ssd_scan": 0}


def reset_launches() -> None:
    launches["ssd_scan"] = 0


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


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int = 64
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD: x (B, L, H, P), dt (B, L, H), a (H,), b/c (B, L, G, N)
    with H % G == 0 and L % chunk == 0.

    Returns (y (B, L, H, P) in x's dtype, h_final (B, H, N, P) fp32).
    On the card the kernels run in fp32 with ``chunk`` at most 64 and N
    at most 128; fp32 operands are read where they lie (x, b and c with
    a unit innermost stride, b and c with equal strides; others are
    copied), other types are converted first and y converted back.
    """
    _check(x, dt, a, b, c, chunk)
    if _on_cpu(x, dt, a, b, c):
        return ref.ssd_chunked_ref(x, dt, a, b, c, chunk=chunk)
    _no_backward("the SSD scan", "the ssm/hybrid training slice (the SSD "
                 "backward)", x, dt, a, b, c)
    if len({x.device, dt.device, a.device, b.device, c.device}) != 1:
        raise ValueError(f"operands on {x.device}, {dt.device}, {a.device}, "
                         f"{b.device}, {c.device}")
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if chunk > MAX_CHUNK or not 1 <= n <= MAX_STATE:
        raise ValueError(f"the SSD kernel takes chunks up to {MAX_CHUNK} "
                         f"and state widths 1..{MAX_STATE}, got chunk "
                         f"{chunk}, N {n}")
    f32 = torch.float32
    xf, dtf, bf, cf = (t.to(f32) for t in (x, dt, b, c))
    af = a.to(f32).contiguous()
    if xf.stride(3) != 1:
        xf = xf.contiguous()
    if bf.stride() != cf.stride() or bf.stride(3) != 1:
        bf, cf = bf.contiguous(), cf.contiguous()
    y = torch.empty((bsz, l, h, p), dtype=f32, device=x.device)
    state = torch.empty((bsz, h, n, p), dtype=f32, device=x.device)
    if bsz == 0 or h == 0 or p == 0:
        return y.to(x.dtype), state
    plan = launch_plan(bsz, l, h, g, n, p, chunk)
    scratch = torch.empty(plan.scratch, dtype=f32, device=x.device)
    lib = _build.library("ssd_scan")
    _build.check(lib.ssd_scan_launch(
        xf.data_ptr(), _strides(xf), dtf.data_ptr(), _strides(dtf),
        af.data_ptr(), bf.data_ptr(), cf.data_ptr(), _strides(bf),
        y.data_ptr(), state.data_ptr(), scratch.data_ptr(), bsz, l, h, g,
        n, p, chunk, plan.head_block, _stream()), "ssd_scan_launch")
    launches["ssd_scan"] += 1
    return y.to(x.dtype), state            # no copy for fp32 x
