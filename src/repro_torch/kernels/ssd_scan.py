"""Mamba-2 SSD chunked scan — the port of the reference's
``kernels/ssd_scan.py``.

The SSD recurrence ``h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t^T``,
``y_t = C_t . h_t`` is computed chunk by chunk: a quadratic
(attention-like) intra-chunk term, plus the inter-chunk state carried
from one chunk to the next.  The reference's TPU kernel runs the chunks
as its sequential grid axis with the (N, P) state in VMEM scratch.  The
CUDA kernel (``csrc/ssd_scan.cu``) gives one CTA each (batch, head,
16-column slice of P), loops over the chunks inside the CTA with the
state slice in shared memory, reads B and C at the head's group (no
repeat to heads is made) and writes the final state as a second output:
the models' prefill hands it to the decode cache.

Layout: the kernel takes the models' ``(B, L, H, P)`` layout as it is,
where the reference's wrapper flattens (B, H) into one axis first; the
arithmetic is the same per (batch, head) sequence.

:func:`ssd_scan` takes the models' operands, runs the plain
``ref.ssd_chunked_ref`` on a CPU tensor, and on a CUDA tensor does the
reference wrapper's prep (dt folded into x, the log decays ``dt * a``)
and launches the kernel, or raises.  It returns ``(y, h_final)``.
``launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build, ref
from .stt_gemm import _on_cpu, _stream

#: the kernel's limits: chunk length and state width
MAX_CHUNK, MAX_STATE = 64, 128

#: kernel launches since the last ``reset_launches``
launches = {"ssd_scan": 0}


def reset_launches() -> None:
    launches["ssd_scan"] = 0


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


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int = 64
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD: x (B, L, H, P), dt (B, L, H), a (H,), b/c (B, L, G, N)
    with H % G == 0 and L % chunk == 0.

    Returns (y (B, L, H, P) in x's dtype, h_final (B, H, N, P) fp32).
    On the card dt is folded into x and the log decays ``dt * a`` are
    formed, as the reference's wrapper does, and the kernel runs in fp32
    with ``chunk`` at most 64 and N at most 128.
    """
    _check(x, dt, a, b, c, chunk)
    if _on_cpu(x, dt, a, b, c):
        return ref.ssd_chunked_ref(x, dt, a, b, c, chunk=chunk)
    if len({x.device, dt.device, a.device, b.device, c.device}) != 1:
        raise ValueError(f"operands on {x.device}, {dt.device}, {a.device}, "
                         f"{b.device}, {c.device}")
    f32 = torch.float32
    xdt = (x.to(f32) * dt.to(f32)[..., None]).contiguous()
    da = (dt.to(f32) * a.to(f32)).contiguous()
    b, c = b.to(f32).contiguous(), c.to(f32).contiguous()
    bsz, l, h, p = xdt.shape
    g, n = b.shape[2], b.shape[3]
    if chunk > MAX_CHUNK or not 1 <= n <= MAX_STATE:
        raise ValueError(f"the SSD kernel takes chunks up to {MAX_CHUNK} "
                         f"and state widths 1..{MAX_STATE}, got chunk "
                         f"{chunk}, N {n}")
    y = torch.empty((bsz, l, h, p), dtype=f32, device=x.device)
    state = torch.empty((bsz, h, n, p), dtype=f32, device=x.device)
    if bsz == 0 or h == 0 or p == 0:
        return y.to(x.dtype), state.zero_()
    lib = _build.library("ssd_scan")
    _build.check(lib.ssd_scan_launch(
        xdt.data_ptr(), da.data_ptr(), b.data_ptr(), c.data_ptr(),
        y.data_ptr(), state.data_ptr(), bsz, l, h, g, n, p, chunk,
        _stream()), "ssd_scan_launch")
    launches["ssd_scan"] += 1
    return y.to(x.dtype), state
