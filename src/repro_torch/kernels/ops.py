"""Public wrappers for the GEMM templates, the block-sparse GEMM,
attention and the Mamba-2 SSD.

The port of the reference's ``kernels/ops.py``: padding to block
multiples, the accumulation policy, template dispatch from an STT
``KernelPlan``, the strip-budget fallback, ``bsr_matmul`` with its
rhs-by-transposition and ``attention`` with its padding — the same
decisions in the same order.  There is no ``jit``; the device decides:
on the CPU the kernels run their plain versions, on the card they
launch their CUDA kernels.  ``attention(backend="xla")`` and
``ssd(backend="xla")`` keep the reference's name for their plain oracle
routes.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..core.plan import KernelPlan
from . import bsr_gemm as _bsr
from . import epilogue as _ep
from . import flash_attention as _fa
from . import ref as _ref
from . import ssd_scan as _ssd
from . import stt_gemm as _gemm


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    card.  With no device given and no card present this raises — it
    never drops to the CPU silently."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run the templates' plain versions")
    return torch.device("cuda")


def _pad_to(x: torch.Tensor, mults: tuple) -> torch.Tensor:
    pads = [(-d) % m for d, m in zip(x.shape, mults)]
    if any(pads):
        # F.pad lists (left, right) pairs from the last dim backwards
        flat = []
        for p in reversed(pads):
            flat += [0, p]
        x = F.pad(x, flat)
    return x


def resolve_accum(accum: str, out_dtype) -> str:
    """The accumulation-strategy policy: ``"auto"`` picks the numerically
    safe default — fp32 scratch accumulation — for *every* dtype; callers
    can force ``"inplace"`` (running sum rounded to the output dtype
    every k-step)."""
    if accum == "auto":
        return "scratch"
    if accum not in _gemm.ACCUM_MODES:
        raise ValueError(f"accum must be 'auto' or one of "
                         f"{_gemm.ACCUM_MODES}, got {accum!r}")
    return accum


def _rt_order(grid_order: str) -> str:
    """Project a 3-axis grid order onto the reduction-tree's (m, n) grid
    (its whole reduction runs in one pass, so 'k' drops out)."""
    if grid_order == "default":
        return "mn"
    order = "".join(c for c in grid_order if c in "mn")
    return order if order in _gemm.RT_GRID_ORDERS else "mn"


def stt_matmul(a: torch.Tensor, b: torch.Tensor, *,
               template: str = "output_stationary",
               stationary: str = "B", bm: int = 128, bn: int = 128,
               bk: int = 128,
               strip_budget: Optional[int] = _gemm.DEFAULT_STRIP_BUDGET,
               grid_order: str = "default", accum: str = "auto",
               epilogue: tuple = (), bias=None,
               device=None) -> torch.Tensor:
    """C = A @ B with the template selected by an STT dataflow.

    Operands may carry a leading batch dim (``(B, m, k) @ (B, k, n)``; a
    rank-2 operand broadcasts across the batch).  Per-slice m/n/k are
    padded to block multiples; the batch dim never needs padding.
    Operands are moved to ``device`` (default: the card, see
    :func:`resolve_device`).

    ``strip_budget`` caps the operand-stationary strip accumulator per
    batch slice: when the per-slice (m, bn) fp32 strip would not fit, the
    call falls back to the output-stationary template (same math) instead
    of erroring.

    ``epilogue`` is a tuple of post-processing ops (``kernels/epilogue``)
    fused into the template's flush; ``bias`` is the rank-1 operand a
    ``"bias"`` op reads.  A ``"softmax"`` op needs one block spanning the
    whole unpadded row (``bn >= n``), so the call raises otherwise.
    """
    dev = resolve_device(device)
    a, b = a.to(dev), b.to(dev)
    epilogue = _ep.validate_spec(epilogue)
    m, k = a.shape[-2:]
    n = b.shape[-1]
    bm, bn, bk = min(bm, m), min(bn, n), min(bk, k)
    if _ep.has_softmax(epilogue) and (bn != n or n % bn):
        raise ValueError(
            f"softmax epilogue needs one unpadded output block covering "
            f"the full row: bn >= n and n % bn == 0 (got bn={bn}, n={n})")
    ap = _pad_to(a, (1,) * (a.dim() - 2) + (bm, bk))
    bp = _pad_to(b, (1,) * (b.dim() - 2) + (bk, bn))
    if bias is not None:
        # padded n columns get bias 0 and are sliced off below
        bias = _pad_to(torch.as_tensor(bias, device=dev), (bn,))
    if epilogue and template == "operand_stationary" and stationary == "A":
        # the input-stationary realization transposes m/n, so a last-axis
        # epilogue cannot ride it; same math, other template
        template = "output_stationary"
    if template == "operand_stationary" and strip_budget is not None:
        # the strip extent follows the *streamed-output* dimension of one
        # batch slice: M for stationary B, N for stationary A
        strip_len = ap.shape[-2] if stationary == "B" else bp.shape[-1]
        strip_bn = bn if stationary == "B" else bm
        if (_gemm.operand_stationary_strip_bytes(strip_len, strip_bn)
                > strip_budget):
            template = "output_stationary"
    kw = dict(bm=bm, bn=bn, bk=bk, epilogue=epilogue, bias=bias)
    if template == "output_stationary":
        out = _gemm.matmul_output_stationary(
            ap, bp, grid_order=grid_order,
            accum=resolve_accum(accum, a.dtype), **kw)
    elif template == "operand_stationary":
        out = _gemm.matmul_operand_stationary(
            ap, bp, stationary=stationary, strip_budget=strip_budget, **kw)
    elif template in ("reduction_tree", "streaming"):
        kw.pop("bk")
        out = _gemm.matmul_reduction_tree(
            ap, bp, grid_order=_rt_order(grid_order), **kw)
    else:
        raise ValueError(f"unknown template {template!r}")
    return out[..., :m, :n]


def bsr_csr(coords: _bsr.Coords, block: tuple, shape: tuple, side: str,
            device) -> tuple:
    """The CSR device arrays :func:`bsr_matmul` hands the kernel for this
    pattern: of ``coords`` as given for ``side='lhs'``, of the transposed
    pattern for ``side='rhs'``.  ``shape`` is the sparse operand's."""
    if side == "rhs":
        coords = _bsr.transpose_coords(coords)
        block, shape = (block[1], block[0]), (shape[1], shape[0])
    return _bsr.csr_arrays(_bsr.sort_coords(coords), shape[0] // block[0],
                           device)


def bsr_matmul(sparse: torch.Tensor, dense: torch.Tensor, *,
               coords: _bsr.Coords, block: tuple, bstream: int = 128,
               side: str = "lhs", csr: Optional[tuple] = None
               ) -> torch.Tensor:
    """Block-sparse GEMM with one block-COO operand (zeros outside the
    static ``coords`` pattern are never read by the kernel).

    ``side='lhs'``: C = sparse @ dense, ``sparse`` (m, k) with ``block`` =
    (bm, bk) blocks; ``bstream`` is the plan's block of the streamed n.
    ``side='rhs'``: C = dense @ sparse, realized by transposition symmetry
    (C^T = sparse^T @ dense^T, as strided views) so one kernel serves
    both operand sides; the result is the transposed view.  ``csr`` is
    the pattern's cached device arrays (:func:`bsr_csr`).
    """
    if side not in ("lhs", "rhs"):
        raise ValueError(f"side must be 'lhs' or 'rhs', got {side!r}")
    if side == "rhs":
        return bsr_matmul(sparse.T, dense.T,
                          coords=_bsr.transpose_coords(coords),
                          block=(block[1], block[0]), bstream=bstream,
                          side="lhs", csr=csr).T
    bm, bk = block
    return _bsr.bsr_matmul(sparse, dense, coords=coords, bm=bm, bk=bk,
                           bn=bstream, csr=csr)


def matmul_from_plan(plan: KernelPlan, a: torch.Tensor, b: torch.Tensor,
                     **kw) -> torch.Tensor:
    """Dispatch a GEMM according to a generated KernelPlan — the paper's
    'select modules from the dataflow' step, at call granularity."""
    stationary = "B" if plan.resident_tensor in (None, "B", "C") else "A"
    return stt_matmul(a, b, template=plan.template, stationary=stationary,
                      **kw)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              bq: int = 128, bkv: int = 128, backend: str = "kernel",
              q_offset: int = 0) -> torch.Tensor:
    """GQA attention (B, Hq, Lq, D) x (B, Hkv, Lkv, D) -> (B, Hq, Lq, D).

    ``backend="kernel"`` pads Lq and Lkv to block multiples as the
    reference does and runs :func:`flash_attention.flash_attention` (the
    CUDA kernel on the card, its plain version on the CPU);
    ``backend="xla"`` is the reference's name for the plain oracle
    :func:`ref.attention_ref`.  Padded kv columns are masked only by the
    causal mask, so cross-attention needs ``Lkv % bkv == 0``.
    ``q_offset`` places q row i at position ``q_offset + i`` in the masks.
    """
    if backend == "xla":
        return _ref.attention_ref(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset)
    if backend != "kernel":
        raise ValueError(f"backend must be 'kernel' or 'xla', got "
                         f"{backend!r}")
    lq, lkv = q.shape[2], k.shape[2]
    bq, bkv = min(bq, lq), min(bkv, lkv)
    qp = _pad_to(q, (1, 1, bq, 1))
    kp = _pad_to(k, (1, 1, bkv, 1))
    vp = _pad_to(v, (1, 1, bkv, 1))
    if not causal and kp.shape[2] != lkv:
        raise ValueError("cross-attention requires Lkv % bkv == 0")
    out = _fa.flash_attention(qp, kp, vp, causal=causal, window=window,
                              q_offset=q_offset)
    return out[:, :, :lq]


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------

def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
        b: torch.Tensor, c: torch.Tensor, *, chunk: int = 64,
        backend: str = "kernel") -> torch.Tensor:
    """Mamba-2 SSD:  x (B, L, H, P), dt (B, L, H), a (H,),
    b/c (B, L, G, N) -> y (B, L, H, P) in x's dtype.

    ``backend="kernel"`` runs :func:`ssd_scan.ssd_scan` (on the card the
    CUDA kernels, which read x, dt and a as they are, with B and C per
    group rather than repeated to heads; on the CPU the plain version);
    ``backend="xla"`` is the reference's name for the plain oracle
    :func:`ref.ssd_chunked_ref`.
    """
    if backend == "xla":
        return _ref.ssd_chunked_ref(x, dt, a, b, c, chunk=chunk)[0]
    if backend != "kernel":
        raise ValueError(f"backend must be 'kernel' or 'xla', got "
                         f"{backend!r}")
    return _ssd.ssd_scan(x, dt, a, b, c, chunk=chunk)[0]
