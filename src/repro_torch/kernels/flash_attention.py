"""Blockwise online-softmax attention — the port of the reference's
``kernels/flash_attention.py``.

GQA attention with causal and sliding-window masks, or none (cross
attention); fp32 softmax statistics; fully masked rows give 0.  The
reference's TPU kernel runs the kv blocks as the sequential grid axis
with the running (m, l, acc) in VMEM scratch.  The CUDA kernels
(``csrc/flash_attention.cu``) give one CTA each (batch, q head, 64-row
q block), loop over 64-column kv blocks inside the CTA with the
statistics in registers, map q head ``h`` to kv head ``h // group`` and
skip kv blocks the mask hides from the whole q block.  bf16 q, k, v (the
models' prefill) run on the tensor cores (``mma.sync``, K and V streamed
through a ``cp.async`` ring); fp32 runs a SIMT kernel (TF32 stays off).

:func:`flash_attention_plain` is the same online softmax over kv blocks
in PyTorch (the reference's arithmetic, without the kernels' block
skipping, which changes no bit; ``round_p=True`` gives the bf16 kernel's
arithmetic); :func:`flash_attention` runs it on a CPU tensor and a
kernel on a CUDA tensor, or raises.  :func:`row_error` and
``BF16_ROW_TOL`` are the bf16 kernel's stated tolerance.  ``launches``
counts kernel launches.  The kernels read q, k and v through their
strides (the last dimension must be contiguous), so the models' head
views reach them without a copy.

Training: the reference differentiates its XLA attention; on the card
the port's forward is this kernel, so it has a backward of its own
(no Pallas counterpart).  :class:`FlashAttentionFn` runs the forward
with each row's log-sum-exp saved and :func:`flash_attention_backward`
launches the three backward kernels (``delta = rowsum(dO o O)``, then
dK and dV per kv block, then dQ per q block, each recomputing P from q,
k and the log-sum-exp; bf16 on the tensor cores, rounding P and dS to
bf16 as the A operands of their products, fp32 SIMT);
:func:`flash_attention` routes through the Function whenever autograd
records and an input requires grad.
:func:`flash_attention_backward_plain` is FA2's arithmetic in PyTorch,
the backward kernels' plain version.  On the CPU the plain forward is
differentiated by autograd instead.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build
from .stt_gemm import _DTYPE_CODES, _on_cpu, _stream, meta_launch

NEG_INF = float(-1e30)
#: head dims the kernel is instantiated for (multiples of 8 up to 128)
HEAD_DIMS = (16, 32, 64, 80, 96, 128)

#: the bf16 kernel against ``flash_attention_plain(..., round_p=True)``:
#: the largest :func:`row_error` allowed.  Two bf16 roundings of an output
#: that differ by one unit in the last place move a row by at most 2^-7
#: of its norm; one kv block hidden from the last q block moves those
#: rows by about half their norm at the serve shapes (``chip_smoke.py``
#: reads both on the card and fails unless the second exceeds the limit).
BF16_ROW_TOL = 1e-2

#: kernel launches since the last ``reset_launches`` (the backward's
#: count is one a call of its three kernels)
launches = {"flash_attention": 0, "flash_attention_backward": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def visible_pairs(lq: int, lkv: int, causal: bool, window: Optional[int],
                  q_offset: int = 0) -> int:
    """The (q row, kv column) pairs the mask lets through, q row i at
    position ``q_offset + i``."""
    rows = np.arange(q_offset, q_offset + lq)
    hi = np.minimum(lkv, rows + 1) if causal else np.full(lq, lkv)
    lo = (np.maximum(0, rows - window + 1) if window
          else np.zeros(lq, np.int64))
    return int(np.maximum(0, hi - lo).sum())


def cost(b: int, hq: int, hkv: int, lq: int, lkv: int, d: int, *,
         causal: bool, window: Optional[int] = None, q_offset: int = 0,
         itemsize: int = 2, backward: bool = False, with_lse: bool = False
         ) -> Tuple[float, float]:
    """(operations, bytes) of one call, the counts behind the kernels'
    bounds.  Forward: 4 D operations a visible pair and q head (Q K^T and
    P V); q, k and v read once, the output written once, and with
    ``with_lse`` the fp32 log-sum-exp written.  Backward: 2.5x the
    forward's operations (S and dP recomputed, dV, dQ, dK); q, the
    output, dO and dQ, k, v, dK and dV each once, and the log-sum-exp
    read."""
    pairs = visible_pairs(lq, lkv, causal, window, q_offset)
    nq, nk = b * hq * lq * d, b * hkv * lkv * d
    if backward:
        return (2.5 * 4.0 * d * b * hq * pairs,
                itemsize * (4 * nq + 4 * nk) + 4.0 * b * hq * lq)
    return (4.0 * d * b * hq * pairs,
            itemsize * (2.0 * nq + 2 * nk) + (4.0 * b * hq * lq
                                              if with_lse else 0.0))


def _meta_cost(q, k, window, causal, q_offset, **kw) -> Tuple[float, float]:
    b, hq, lq, d = q.shape
    return cost(b, hq, k.shape[1], lq, k.shape[2], d, causal=causal,
                window=window, q_offset=q_offset, itemsize=q.element_size(),
                **kw)


def _check(q, k, v, window) -> int:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"attention takes q (B, Hq, Lq, D) and k, v "
                         f"(B, Hkv, Lkv, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"disagree on batch or head dim")
    hkv = k.shape[1]
    if hq % hkv:
        raise ValueError(f"GQA requires Hq % Hkv == 0, got {hq}, {hkv}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    return hq // hkv


def _mask(lq: int, k0: int, kv: int, causal: bool, window: Optional[int],
          device, q_offset: int = 0) -> torch.Tensor:
    """(lq, kv) visibility of kv columns [k0, k0 + kv) to the q rows, q
    row i at position ``q_offset + i``."""
    qpos = q_offset + torch.arange(lq, device=device)[:, None]
    kpos = torch.arange(k0, k0 + kv, device=device)[None, :]
    mask = torch.ones((lq, kv), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          window: Optional[int] = None, bkv: int = 64,
                          round_p: bool = False, return_lse: bool = False,
                          q_offset: int = 0):
    """The kernels' arithmetic in PyTorch: scores ``(q . k) * scale`` in
    fp32, masked to ``NEG_INF``, an online softmax over kv blocks of
    ``bkv`` columns (p = 0 where s <= NEG_INF / 2), out = acc / l with
    fully masked rows (l == 0) written as 0, in q's dtype.

    ``P V`` is taken in fp32, as in the reference, unless ``round_p``:
    then P is rounded to bf16 before ``P V`` (l still sums the fp32
    probabilities), as the bf16 kernel does, whose tensor cores take
    bf16 operands.  That departure is a relative error of at most 2^-9 a
    probability, inside the reference's bf16 tolerance of 2e-2 x
    max|out|; the kernel is held to this version within
    ``BF16_ROW_TOL``.

    ``q_offset`` is the absolute position of q row 0 in the masks (a
    block of query rows cut from a longer sequence: q row i sits at
    ``q_offset + i``), as the reference's ``_chunked_attn`` places its
    rows.

    With ``return_lse`` it returns ``(out, lse)``: each row's
    log-sum-exp ``m + log l`` (B, Hq, Lq) fp32, +inf where the row sees
    no column, as the kernels write it for the backward."""
    group = _check(q, k, v, window)
    torch.backends.cuda.matmul.allow_tf32 = False
    b, hq, lq, d = q.shape
    lkv = k.shape[2]
    scale = 1.0 / (d ** 0.5)
    qf = q.to(torch.float32)
    kf = k.to(torch.float32).repeat_interleave(group, dim=1)
    vf = v.to(torch.float32).repeat_interleave(group, dim=1)
    m = torch.full((b, hq, lq), NEG_INF, device=q.device)
    l = torch.zeros((b, hq, lq), device=q.device)
    acc = torch.zeros((b, hq, lq, d), device=q.device)
    for k0 in range(0, lkv, bkv):
        kb, vb = kf[:, :, k0:k0 + bkv], vf[:, :, k0:k0 + bkv]
        s = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        mask = _mask(lq, k0, kb.shape[2], causal, window, q.device,
                     q_offset)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(s > NEG_INF / 2, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        l = alpha * l + p.sum(dim=-1)
        pv = p.to(torch.bfloat16).to(torch.float32) if round_p else p
        acc = acc * alpha[..., None] + torch.matmul(pv, vb)
        m = m_new
    safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / safe[..., None]).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l == 0.0, torch.full_like(l, float("inf")),
                      m + torch.log(safe))
    return out, lse


def flash_attention_backward_plain(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor, *,
        causal: bool = True, window: Optional[int] = None,
        q_offset: int = 0):
    """FA2's backward in PyTorch, the backward kernels' arithmetic: P
    recomputed as ``exp(s - lse)`` on visible pairs (0 elsewhere), ``dV =
    P^T dO``, ``dP = dO V^T``, ``delta = rowsum(dO o O)``, ``dS = P o (dP
    - delta)``, ``dQ = dS K * scale``, ``dK = dS^T Q * scale``, dK and dV
    summed over each kv head's GQA group; everything in fp32, the
    results in q's dtype; q row i at position ``q_offset + i`` in the
    masks.  Returns (dq, dk, dv)."""
    group = _check(q, k, v, window)
    b, hq, lq, d = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    scale = 1.0 / (d ** 0.5)
    f32 = torch.float32
    qf, of, gf = q.to(f32), out.to(f32), dout.to(f32)
    kf = k.to(f32).repeat_interleave(group, dim=1)
    vf = v.to(f32).repeat_interleave(group, dim=1)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    mask = _mask(lq, 0, lkv, causal, window, q.device, q_offset)
    p = torch.where(mask, torch.exp(s - lse.to(f32)[..., None]),
                    torch.zeros_like(s))
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    delta = (gf * of).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dk = dk.reshape(b, hkv, group, lkv, d).sum(dim=2)
    dv = dv.reshape(b, hkv, group, lkv, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def row_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest ``||got - want|| / ||want||`` over rows (the last
    axis), in fp32; a row of ``want`` that is all 0 (fully masked) is
    held to ``||got||`` itself."""
    got, want = got.float(), want.float().to(got.device)
    norm = torch.linalg.vector_norm(want, dim=-1)
    diff = torch.linalg.vector_norm(got - want, dim=-1)
    return (diff / torch.where(norm == 0, torch.ones_like(norm), norm)
            ).max().item()


def _check_aligned(**views: torch.Tensor) -> None:
    """The tensor-core kernel copies rows in 16-byte pieces: each base
    pointer and each batch, head and row stride must be a multiple of 16
    bytes (8 bf16); the stride of an axis of length 1 is never used."""
    for name, x in views.items():
        if x.data_ptr() % 16 or any(x.stride(i) % 8 for i in range(3)
                                    if x.shape[i] > 1):
            raise ValueError(
                f"the bf16 attention kernel needs {name} 16-byte aligned: "
                f"data_ptr % 16 = {x.data_ptr() % 16}, strides "
                f"{tuple(x.stride())} (batch, head and row strides must "
                f"be multiples of 8 elements)")


def _strides(x: torch.Tensor):
    return (ctypes.c_longlong * 3)(x.stride(0), x.stride(1), x.stride(2))


def _check_cuda(q, k, v) -> None:
    """What every CUDA kernel of this module takes."""
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if len({q.dtype, k.dtype, v.dtype}) != 1 or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"the attention kernel takes float32 or bfloat16 "
                         f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"the attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {q.shape[3]}")
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("the attention kernel needs a contiguous last "
                         "(head) dimension")


def _forward(q, k, v, causal: bool, window: Optional[int],
             with_lse: bool, q_offset: int = 0):
    """The forward kernel on CUDA tensors: (out, lse or None)."""
    group = _check(q, k, v, window)
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    _check_cuda(q, k, v)
    b, hq, lq, d = q.shape
    lkv = k.shape[2]
    if q.dtype == torch.bfloat16:
        _check_aligned(q=q, k=k, v=v)
    out = torch.empty((b, hq, lq, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, hq, lq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    if q.is_meta:
        meta_launch(launches, "flash_attention", *_meta_cost(
            q, k, window, causal, q_offset, with_lse=with_lse))
        return out, lse
    lib = _build.library("flash_attention")
    _build.check(lib.flash_attention_launch(
        _DTYPE_CODES[q.dtype], q.data_ptr(), _strides(q), k.data_ptr(),
        _strides(k), v.data_ptr(), _strides(v), out.data_ptr(),
        _strides(out), b, hq, lq, lkv, d, group, 1.0 / (d ** 0.5),
        int(causal), 0 if window is None else int(window), int(q_offset),
        None if lse is None else lse.data_ptr(), _stream()),
        "flash_attention_launch")
    launches["flash_attention"] += 1
    return out, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, Hq, Lq, D);  k, v: (B, Hkv, Lkv, D);  Hq % Hkv == 0.

    Returns (B, Hq, Lq, D) in q's dtype.  Any Lq and Lkv: the kernel
    masks its ragged edges itself (``ops.attention`` pads first, as the
    reference does, so padded rows and columns behave as there).
    ``q_offset`` places q row i at position ``q_offset + i`` in the
    masks (a model-mesh rank's block of query rows).  On the card, while
    autograd records and an input requires grad, the call goes through
    :class:`FlashAttentionFn`, whose backward is a kernel.
    """
    if _on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        extra = (q_offset,) if q_offset else ()
        return FlashAttentionFn.apply(q, k, v, causal, window, *extra)
    return _forward(q, k, v, causal, window, with_lse=False,
                    q_offset=q_offset)[0]


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             dout: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True,
                             window: Optional[int] = None,
                             q_offset: int = 0):
    """The gradients (dq, dk, dv) of :func:`flash_attention` at (q, k,
    v), given its output ``out``, the output's gradient ``dout`` and the
    forward's log-sum-exp ``lse`` (B, Hq, Lq) fp32.  On the card three
    kernels (``delta``, then dK/dV, then dQ); on the CPU
    :func:`flash_attention_backward_plain`.  dq, dk and dv come back
    contiguous, in q's dtype.  ``q_offset`` places q row i at position
    ``q_offset + i`` in the masks, as in the forward."""
    if _on_cpu(q, k, v, out, dout, lse):
        return flash_attention_backward_plain(q, k, v, out, dout, lse,
                                              causal=causal, window=window,
                                              q_offset=q_offset)
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    group = _check(q, k, v, window)
    _check_cuda(q, k, v)
    b, hq, lq, d = q.shape
    lkv = k.shape[2]
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    if out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"out and dout must be {q.dtype}, got {out.dtype}, "
                         f"{dout.dtype}")
    if lse.shape != (b, hq, lq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be (B, Hq, Lq) = {(b, hq, lq)} float32, "
                         f"got {tuple(lse.shape)} {lse.dtype}")
    # dout arrives from transpose/reshape; the kernels read it through
    # its strides but need its last dimension contiguous
    out, dout = (x if x.stride(3) == 1 else x.contiguous()
                 for x in (out, dout))
    lse = lse.contiguous()
    dq = torch.empty((b, hq, lq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    if dq.numel() == 0 and dk.numel() == 0:
        return dq, dk, dv
    delta = torch.empty((b, hq, lq), dtype=torch.float32, device=q.device)
    if q.is_meta:
        meta_launch(launches, "flash_attention_backward", *_meta_cost(
            q, k, window, causal, q_offset, backward=True))
        return dq, dk, dv
    lib = _build.library("flash_attention")
    _build.check(lib.flash_attention_backward_launch(
        _DTYPE_CODES[q.dtype], q.data_ptr(), _strides(q), k.data_ptr(),
        _strides(k), v.data_ptr(), _strides(v), out.data_ptr(),
        _strides(out), dout.data_ptr(), _strides(dout), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b,
        hq, lq, lkv, d, group, 1.0 / (d ** 0.5), int(causal),
        0 if window is None else int(window), int(q_offset), _stream()),
        "flash_attention_backward_launch")
    launches["flash_attention_backward"] += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with a hand-written backward: the forward kernel
    saves each row's log-sum-exp beside q, k, v and the output, and the
    backward launches :func:`flash_attention_backward`.  On CPU tensors
    both halves run their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset=0):
        if _on_cpu(q, k, v):
            out, lse = flash_attention_plain(q, k, v, causal=causal,
                                             window=window, return_lse=True,
                                             q_offset=q_offset)
        else:
            out, lse = _forward(q, k, v, causal, window, with_lse=True,
                                q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.q_offset = causal, window, q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, dout, lse, causal=ctx.causal, window=ctx.window,
            q_offset=ctx.q_offset)
        return dq, dk, dv, None, None, None
