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
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .stt_gemm import _DTYPE_CODES, _on_cpu, _stream

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

#: kernel launches since the last ``reset_launches``
launches = {"flash_attention": 0}


def reset_launches() -> None:
    launches["flash_attention"] = 0


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


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          window: Optional[int] = None, bkv: int = 64,
                          round_p: bool = False) -> torch.Tensor:
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
    ``BF16_ROW_TOL``."""
    group = _check(q, k, v, window)
    torch.backends.cuda.matmul.allow_tf32 = False
    b, hq, lq, d = q.shape
    lkv = k.shape[2]
    scale = 1.0 / (d ** 0.5)
    qf = q.to(torch.float32)
    kf = k.to(torch.float32).repeat_interleave(group, dim=1)
    vf = v.to(torch.float32).repeat_interleave(group, dim=1)
    qpos = torch.arange(lq, device=q.device)[:, None]
    m = torch.full((b, hq, lq), NEG_INF, device=q.device)
    l = torch.zeros((b, hq, lq), device=q.device)
    acc = torch.zeros((b, hq, lq, d), device=q.device)
    for k0 in range(0, lkv, bkv):
        kb, vb = kf[:, :, k0:k0 + bkv], vf[:, :, k0:k0 + bkv]
        s = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        kpos = torch.arange(k0, k0 + kb.shape[2], device=q.device)[None, :]
        mask = torch.ones((lq, kb.shape[2]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= qpos >= kpos
        if window is not None:
            mask &= qpos - kpos < window
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
    return (acc / safe[..., None]).to(q.dtype)


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None
                    ) -> torch.Tensor:
    """q: (B, Hq, Lq, D);  k, v: (B, Hkv, Lkv, D);  Hq % Hkv == 0.

    Returns (B, Hq, Lq, D) in q's dtype.  Any Lq and Lkv: the kernel
    masks its ragged edges itself (``ops.attention`` pads first, as the
    reference does, so padded rows and columns behave as there).
    """
    if _on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    group = _check(q, k, v, window)
    b, hq, lq, d = q.shape
    lkv = k.shape[2]
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if len({q.dtype, k.dtype, v.dtype}) != 1 or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"the attention kernel takes float32 or bfloat16 "
                         f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {d}")
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("the attention kernel needs a contiguous last "
                         "(head) dimension")
    if q.dtype == torch.bfloat16:
        _check_aligned(q=q, k=k, v=v)
    out = torch.empty((b, hq, lq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _build.library("flash_attention")
    _build.check(lib.flash_attention_launch(
        _DTYPE_CODES[q.dtype], q.data_ptr(), _strides(q), k.data_ptr(),
        _strides(k), v.data_ptr(), _strides(v), out.data_ptr(),
        _strides(out), b, hq, lq, lkv, d, group, 1.0 / (d ** 0.5),
        int(causal), 0 if window is None else int(window), _stream()),
        "flash_attention_launch")
    launches["flash_attention"] += 1
    return out
