"""Plain PyTorch oracles for the GEMM path and attention.

Torch twins of the reference's ``kernels/ref.py`` GEMM and attention
oracles.  The SSD oracles arrive with the SSM slice.
"""
from __future__ import annotations

from typing import Optional

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C[..., m, n] = sum_k A[..., m, k] B[..., k, n], fp32 accumulation.

    A leading batch dim on either operand broadcasts against the other.
    TF32 is off so fp32 products are full fp32 on the card as well.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = torch.matmul(a.to(torch.float32), b.to(torch.float32))
    return out.to(out_dtype or a.dtype)


# ---------------------------------------------------------------------------
# Retired block-diagonal GEMM-ization — kept as a test-only oracle
# ---------------------------------------------------------------------------

def block_diag_rows(rows: torch.Tensor) -> torch.Tensor:
    """(B, K) -> (B, B*K) with row i equal to rows[i] placed in block i."""
    b = rows.shape[0]
    eye = torch.eye(b, dtype=rows.dtype, device=rows.device)
    return (eye[:, :, None] * rows[None, :, :]).reshape(b, -1)


def _im2col_oracle(a: torch.Tensor, y: int, x: int, p: int, q: int
                   ) -> torch.Tensor:
    """(C, y+p-1, x+q-1) -> (C*p*q, y*x), C-major then (p, q) — written
    as explicit loops, independently of the lowering's stacked version."""
    rows = []
    for cc in range(a.shape[0]):
        for pp in range(p):
            for qq in range(q):
                rows.append(a[cc, pp:pp + y, qq:qq + x].reshape(y * x))
    return torch.stack(rows)


def batched_gemv_blockdiag_ref(a: torch.Tensor, b: torch.Tensor,
                               out_dtype: Optional[torch.dtype] = None
                               ) -> torch.Tensor:
    """C[m, n] = sum_k A[m, k, n] * B[m, k] via the retired lowering:
    block_diag(B) (m, m*k) @ A.reshape(m*k, n)."""
    m, k, n = a.shape
    return matmul_ref(block_diag_rows(b), a.reshape(m * k, n),
                      out_dtype=out_dtype)


def depthwise_blockdiag_ref(a: torch.Tensor, b: torch.Tensor, *, y: int,
                            x: int) -> torch.Tensor:
    """C[k, y, x] = sum_{p,q} A[k, y+p, x+q] * B[k, p, q] via the retired
    lowering: block_diag(B) (k, k*p*q) @ im2col(A) (k*p*q, y*x)."""
    k, p, q = b.shape
    out = matmul_ref(block_diag_rows(b.reshape(k, p * q)),
                     _im2col_oracle(a, y, x, p, q))
    return out.reshape(k, y, x)


# ---------------------------------------------------------------------------
# Attention (GQA + causal + sliding window + cross)
# ---------------------------------------------------------------------------

def attention_mask(q_len: int, kv_len: int, *, causal: bool,
                   window: Optional[int], q_offset: int = 0,
                   device=None) -> torch.Tensor:
    """Boolean (q_len, kv_len) mask; True = attend.

    ``q_offset`` places the query block inside a longer sequence (used for
    decode, where q_len == 1 at absolute position q_offset).
    """
    qpos = torch.arange(q_len, device=device)[:, None] + q_offset
    kpos = torch.arange(kv_len, device=device)[None, :]
    mask = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """Reference multi-head attention.

    q: (B, Hq, Lq, D);  k, v: (B, Hkv, Lkv, D) with Hq % Hkv == 0 (GQA).
    Softmax in fp32; fully masked rows give 0 (the softmax's NaN is
    replaced).  ``causal=False, window=None`` gives cross-attention.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    b, hq, lq, d = q.shape
    group = hq // k.shape[1]
    kg = k.repeat_interleave(group, dim=1).to(torch.float32)
    vg = v.repeat_interleave(group, dim=1).to(torch.float32)
    scores = torch.matmul(q.to(torch.float32), kg.transpose(-1, -2)) / \
        torch.sqrt(torch.tensor(float(d)))
    mask = attention_mask(lq, k.shape[2], causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    scores = scores.masked_fill(~mask, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)           # fully-masked rows
    return torch.matmul(p, vg).to(q.dtype)
