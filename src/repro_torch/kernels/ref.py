"""Plain PyTorch oracles for the GEMM path, attention and the SSD.

Torch twins of the reference's ``kernels/ref.py`` GEMM, attention and
Mamba-2 SSD oracles.
"""
from __future__ import annotations

from typing import Optional, Tuple

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


# ---------------------------------------------------------------------------
# Mamba-2 SSD (state-space duality) — chunked linear recurrence
# ---------------------------------------------------------------------------

def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor, c: torch.Tensor,
            h0: Optional[torch.Tensor] = None,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential-scan oracle for the SSD recurrence.

      h_t = exp(dt_t * a) * h_{t-1} + dt_t * B_t x_t^T
      y_t = C_t . h_t

    Shapes: x (B, L, H, P), dt (B, L, H), a (H,) [negative],
            b, c (B, L, G, N) with H % G == 0; h0 (B, H, N, P) or None.
    Returns (y (B, L, H, P), h_final (B, H, N, P)).  fp32 internally.
    """
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    xf = x.to(torch.float32)
    dtf = dt.to(torch.float32)
    bf = b.to(torch.float32).repeat_interleave(rep, dim=2)   # (B, L, H, N)
    cf = c.to(torch.float32).repeat_interleave(rep, dim=2)
    decay = torch.exp(dtf * a.to(torch.float32))            # (B, L, H)
    hcur = (torch.zeros((bsz, h, n, p), dtype=torch.float32,
                        device=x.device)
            if h0 is None else h0.to(torch.float32))
    ys = []
    for step in range(l):
        hcur = (decay[:, step, :, None, None] * hcur
                + (dtf[:, step, :, None] * bf[:, step])[..., None]
                * xf[:, step, :, None, :])
        ys.append(torch.einsum("bhn,bhnp->bhp", cf[:, step], hcur))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((bsz, 0, h, p))
    return y.to(x.dtype), hcur


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, chunk: int = 64,
                    h0: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked (quadratic-within-chunk) SSD — the algorithm the SSD
    kernel implements, vectorized over chunks, with the inter-chunk
    state carried by a loop.  Mathematically identical to ``ssd_ref``;
    the models' prefill path on the CPU.  Computes in the wider of fp32
    and x's dtype (float64 stays float64).  Returns (y, h_final)."""
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    if l % chunk:
        raise ValueError(f"L={l} not divisible by chunk={chunk}")
    nc = l // chunk
    f = torch.promote_types(x.dtype, torch.float32)

    xf = x.to(f) * dt.to(f)[..., None]  # dt folded
    bf = b.to(f).repeat_interleave(rep, dim=2)
    cf = c.to(f).repeat_interleave(rep, dim=2)
    da = dt.to(f) * a.to(f)              # (B, L, H)

    # reshape to chunks: (B, nc, Q, ...)
    xc = xf.reshape(bsz, nc, chunk, h, p)
    bc = bf.reshape(bsz, nc, chunk, h, n)
    cc = cf.reshape(bsz, nc, chunk, h, n)
    lc = torch.cumsum(da.reshape(bsz, nc, chunk, h), dim=2)      # (B,nc,Q,H)

    # intra-chunk: y[i] = sum_{j<=i} exp(Lc[i]-Lc[j]) (C_i.B_j) xdt[j]
    s = torch.einsum("bcihn,bcjhn->bchij", cc, bc)
    li = lc.permute(0, 1, 3, 2)                    # (B, nc, H, Q)
    dmat = li[..., :, None] - li[..., None, :]     # Lc[i] - Lc[j]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    # mask BEFORE exp: above the diagonal dmat is positive and overflows
    m = torch.exp(torch.where(tri, dmat, torch.full_like(dmat, -1e9)))
    y_intra = torch.einsum("bchij,bcjhp->bcihp", s * m, xc)

    # chunk-level states: contribution of chunk tokens to its end state
    wend = torch.exp(lc[:, :, -1:, :] - lc)                      # (B,nc,Q,H)
    chunk_state = torch.einsum("bcjhn,bcjhp->bchnp", bc * wend[..., None],
                               xc)
    chunk_decay = torch.exp(lc[:, :, -1, :])                     # (B,nc,H)

    # carry the state over chunks: the state entering each chunk
    hcur = (torch.zeros((bsz, h, n, p), dtype=f,
                        device=x.device)
            if h0 is None else h0.to(f))
    h_in = []
    for ci in range(nc):
        h_in.append(hcur)
        hcur = chunk_decay[:, ci, :, None, None] * hcur + chunk_state[:, ci]
    h_in = torch.stack(h_in, dim=1)                  # (B,nc,H,N,P) pre-chunk

    # inter-chunk: y[i] += C_i . (exp(Lc[i]) * h_in)
    y_inter = torch.einsum("bcihn,bchnp->bcihp",
                           cc * torch.exp(lc)[..., None], h_in)
    y = (y_intra + y_inter).reshape(bsz, l, h, p).to(x.dtype)
    return y, hcur
