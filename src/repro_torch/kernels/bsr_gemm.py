"""Block-sparse (block-COO) GEMM — the port of the reference's
``kernels/bsr_gemm.py``.

``C = S @ D`` with ``S`` (m, k) block-sparse in (bm, bk) blocks.  The
reference's Pallas grid iterates only the nonzero blocks of a row-major
coordinate list, in order, resetting its accumulator on every block-row
change.  The CUDA kernel (``csrc/bsr_gemm.cu``) has no ordered grid: the
pattern reaches it as CSR row pointers and block-column indices (int32
device arrays, :func:`csr_arrays`), and one CTA per (block-row, n-tile)
walks its row's nonzero blocks in ascending k with the sum in registers.
Each output adds its products in the same ascending order as the
output-stationary template, so at density 1.0 the two are bit-identical.

Block-rows with no nonzero block are written as zeros by the kernel (the
CTA's loop is empty and it flushes its zero sum); the plain version
selects zeros for them, never multiplies (``0 * garbage`` can be nan).

On the CPU the wrapper runs :func:`bsr_matmul_plain`; on a CUDA tensor it
launches the kernel or raises.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build
from .stt_gemm import _DTYPE_CODES, _fp32_product, _on_cpu, _stream

#: static block-COO coordinate list: ((block_row, block_col), ...) sorted
Coords = Tuple[Tuple[int, int], ...]

#: kernel launches since the last ``reset_launches``
launches = {"bsr": 0}


def reset_launches() -> None:
    launches["bsr"] = 0


def sort_coords(coords: Sequence[Sequence[int]]) -> Coords:
    """Canonical row-major, duplicate-free coordinate tuple."""
    return tuple(sorted(set(tuple(int(i) for i in c) for c in coords)))


def _index(coords: Coords, device) -> Tuple[torch.Tensor, torch.Tensor]:
    idx = torch.as_tensor(np.asarray(coords, dtype=np.int64).reshape(-1, 2),
                          device=device)
    return idx[:, 0], idx[:, 1]


def gather_blocks(x: torch.Tensor, coords: Coords, bm: int, bk: int
                  ) -> torch.Tensor:
    """(m, k) -> (nnz, bm, bk): the nonzero blocks of ``x``."""
    m, k = x.shape
    g = x.reshape(m // bm, bm, k // bk, bk).permute(0, 2, 1, 3)
    rows, cols = _index(coords, x.device)
    return g[rows, cols]


def scatter_blocks(data: torch.Tensor, coords: Coords, m: int, k: int
                   ) -> torch.Tensor:
    """Inverse of :func:`gather_blocks`: the masked dense operand."""
    nnz, bm, bk = data.shape
    g = torch.zeros((m // bm, k // bk, bm, bk), dtype=data.dtype,
                    device=data.device)
    if nnz:
        rows, cols = _index(coords, data.device)
        g[rows, cols] = data
    return g.permute(0, 2, 1, 3).reshape(m, k)


def transpose_coords(coords: Coords) -> Coords:
    """Swap block coordinates (for the rhs-sparse transposition trick) and
    restore row-major order."""
    return sort_coords((c, r) for r, c in coords)


def _row_presence(coords: Coords, n_rows: int) -> np.ndarray:
    present = np.zeros(n_rows, dtype=bool)
    for r, _ in coords:
        present[r] = True
    return present


def csr_arrays(coords: Coords, n_block_rows: int, device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's view of a pattern: int32 ``row_ptr``
    (n_block_rows + 1) and ``col_idx`` (nnz, ascending within each row),
    on ``device``.  Built once per pattern (the compiled kernel caches
    them); ``coords`` must be sorted row-major."""
    counts = np.zeros(n_block_rows + 1, dtype=np.int64)
    for r, _ in coords:
        counts[r + 1] += 1
    row_ptr = np.cumsum(counts).astype(np.int32)
    col_idx = np.asarray([c for _, c in coords], dtype=np.int32)
    return (torch.as_tensor(row_ptr, device=device),
            torch.as_tensor(col_idx, device=device))


def bsr_matmul_plain(sparse: torch.Tensor, dense: torch.Tensor, *,
                     coords: Coords, bm: int, bk: int, out_dtype
                     ) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: only the pattern's blocks of
    ``sparse`` enter (gather -> scatter), fp32 products and sums, one cast
    to ``out_dtype``; block-rows without a nonzero block select zeros."""
    m, k = sparse.shape
    masked = scatter_blocks(gather_blocks(sparse, coords, bm, bk),
                            coords, m, k)
    out = _fp32_product(masked, dense).to(out_dtype)
    present = _row_presence(coords, m // bm)
    if not present.all():
        rows = torch.as_tensor(np.repeat(present, bm), device=out.device)
        out = torch.where(rows[:, None], out,
                          torch.zeros((), dtype=out_dtype, device=out.device))
    return out


def bsr_matmul(sparse: torch.Tensor, dense: torch.Tensor, *,
               coords: Coords, bm: int, bk: int, bn: int,
               out_dtype=None,
               csr: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> torch.Tensor:
    """``C = sparse @ dense`` with ``sparse`` (m, k) block-sparse.

    ``sparse`` is passed dense-but-masked; only the blocks listed in
    ``coords`` (block-COO with (bm, bk) blocks) are read.  ``bn`` is the
    plan's stream block of n: semantics and cache identity, not the CTA
    tile — the kernel masks the ragged n edge itself, so n needs no
    padding.  ``csr`` passes the pattern's cached device arrays
    (:func:`csr_arrays`); without it they are built for this call.
    """
    if sparse.dim() != 2 or dense.dim() != 2:
        raise ValueError(f"bsr_matmul takes 2-D operands, got "
                         f"{tuple(sparse.shape)} x {tuple(dense.shape)}")
    (m, k), n = sparse.shape, dense.shape[1]
    if dense.shape[0] != k:
        raise ValueError(f"contraction mismatch: {tuple(sparse.shape)} x "
                         f"{tuple(dense.shape)}")
    if m % bm or k % bk:
        raise ValueError(f"sparse operand ({m},{k}) not tiled by blocks "
                         f"({bm},{bk})")
    if bn < 1:
        raise ValueError(f"bn must be positive, got {bn}")
    out_dtype = out_dtype or sparse.dtype
    coords = sort_coords(coords)
    cpu = _on_cpu(sparse, dense)
    if not coords:
        return torch.zeros((m, n), dtype=out_dtype, device=sparse.device)
    if cpu:
        return bsr_matmul_plain(sparse, dense, coords=coords, bm=bm, bk=bk,
                                out_dtype=out_dtype)
    if sparse.dtype != dense.dtype or sparse.dtype not in _DTYPE_CODES:
        raise ValueError(f"the BSR kernel takes float32 or bfloat16 "
                         f"operands of one dtype, got {sparse.dtype} x "
                         f"{dense.dtype}")
    if out_dtype != sparse.dtype:
        raise ValueError(f"the BSR kernel writes the input dtype "
                         f"{sparse.dtype}, got out_dtype={out_dtype}")
    if csr is None:
        csr = csr_arrays(coords, m // bm, sparse.device)
    row_ptr, col_idx = csr
    if (row_ptr.numel() != m // bm + 1 or col_idx.numel() != len(coords)
            or row_ptr.device != sparse.device):
        raise ValueError("csr arrays do not describe this pattern on this "
                         "device")
    out = torch.empty((m, n), dtype=out_dtype, device=sparse.device)
    lib = _build.library("bsr_gemm")
    _build.check(lib.bsr_launch(
        _DTYPE_CODES[sparse.dtype], sparse.data_ptr(), sparse.stride(0),
        sparse.stride(1), dense.data_ptr(), dense.stride(0), dense.stride(1),
        out.data_ptr(), row_ptr.data_ptr(), col_idx.data_ptr(), m, n, bm, bk,
        _stream()), "bsr_launch")
    launches["bsr"] += 1
    return out
