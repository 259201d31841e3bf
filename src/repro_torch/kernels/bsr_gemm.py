"""Block-sparse (block-COO) GEMM — the port of the reference's
``kernels/bsr_gemm.py``.

``C = S @ D`` with ``S`` (m, k) block-sparse in (bm, bk) blocks.  The
reference's Pallas grid iterates only the nonzero blocks of a row-major
coordinate list, in order, resetting its accumulator on every block-row
change.  The CUDA kernel (``csrc/bsr_gemm.cu``) has no ordered grid: the
pattern reaches it as CSR row pointers and block-column indices (int32
device arrays, :func:`csr_arrays`), and :func:`launch_plan` lays out the
launch.  It picks the CTA tile (128 x 128 where that divides bm and fills
a wave of the card's SMs, else 64 x 64) and cuts each block-row into
``cdiv(bm, tile)`` sub-tiles, so a tile never straddles two block-rows.
It orders the (block-row, sub-tile) work items heaviest block-row
first, and the kernel runs all n tiles of an item together.  Each CTA
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

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build
from ..core.hopper import H100
from .stt_gemm import (LATER_TRAINING, _DTYPE_CODES, _fp32_product,
                       _no_backward, _on_cpu, _stream)

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


# ---------------------------------------------------------------------------
# the launch plan: tile, sub-tiles, work order, staging
# ---------------------------------------------------------------------------

#: CTA tile edges the kernel instantiates (``bsr_launch_t<T, TILE>``)
WIDE, NARROW = 128, 64
#: the plan's work order (read at each call): "heaviest" runs block-rows
#: by nonzero count, descending; "raster" in block-row order
ORDER = "heaviest"


class LaunchPlan(NamedTuple):
    """One pattern's launch: a CTA a (work item, n tile), n tiles
    fastest.  Item ``i`` is block-row ``i // subtiles``, rows ``(i %
    subtiles) * tile`` .. ``+ tile`` of it (masked at its end).
    ``k_vec`` / ``m_vec``: every slab of a block starts on a whole
    4-element step along k (``bk % 4 == 0``) / every block-row along m
    (``bm % 4 == 0``), so that 16-byte staging loads stay aligned."""
    tile: int
    subtiles: int
    n_tiles: int
    row_nnz: Tuple[int, ...]   # nonzero blocks of each block-row
    order: Tuple[int, ...]     # the items, in launch order
    k_vec: bool
    m_vec: bool

    @property
    def ctas(self) -> int:
        return len(self.order) * self.n_tiles

    def describe(self) -> str:
        """Tile, grid and the first items as ``r<block-row>:<nnz>``."""
        rows = [i // self.subtiles for i in self.order[:6]]
        head = " ".join(f"r{r}:{self.row_nnz[r]}" for r in rows)
        return (f"tile {self.tile}, {self.ctas} CTAs ({len(self.order)} "
                f"items x {self.n_tiles} n tiles), order head {head}"
                f"{' ...' if len(self.order) > 6 else ''}")


def launch_plan(coords: Coords, bm: int, bk: int, m: int, n: int,
                order: str = "heaviest") -> LaunchPlan:
    """Lay out the kernel's launch for ``coords`` (sorted row-major) on an
    (m, k) sparse operand of (bm, bk) blocks and n output columns: the
    128 tile where it divides bm and its grid covers the card's SMs, else
    the 64 tile; items heaviest block-row first (a stable sort, so ties
    keep row order and empty rows come last) or in raster order.  Pure:
    the CPU tests check it."""
    if order not in ("heaviest", "raster"):
        raise ValueError(f"order must be 'heaviest' or 'raster', got "
                         f"{order!r}")
    rows = m // bm
    nnz = [0] * rows
    for r, _ in coords:
        nnz[r] += 1
    tile = NARROW
    if bm % WIDE == 0 and rows * (bm // WIDE) * -(-n // WIDE) >= H100.sms:
        tile = WIDE
    subtiles = -(-bm // tile)
    items = range(rows * subtiles)
    if order == "heaviest":
        items = sorted(items, key=lambda i: -nnz[i // subtiles])
    return LaunchPlan(tile, subtiles, -(-n // tile), tuple(nnz),
                      tuple(items), bk % 4 == 0, bm % 4 == 0)


#: plans by (pattern, blocks, shape, order), and their order arrays by
#: device: built once, never copied from the host again
_cached_plan = functools.lru_cache(maxsize=256)(launch_plan)


@functools.lru_cache(maxsize=256)
def _order_array(plan: LaunchPlan, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(plan.order, dtype=np.int32),
                           device=device)


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
    _no_backward("the BSR kernel", LATER_TRAINING, sparse, dense)
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
    plan = _cached_plan(coords, bm, bk, m, n, ORDER)
    order = _order_array(plan, sparse.device)
    out = torch.empty((m, n), dtype=out_dtype, device=sparse.device)
    lib = _build.library("bsr_gemm")
    _build.check(lib.bsr_launch(
        _DTYPE_CODES[sparse.dtype], sparse.data_ptr(), sparse.stride(0),
        sparse.stride(1), dense.data_ptr(), dense.stride(0), dense.stride(1),
        out.data_ptr(), row_ptr.data_ptr(), col_idx.data_ptr(),
        order.data_ptr(), m, n, bm, bk, plan.tile, int(plan.k_vec),
        int(plan.m_vec), _stream()), "bsr_launch")
    launches["bsr"] += 1
    return out
