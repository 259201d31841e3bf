"""Shared tile-size selection for cost model and compiler.

``choose_tile`` used to be a private method of ``PaperCycleModel``; the
compile pipeline needs the *same* tile decision so the blocks a generated
kernel runs with are the blocks the cost model priced.  Factoring it here
is what keeps the two from drifting: the cost model delegates to this
module, and so does ``compile.lower``.

Also home to ``ArrayConfig`` (the paper's evaluation hardware, §VI-A) so
that both layers share one notion of the array geometry and the budget
of the operand-stationary template's strip accumulator.

PyTorch port: a copy of the reference's ``core/tiling.py``.  The one
change is the budget's name and meaning (see ``ArrayConfig``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from .algebra import TensorAlgebra
from .stt import Dataflow


@dataclasses.dataclass(frozen=True)
class ArrayConfig:
    """The paper's evaluation hardware (§VI-A) + the strip budget.

    ``strip_budget_bytes`` caps the per-batch-slice ``(m, bn)`` fp32 strip
    of the operand-stationary template.  On the TPU the strip lived in
    VMEM, so the reference calls this field ``vmem_budget_bytes``.  On
    Hopper the strip cannot live in shared memory (227 KB per block): it
    is a global fp32 workspace that the kernel read-modify-writes once
    per k-chunk, and it should stay resident in the 50 MB L2.  The value
    stays at the reference's 16 MiB so that ``ops.stt_matmul`` falls
    back from operand- to output-stationary on exactly the shapes the
    reference does; re-deriving it from Hopper measurements is later
    work.
    """

    pe_dims: Tuple[int, int] = (16, 16)
    freq_mhz: float = 320.0
    onchip_gbps: float = 32.0
    elem_bytes: int = 2            # INT16 for the DSE experiments
    #: cap on the operand-stationary strip workspace per batch slice,
    #: see kernels/stt_gemm.py
    strip_budget_bytes: int = 16 * 1024 * 1024

    @property
    def n_pes(self) -> int:
        return self.pe_dims[0] * self.pe_dims[1]

    @property
    def bytes_per_cycle(self) -> float:
        return self.onchip_gbps * 1e9 / (self.freq_mhz * 1e6)


def row_extent(row: Sequence, tile: Sequence[int]) -> int:
    """Extent of a linear form over the box [0, tile_j) — exact for boxes."""
    hi = 0
    lo = 0
    for coef, b in zip(row, tile):
        c = int(coef)
        if c > 0:
            hi += c * (b - 1)
        elif c < 0:
            lo += c * (b - 1)
    return hi - lo + 1


def is_unit_row(row: Sequence) -> Optional[int]:
    """Return the column index if the row is +/- a unit vector, else None."""
    nz = [j for j, v in enumerate(row) if v != 0]
    if len(nz) == 1 and abs(int(row[nz[0]])) == 1:
        return nz[0]
    return None


def choose_tile(alg: TensorAlgebra, df: Dataflow,
                pe_dims: Tuple[int, int] = (16, 16)
                ) -> Tuple[List[int], Tuple[int, int], float]:
    """Tile the selected loops so the PE footprint fits the array.

    Returns (tile bounds for selected loops, packed parallel copies per
    space dim, spatial utilization).
    """
    cols = [alg.loop_index(s) for s in df.selected]
    bounds = [alg.bounds[c] for c in cols]
    T = df.T
    n_space = df.n_space
    P = pe_dims

    tile = list(bounds)
    # Shrink loops (time-loop last) until every space extent fits.
    space_rows = [T[i] for i in range(n_space)]
    order = sorted(range(len(tile)),
                   key=lambda j: sum(abs(int(r[j])) for r in space_rows),
                   reverse=True)
    for i, r in enumerate(space_rows):
        ext = row_extent(r, tile)
        while ext > P[i]:
            j = next(jj for jj in order if int(r[jj]) != 0 and tile[jj] > 1)
            # the reference takes one unit off tile[j] at a time, each
            # taking |r[j]| off the extent, and stays on j until it fits
            # or tile[j] is 1: take all of those steps at once (the same
            # tile, without a loop as long as the bound)
            c = abs(int(r[j]))
            tile[j] -= min(tile[j] - 1, -(-(ext - P[i]) // c))
            ext = row_extent(r, tile)

    # Packing: if a unit space row's loop bound is below the array dim,
    # replicate the tile along that dim (the paper's p=3 -> 15 rows).
    copies = [1, 1]
    for i, r in enumerate(space_rows):
        j = is_unit_row(r)
        ext = row_extent(r, tile)
        if j is not None and ext < P[i]:
            copies[i] = max(1, P[i] // ext)
    util_num = 1.0
    for i, r in enumerate(space_rows):
        ext = row_extent(r, tile)
        util_num *= min(P[i], ext * copies[i]) / P[i]
    return tile, (copies[0], copies[1]), util_num


def tile_by_loop(alg: TensorAlgebra, df: Dataflow,
                 pe_dims: Tuple[int, int] = (16, 16)) -> Dict[str, int]:
    """Per-loop tile bounds: chosen tile for selected loops, full bound for
    the sequential (outer) loops.  This is the form the compiler consumes
    when mapping loop tiles onto GEMM block sizes."""
    tile, _, _ = choose_tile(alg, df, pe_dims)
    out = {name: alg.bounds[i] for i, name in enumerate(alg.loops)}
    for name, t in zip(df.selected, tile):
        out[name] = t
    return out


def form_blocks(alg: TensorAlgebra, df: Dataflow, form,
                pe_dims: Tuple[int, int] = (16, 16)
                ) -> Tuple[int, int, int]:
    """Map the STT tile onto a lowered form's (bm, bn, bk) block sizes.

    Batch-aware: loops folded onto the form's leading batch grid dims
    (``form.dim_loops["b"]``) are executed one slice per grid step and
    therefore never inflate any GEMM block — in particular not the
    contraction, which is what made the retired block-diagonal lowering
    execute batch x the algebra's MACs.  Each remaining GEMM dim's block
    is the product of the tiles of the loops it folds, clamped to the dim
    extent.

    The per-batch-slice consequence matters for the strip budget too:
    the operand-stationary strip accumulator is (per-slice m, bn) fp32,
    so the budget check in ``kernels/ops.stt_matmul`` sees the slice
    extent, not batch x it.
    """
    per_loop = tile_by_loop(alg, df, pe_dims)
    out = []
    for dim, full in (("m", form.m), ("n", form.n), ("k", form.k)):
        blk = 1
        for loop in form.dim_loops.get(dim, ()):
            blk *= per_loop[loop]
        out.append(max(1, min(blk, full)))
    return (out[0], out[1], out[2])
