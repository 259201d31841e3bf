"""Tensor-algebra IR: perfect nested loops + per-tensor linear access maps.

This is TensorLib's input language (paper §II, Table II).  A computation is

    out[I_out] += in1[I_1] * in2[I_2] * ...

where every index vector is a *linear* function of the loop iteration vector:
``I = A·x`` with an integer access matrix ``A``.  Affine accesses such as the
convolution's ``y + p`` are linear in the loop vector (a row with two ones),
so the whole of Table II fits without affine offsets.

The IR carries concrete loop bounds so the same object drives
  * exact dataflow classification (access matrices only),
  * the cycle-accurate-ish cost model (bounds),
  * a functional space-time simulator used to *prove* a schedule computes the
    right thing (tests), and
  * reference evaluation in numpy for oracle checks.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from . import linalg
from .linalg import Mat


@dataclasses.dataclass(frozen=True)
class Sparsity:
    """Block-sparse operand descriptor: a block-COO coordinate list.

    The tensor is partitioned into dense blocks of shape ``block`` (one
    entry per tensor dimension, each dividing the tensor extent); only the
    blocks listed in ``coords`` hold data, everything else is exactly zero.
    Block granularity is what lets the dense GEMM templates run unchanged
    *inside* each block while the kernel grid skips the zero blocks — the
    same compose-with-dataflows argument the Sparse Abstract Machine and
    TeAAL make for compressed operand formats.

    ``coords`` is kept sorted row-major and duplicate-free so downstream
    consumers (the Pallas grid index-map, accumulation-order proofs) can
    rely on a canonical order.
    """

    block: Tuple[int, ...]
    coords: Tuple[Tuple[int, ...], ...]

    def __post_init__(self):
        if not self.block or any(b < 1 for b in self.block):
            raise ValueError(f"block shape must be positive, got {self.block}")
        canon = tuple(sorted(set(tuple(int(i) for i in c)
                                 for c in self.coords)))
        if any(len(c) != len(self.block) for c in canon):
            raise ValueError("coordinate rank != block rank")
        object.__setattr__(self, "coords", canon)

    @property
    def nnz_blocks(self) -> int:
        return len(self.coords)

    def grid(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """Block-grid shape for a concrete tensor shape (validates that the
        blocks tile the tensor exactly and that every coordinate is in
        range)."""
        if len(shape) != len(self.block):
            raise ValueError(f"tensor rank {len(shape)} != block rank "
                             f"{len(self.block)}")
        for s, b in zip(shape, self.block):
            if s % b:
                raise ValueError(f"block {self.block} does not tile tensor "
                                 f"shape {tuple(shape)}")
        g = tuple(s // b for s, b in zip(shape, self.block))
        for c in self.coords:
            if any(not 0 <= ci < gi for ci, gi in zip(c, g)):
                raise ValueError(f"block coordinate {c} outside grid {g}")
        return g

    def density(self, shape: Sequence[int]) -> float:
        total = 1
        for gi in self.grid(shape):
            total *= gi
        return self.nnz_blocks / total if total else 0.0

    def block_mask(self, shape: Sequence[int]) -> np.ndarray:
        """Boolean nonzero-block mask over the block grid."""
        mask = np.zeros(self.grid(shape), dtype=bool)
        for c in self.coords:
            mask[c] = True
        return mask

    def element_mask(self, shape: Sequence[int]) -> np.ndarray:
        """Boolean mask at element granularity (the masked dense oracle's
        view of this pattern)."""
        mask = self.block_mask(shape)
        for axis, b in enumerate(self.block):
            mask = np.repeat(mask, b, axis=axis)
        return mask

    @staticmethod
    def random(shape: Sequence[int], block: Sequence[int], density: float,
               seed: int = 0) -> "Sparsity":
        """Deterministic random pattern: ``round(density * n_blocks)``
        blocks (at least one when density > 0) drawn without replacement
        from ``default_rng(seed)``."""
        if not 0.0 <= density <= 1.0:
            raise ValueError(f"density must be in [0, 1], got {density}")
        sp = Sparsity(tuple(int(b) for b in block), ())
        grid = sp.grid(shape)
        total = 1
        for g in grid:
            total *= g
        nnz = min(total, max(1, round(density * total))) if density > 0 else 0
        rng = np.random.default_rng(seed)
        flat = rng.choice(total, size=nnz, replace=False)
        coords = tuple(tuple(int(i) for i in np.unravel_index(f, grid))
                       for f in sorted(flat))
        return Sparsity(sp.block, coords)


@dataclasses.dataclass(frozen=True)
class TensorAccess:
    """One tensor operand of the algebra.

    ``access`` has one row per tensor dimension and one column per loop
    iterator: ``index = access @ x``.
    """

    name: str
    access: Mat                    # (tensor_rank, n_loops) exact matrix
    is_output: bool = False

    def rank(self) -> int:
        return len(self.access)

    def index_of(self, x: Sequence[int]) -> Tuple[int, ...]:
        return linalg.as_int_tuple(linalg.matvec(self.access, list(x)))


@dataclasses.dataclass(frozen=True)
class TensorAlgebra:
    """A perfect loop nest computing ``output += prod(inputs)``."""

    name: str
    loops: Tuple[str, ...]               # iterator names, outermost first
    bounds: Tuple[int, ...]              # concrete loop trip counts
    tensors: Tuple[TensorAccess, ...]    # inputs first, output last
    #: per-tensor block-sparse operand form, sorted (name, Sparsity) pairs —
    #: a tuple (not a dict) so the algebra stays hashable and keeps working
    #: as the compile-cache / memoization key
    sparsity: Tuple[Tuple[str, Sparsity], ...] = ()

    def __post_init__(self):
        assert len(self.loops) == len(self.bounds)
        assert sum(t.is_output for t in self.tensors) == 1
        for t in self.tensors:
            for row in t.access:
                assert len(row) == len(self.loops), (self.name, t.name)
        names = {t.name for t in self.tensors}
        for tname, _ in self.sparsity:
            assert tname in names, (self.name, tname)

    # -- convenience ------------------------------------------------------
    @property
    def output(self) -> TensorAccess:
        return next(t for t in self.tensors if t.is_output)

    @property
    def inputs(self) -> Tuple[TensorAccess, ...]:
        return tuple(t for t in self.tensors if not t.is_output)

    def loop_index(self, name: str) -> int:
        return self.loops.index(name)

    def total_macs(self) -> int:
        n = 1
        for b in self.bounds:
            n *= b
        return n

    def with_bounds(self, **bounds: int) -> "TensorAlgebra":
        new = list(self.bounds)
        for k, v in bounds.items():
            new[self.loop_index(k)] = v
        return dataclasses.replace(self, bounds=tuple(new))

    # -- block-sparse operand form ----------------------------------------
    def with_sparsity(self, **per_tensor: Optional[Sparsity]
                      ) -> "TensorAlgebra":
        """Attach (or, with ``None``, remove) a block-sparse pattern to
        input tensors.  Patterns are validated against the current bounds:
        the block must tile the tensor shape exactly and every coordinate
        must lie inside the block grid."""
        cur = dict(self.sparsity)
        by_name = {t.name: t for t in self.tensors}
        for name, sp in per_tensor.items():
            t = by_name.get(name)
            if t is None:
                raise ValueError(f"{self.name} has no tensor {name!r}; "
                                 f"tensors: {sorted(by_name)}")
            if sp is None:
                cur.pop(name, None)
                continue
            if t.is_output:
                raise ValueError(
                    f"sparsity on output tensor {name!r} is unsupported "
                    "(outputs of a sum-of-products are dense in general)")
            sp.grid(self.tensor_shape(t))   # validates block/coords vs shape
            cur[name] = sp
        return dataclasses.replace(self, sparsity=tuple(sorted(cur.items())))

    def sparsity_of(self, name: str) -> Optional[Sparsity]:
        return dict(self.sparsity).get(name)

    @property
    def is_sparse(self) -> bool:
        return bool(self.sparsity)

    def density_of(self, name: str) -> float:
        """Block-level density of a tensor (1.0 when it has no pattern)."""
        sp = self.sparsity_of(name)
        if sp is None:
            return 1.0
        t = next(t for t in self.tensors if t.name == name)
        return sp.density(self.tensor_shape(t))

    def tensor_shape(self, t: TensorAccess) -> Tuple[int, ...]:
        """Bounding-box shape of a tensor given the loop bounds (affine
        accesses like y+p make a dim as large as the sum of the bounds)."""
        dims = []
        for row in t.access:
            hi = 0
            for coef, b in zip(row, self.bounds):
                c = int(coef)
                if c > 0:
                    hi += c * (b - 1)
                elif c < 0:
                    raise ValueError("negative access coefficients unsupported")
            dims.append(hi + 1)
        return tuple(dims)

    # -- reference evaluation ----------------------------------------------
    def reference(self, operands: Dict[str, np.ndarray]) -> np.ndarray:
        """Evaluate the loop nest directly in numpy (oracle; small bounds)."""
        out = np.zeros(self.tensor_shape(self.output),
                       dtype=np.result_type(*[v.dtype for v in operands.values()]))
        for x in itertools.product(*[range(b) for b in self.bounds]):
            prod = None
            for t in self.inputs:
                v = operands[t.name][t.index_of(x)]
                prod = v if prod is None else prod * v
            out[self.output.index_of(x)] += prod
        return out

    def random_operands(self, seed: int = 0) -> Dict[str, np.ndarray]:
        """Random integer operands; sparse tensors are zero outside their
        nonzero blocks, so ``reference`` on these operands *is* the masked
        dense oracle every sparse execution path validates against."""
        rng = np.random.default_rng(seed)
        out = {}
        for t in self.inputs:
            v = rng.integers(-4, 5, size=self.tensor_shape(t)).astype(np.int64)
            sp = self.sparsity_of(t.name)
            if sp is not None:
                v = v * sp.element_mask(self.tensor_shape(t))
            out[t.name] = v
        return out

    def random_sparse_inputs(self, seed: int = 0) -> Dict[str, np.ndarray]:
        """Deterministic operands honouring every attached block-sparse
        pattern (alias of ``random_operands``, which applies the masks
        whenever patterns are present — named per the sparse API surface)."""
        return self.random_operands(seed)


# ---------------------------------------------------------------------------
# Table II — the six evaluated tensor algebras
# ---------------------------------------------------------------------------

def _acc(loops: Sequence[str], rows: Sequence[Dict[str, int]]) -> Mat:
    return linalg.mat(
        [[row.get(l, 0) for l in loops] for row in rows]
    )


def gemm(m: int = 64, n: int = 64, k: int = 64) -> TensorAlgebra:
    """C[m,n] += A[m,k] * B[n,k]   (paper's GEMM layout)."""
    loops = ("m", "n", "k")
    return TensorAlgebra(
        name="gemm", loops=loops, bounds=(m, n, k),
        tensors=(
            TensorAccess("A", _acc(loops, [{"m": 1}, {"k": 1}])),
            TensorAccess("B", _acc(loops, [{"n": 1}, {"k": 1}])),
            TensorAccess("C", _acc(loops, [{"m": 1}, {"n": 1}]), is_output=True),
        ),
    )


def batched_gemv(m: int = 16, k: int = 64, n: int = 64) -> TensorAlgebra:
    """C[m,n] += A[m,k,n] * B[m,k].  Tensor A has no reuse (unicast only)."""
    loops = ("m", "n", "k")
    return TensorAlgebra(
        name="batched_gemv", loops=loops, bounds=(m, n, k),
        tensors=(
            TensorAccess("A", _acc(loops, [{"m": 1}, {"k": 1}, {"n": 1}])),
            TensorAccess("B", _acc(loops, [{"m": 1}, {"k": 1}])),
            TensorAccess("C", _acc(loops, [{"m": 1}, {"n": 1}]), is_output=True),
        ),
    )


def conv2d(k: int = 64, c: int = 64, y: int = 14, x: int = 14,
           p: int = 3, q: int = 3) -> TensorAlgebra:
    """C[k,y,x] += A[c,y+p,x+q] * B[k,c,p,q]."""
    loops = ("k", "c", "y", "x", "p", "q")
    return TensorAlgebra(
        name="conv2d", loops=loops, bounds=(k, c, y, x, p, q),
        tensors=(
            TensorAccess("A", _acc(loops, [{"c": 1}, {"y": 1, "p": 1},
                                           {"x": 1, "q": 1}])),
            TensorAccess("B", _acc(loops, [{"k": 1}, {"c": 1}, {"p": 1},
                                           {"q": 1}])),
            TensorAccess("C", _acc(loops, [{"k": 1}, {"y": 1}, {"x": 1}]),
                         is_output=True),
        ),
    )


def depthwise_conv(k: int = 64, y: int = 14, x: int = 14,
                   p: int = 3, q: int = 3) -> TensorAlgebra:
    """C[k,y,x] += A[k,y+p,x+q] * B[k,p,q].  No large reduction dim."""
    loops = ("k", "y", "x", "p", "q")
    return TensorAlgebra(
        name="depthwise_conv", loops=loops, bounds=(k, y, x, p, q),
        tensors=(
            TensorAccess("A", _acc(loops, [{"k": 1}, {"y": 1, "p": 1},
                                           {"x": 1, "q": 1}])),
            TensorAccess("B", _acc(loops, [{"k": 1}, {"p": 1}, {"q": 1}])),
            TensorAccess("C", _acc(loops, [{"k": 1}, {"y": 1}, {"x": 1}]),
                         is_output=True),
        ),
    )


def mttkrp(i: int = 32, j: int = 32, k: int = 16, l: int = 16) -> TensorAlgebra:
    """D[i,j] += A[i,k,l] * B[k,j] * C[l,j]."""
    loops = ("i", "j", "k", "l")
    return TensorAlgebra(
        name="mttkrp", loops=loops, bounds=(i, j, k, l),
        tensors=(
            TensorAccess("A", _acc(loops, [{"i": 1}, {"k": 1}, {"l": 1}])),
            TensorAccess("B", _acc(loops, [{"k": 1}, {"j": 1}])),
            TensorAccess("C", _acc(loops, [{"l": 1}, {"j": 1}])),
            TensorAccess("D", _acc(loops, [{"i": 1}, {"j": 1}]), is_output=True),
        ),
    )


def ttmc(i: int = 16, j: int = 16, k: int = 16, l: int = 16,
         m: int = 16) -> TensorAlgebra:
    """D[i,j,k] += A[i,l,m] * B[l,j] * C[m,k]."""
    loops = ("i", "j", "k", "l", "m")
    return TensorAlgebra(
        name="ttmc", loops=loops, bounds=(i, j, k, l, m),
        tensors=(
            TensorAccess("A", _acc(loops, [{"i": 1}, {"l": 1}, {"m": 1}])),
            TensorAccess("B", _acc(loops, [{"l": 1}, {"j": 1}])),
            TensorAccess("C", _acc(loops, [{"m": 1}, {"k": 1}])),
            TensorAccess("D", _acc(loops, [{"i": 1}, {"j": 1}, {"k": 1}]),
                         is_output=True),
        ),
    )


PAPER_ALGEBRAS = {
    "gemm": gemm,
    "batched_gemv": batched_gemv,
    "conv2d": conv2d,
    "depthwise_conv": depthwise_conv,
    "mttkrp": mttkrp,
    "ttmc": ttmc,
}


def get_algebra(name: str, **bounds) -> TensorAlgebra:
    return PAPER_ALGEBRAS[name](**bounds)
