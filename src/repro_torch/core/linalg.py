"""Exact rational linear algebra for Space-Time Transformation analysis.

The dataflow classification predicates of TensorLib (``dt == 0``, ``dp == 0``,
subspace rank) must be decided *exactly* — floating point would misclassify
dataflows whose reuse vectors are small integers.  Everything here therefore
works over ``fractions.Fraction`` and returns canonical *integer* primitive
vectors where a direction is the answer.

Matrices are represented as tuples of tuples (immutable, hashable) so that
dataflow signatures can be used as dict keys during design-space enumeration.
"""
from __future__ import annotations

import math
from fractions import Fraction
from typing import Iterable, List, Sequence, Tuple

Vec = Tuple[Fraction, ...]
Mat = Tuple[Vec, ...]


# ---------------------------------------------------------------------------
# Construction helpers
# ---------------------------------------------------------------------------

def mat(rows: Iterable[Iterable]) -> Mat:
    """Build an exact matrix from any nested iterable of ints/Fractions."""
    return tuple(tuple(Fraction(v) for v in row) for row in rows)


def identity(n: int) -> Mat:
    return tuple(
        tuple(Fraction(1) if i == j else Fraction(0) for j in range(n))
        for i in range(n)
    )


def zeros(m: int, n: int) -> Mat:
    return tuple(tuple(Fraction(0) for _ in range(n)) for _ in range(m))


def shape(a: Mat) -> Tuple[int, int]:
    return (len(a), len(a[0]) if a else 0)


# ---------------------------------------------------------------------------
# Arithmetic
# ---------------------------------------------------------------------------

def matmul(a: Mat, b: Mat) -> Mat:
    (am, an), (bm, bn) = shape(a), shape(b)
    if an != bm:
        raise ValueError(f"matmul shape mismatch: {am}x{an} @ {bm}x{bn}")
    return tuple(
        tuple(sum((a[i][k] * b[k][j] for k in range(an)), Fraction(0))
              for j in range(bn))
        for i in range(am)
    )


def matvec(a: Mat, x: Sequence) -> Vec:
    (am, an) = shape(a)
    if an != len(x):
        raise ValueError(f"matvec shape mismatch: {am}x{an} @ {len(x)}")
    xv = [Fraction(v) for v in x]
    return tuple(sum((a[i][k] * xv[k] for k in range(an)), Fraction(0))
                 for i in range(am))


def transpose(a: Mat) -> Mat:
    m, n = shape(a)
    return tuple(tuple(a[i][j] for i in range(m)) for j in range(n))


def submatrix_cols(a: Mat, cols: Sequence[int]) -> Mat:
    """Select a subset of columns (used to restrict access matrices to the
    loop iterators chosen for space-time mapping)."""
    return tuple(tuple(row[c] for c in cols) for row in a)


# ---------------------------------------------------------------------------
# Gaussian elimination (exact)
# ---------------------------------------------------------------------------

def rref(a: Mat) -> Tuple[Mat, List[int]]:
    """Reduced row-echelon form.  Returns (R, pivot_columns)."""
    m, n = shape(a)
    rows = [list(r) for r in a]
    pivots: List[int] = []
    r = 0
    for c in range(n):
        if r >= m:
            break
        # find pivot
        piv = next((i for i in range(r, m) if rows[i][c] != 0), None)
        if piv is None:
            continue
        rows[r], rows[piv] = rows[piv], rows[r]
        inv = Fraction(1) / rows[r][c]
        rows[r] = [v * inv for v in rows[r]]
        for i in range(m):
            if i != r and rows[i][c] != 0:
                f = rows[i][c]
                rows[i] = [vi - f * vr for vi, vr in zip(rows[i], rows[r])]
        pivots.append(c)
        r += 1
    return tuple(tuple(row) for row in rows), pivots


def rank(a: Mat) -> int:
    return len(rref(a)[1])


def nullspace(a: Mat) -> List[Vec]:
    """Exact rational basis of the right nullspace of ``a``.

    Basis vectors are scaled to primitive integer vectors with a canonical
    sign so that reuse-direction comparisons are deterministic.
    """
    m, n = shape(a)
    if n == 0:
        return []
    r, pivots = rref(a)
    free = [c for c in range(n) if c not in pivots]
    basis: List[Vec] = []
    for fc in free:
        v = [Fraction(0)] * n
        v[fc] = Fraction(1)
        for i, pc in enumerate(pivots):
            v[pc] = -r[i][fc]
        basis.append(integerize(tuple(v)))
    return basis


def inverse(a: Mat) -> Mat:
    m, n = shape(a)
    if m != n:
        raise ValueError("inverse of non-square matrix")
    aug = tuple(tuple(list(a[i]) + list(identity(n)[i])) for i in range(n))
    r, pivots = rref(aug)
    if pivots != list(range(n)):
        raise ValueError("matrix is singular")
    return tuple(tuple(r[i][n:]) for i in range(n))


def det(a: Mat) -> Fraction:
    m, n = shape(a)
    if m != n:
        raise ValueError("determinant of non-square matrix")
    rows = [list(r) for r in a]
    d = Fraction(1)
    for c in range(n):
        piv = next((i for i in range(c, n) if rows[i][c] != 0), None)
        if piv is None:
            return Fraction(0)
        if piv != c:
            rows[c], rows[piv] = rows[piv], rows[c]
            d = -d
        d *= rows[c][c]
        inv = Fraction(1) / rows[c][c]
        for i in range(c + 1, n):
            if rows[i][c] != 0:
                f = rows[i][c] * inv
                rows[i] = [vi - f * vc for vi, vc in zip(rows[i], rows[c])]
    return d


def is_full_rank(a: Mat) -> bool:
    m, n = shape(a)
    return rank(a) == min(m, n)


# ---------------------------------------------------------------------------
# Vector utilities
# ---------------------------------------------------------------------------

def integerize(v: Vec) -> Vec:
    """Scale a rational vector to the primitive integer vector with canonical
    sign (first nonzero entry positive).  The zero vector maps to itself."""
    if all(x == 0 for x in v):
        return tuple(Fraction(0) for _ in v)
    lcm = 1
    for x in v:
        if x != 0:
            lcm = lcm * x.denominator // math.gcd(lcm, x.denominator)
    ints = [int(x * lcm) for x in v]
    g = 0
    for x in ints:
        g = math.gcd(g, abs(x))
    ints = [x // g for x in ints]
    first = next(x for x in ints if x != 0)
    if first < 0:
        ints = [-x for x in ints]
    return tuple(Fraction(x) for x in ints)


def in_span(v: Vec, basis: Sequence[Vec]) -> bool:
    """Exact membership test: is ``v`` in span(basis)?"""
    if all(x == 0 for x in v):
        return True
    if not basis:
        return False
    a = transpose(mat(list(basis)))
    aug = tuple(tuple(list(row) + [ve]) for row, ve in zip(a, v))
    return rank(a) == rank(aug)


def intersect_with_hyperplane(basis: Sequence[Vec], normal: Vec) -> List[Vec]:
    """Basis of span(basis) ∩ {x : normal·x = 0}.

    Used to find the space-only (dt = 0) directions inside a 2-D reuse plane,
    which decides the paper's three rank-2 sub-cases.
    """
    if not basis:
        return []
    # coefficients c s.t. sum_i c_i (normal · b_i) = 0
    dots = mat([[sum((n * b for n, b in zip(normal, bv)), Fraction(0))
                 for bv in basis]])
    coeff_basis = nullspace(dots)
    out: List[Vec] = []
    n = len(basis[0])
    for c in coeff_basis:
        v = [Fraction(0)] * n
        for ci, bv in zip(c, basis):
            for k in range(n):
                v[k] += ci * bv[k]
        out.append(integerize(tuple(v)))
    return out


def as_int_tuple(v: Vec) -> Tuple[int, ...]:
    """Convert an (already integral) exact vector to plain ints."""
    out = []
    for x in v:
        if x.denominator != 1:
            raise ValueError(f"vector {v} is not integral")
        out.append(int(x))
    return tuple(out)
