"""Space-Time Transformation: dataflow generation (paper §II and §IV).

Given a tensor algebra and a full-rank integer matrix ``T`` over a selection
of ``n_space + 1`` loop iterators, every loop instance ``x`` is mapped to a
space-time point ``[p; t] = T · x``.  For each tensor with (selected-loop)
access matrix ``A``, the set of loop instances touching one element differs
by ``null(A)``, so the *reuse subspace* in space-time coordinates is

    R = T · null(A_sel)          (equivalent to the paper's Eq. (3))

Classification (paper Table I) is by ``rank(R)`` and the orientation of its
basis vectors ``(dp, dt)``:

    rank 0                      -> UNICAST
    rank 1, dp = 0, dt != 0     -> STATIONARY
    rank 1, dp != 0, dt != 0    -> SYSTOLIC   (direction dp, delay dt)
    rank 1, dp != 0, dt  = 0    -> MULTICAST (input) / REDUCTION tree (output)
    rank 2, plane ⊥ t-axis      -> BROADCAST              (2-D multicast)
    rank 2, t-axis ∈ plane      -> MULTICAST_STATIONARY
    rank 2, otherwise           -> SYSTOLIC_MULTICAST

All predicates are decided exactly over the rationals (see ``linalg``).
"""
from __future__ import annotations

import dataclasses
import enum
import functools
import itertools
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple

from . import linalg
from .algebra import TensorAlgebra
from .linalg import Mat, Vec


class DataflowClass(enum.Enum):
    UNICAST = "unicast"
    STATIONARY = "stationary"
    SYSTOLIC = "systolic"
    MULTICAST = "multicast"          # input tensors, rank-1, dt = 0
    REDUCTION = "reduction"          # output tensors, rank-1, dt = 0
    BROADCAST = "broadcast"                      # rank-2, plane ⊥ t-axis
    MULTICAST_STATIONARY = "multicast_stationary"  # rank-2, t-axis in plane
    SYSTOLIC_MULTICAST = "systolic_multicast"      # rank-2, intersecting

    @property
    def letter(self) -> str:
        """Single-letter code used in paper-style dataflow names."""
        return {
            DataflowClass.UNICAST: "U",
            DataflowClass.STATIONARY: "T",
            DataflowClass.SYSTOLIC: "S",
            DataflowClass.MULTICAST: "M",
            DataflowClass.REDUCTION: "M",   # paper folds reduction under M
            DataflowClass.BROADCAST: "B",
            DataflowClass.MULTICAST_STATIONARY: "B",
            DataflowClass.SYSTOLIC_MULTICAST: "B",
        }[self]

    @property
    def is_2d(self) -> bool:
        return self in (DataflowClass.BROADCAST,
                        DataflowClass.MULTICAST_STATIONARY,
                        DataflowClass.SYSTOLIC_MULTICAST)


@dataclasses.dataclass(frozen=True)
class TensorDataflow:
    """Classification result for one tensor under one STT."""

    tensor: str
    cls: DataflowClass
    # rank-1 (and the 1-D components of rank-2) carry a reuse direction:
    dp: Tuple[int, ...] = ()     # PE-array direction of movement
    dt: int = 0                  # cycle delay along dp
    # rank-2 cases carry the space-only (multicast/broadcast) direction too:
    dp_multicast: Tuple[int, ...] = ()
    reuse_rank: int = 0

    @property
    def signature(self) -> Tuple:
        return (self.cls.value, self.dp, self.dt, self.dp_multicast)


@dataclasses.dataclass(frozen=True)
class Dataflow:
    """A complete dataflow: STT matrix + per-tensor classification."""

    algebra_name: str
    selected: Tuple[str, ...]            # loop names mapped to (p..., t)
    T: Mat                               # (n_space+1) x (n_space+1), full rank
    tensors: Tuple[TensorDataflow, ...]  # same order as algebra.tensors

    @property
    def n_space(self) -> int:
        return len(self.selected) - 1

    @property
    def name(self) -> str:
        """Paper-style name, e.g. ``MNK-MMT`` (selected loops + letters,
        inputs in formula order then output)."""
        letters = "".join(t.cls.letter for t in self.tensors)
        return f"{''.join(self.selected).upper()}-{letters}"

    def by_tensor(self) -> Dict[str, TensorDataflow]:
        return {t.tensor: t for t in self.tensors}

    @property
    def signature(self) -> Tuple:
        """Hashable identity used to dedupe the design space: what hardware
        gets generated (classes + interconnect directions), not which T
        produced it."""
        return tuple(t.signature for t in self.tensors)


# ---------------------------------------------------------------------------
# Classification core
# ---------------------------------------------------------------------------

def classify_reuse(basis: Sequence[Vec], n_space: int,
                   is_output: bool) -> TensorDataflow:
    """Classify a reuse subspace given an exact basis in space-time coords."""
    rank = len(basis)
    if rank == 0:
        return TensorDataflow("", DataflowClass.UNICAST, reuse_rank=0)

    if rank == 1:
        v = linalg.integerize(basis[0])
        dp = linalg.as_int_tuple(v[:n_space])
        dt = int(v[n_space])
        # canonical orientation: positive delay (data flows forward in time)
        if dt < 0:
            dp = tuple(-d for d in dp)
            dt = -dt
        if all(d == 0 for d in dp):
            return TensorDataflow("", DataflowClass.STATIONARY, dp, dt,
                                  reuse_rank=1)
        if dt != 0:
            return TensorDataflow("", DataflowClass.SYSTOLIC, dp, dt,
                                  reuse_rank=1)
        cls = DataflowClass.REDUCTION if is_output else DataflowClass.MULTICAST
        return TensorDataflow("", cls, dp, dt, reuse_rank=1)

    if rank == 2:
        # space-only directions inside the plane: R ∩ {dt = 0}
        t_normal = tuple([Fraction(0)] * n_space + [Fraction(1)])
        space_only = linalg.intersect_with_hyperplane(basis, t_normal)
        if len(space_only) == 2:
            # plane is {dt = 0}: same element everywhere at the same cycle
            return TensorDataflow("", DataflowClass.BROADCAST,
                                  dp_multicast=linalg.as_int_tuple(
                                      space_only[0][:n_space]),
                                  reuse_rank=2)
        assert len(space_only) == 1, "2-D plane must meet {dt=0} in >=1 dim"
        mc_dir = linalg.as_int_tuple(space_only[0][:n_space])
        t_axis = tuple([Fraction(0)] * n_space + [Fraction(1)])
        if linalg.in_span(t_axis, basis):
            # plane parallel to (containing) the t-axis: broadcast to a PE
            # group, then each element stays put -> multicast + stationary
            return TensorDataflow("", DataflowClass.MULTICAST_STATIONARY,
                                  dp=tuple(0 for _ in range(n_space)), dt=1,
                                  dp_multicast=mc_dir, reuse_rank=2)
        # generic plane: broadcast + systolic traversal.  Pick the systolic
        # component as a basis vector independent of the multicast direction
        # with minimal |dt| (canonical).
        best: Optional[Tuple[Tuple[int, ...], int]] = None
        for c0, c1 in ((1, 0), (0, 1), (1, 1), (1, -1)):
            v = tuple(c0 * a + c1 * b for a, b in zip(basis[0], basis[1]))
            v = linalg.integerize(v)
            dt = int(v[n_space])
            if dt == 0:
                continue
            dp = linalg.as_int_tuple(v[:n_space])
            if dt < 0:
                dp, dt = tuple(-d for d in dp), -dt
            if best is None or dt < best[1]:
                best = (dp, dt)
        assert best is not None
        return TensorDataflow("", DataflowClass.SYSTOLIC_MULTICAST,
                              dp=best[0], dt=best[1],
                              dp_multicast=mc_dir, reuse_rank=2)

    raise ValueError(f"reuse subspace of rank {rank} exceeds the 2-D PE array "
                     "model (paper handles rank <= 2)")


# ---------------------------------------------------------------------------
# STT application
# ---------------------------------------------------------------------------

class InvalidSTT(ValueError):
    pass


@functools.lru_cache(maxsize=None)
def selection_nullspaces(alg: TensorAlgebra, selected: Tuple[str, ...]
                         ) -> Tuple[Tuple[str, bool, Tuple[Vec, ...]], ...]:
    """Per-tensor ``(name, is_output, null(A_sel))`` for one loop selection.

    The nullspace of the selected-loop access matrix does *not* depend on T
    — only its image under T does — so during design-space enumeration the
    (rref-heavy) nullspace computation is shared across every candidate T
    for a selection.  ``TensorAlgebra`` is a frozen dataclass of hashable
    tuples, so memoization on the algebra itself is exact.
    """
    cols = [alg.loop_index(s) for s in selected]
    out = []
    for t in alg.tensors:
        a_sel = linalg.submatrix_cols(t.access, cols)
        out.append((t.name, t.is_output, tuple(linalg.nullspace(a_sel))))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def classify_reuse_cached(basis: Tuple[Vec, ...], n_space: int,
                          is_output: bool) -> TensorDataflow:
    """Memoized ``classify_reuse``: keyed on the transformed reuse basis.

    Many distinct T matrices induce the same space-time reuse basis; the
    rank-2 sub-case analysis (hyperplane intersections, span tests) then
    runs once per distinct basis instead of once per T.
    """
    return classify_reuse(list(basis), n_space, is_output)


def apply_stt(alg: TensorAlgebra, selected: Sequence[str],
              T: Mat) -> Dataflow:
    """Run TensorLib's dataflow-generation step (paper Fig. 2, left half).

    ``selected`` are the loop iterators mapped to space-time, ordered
    ``(p1, ..., pn, t)`` *before* transformation by ``T``;  the remaining
    loops run sequentially outside the PE array and do not affect the PE
    dataflow (paper §IV).
    """
    k = len(selected)
    if linalg.shape(T) != (k, k):
        raise InvalidSTT(f"T must be {k}x{k} for {k} selected loops")
    if linalg.det(T) == 0:
        raise InvalidSTT("T must be full rank (one-to-one space-time mapping)")
    n_space = k - 1

    out: List[TensorDataflow] = []
    for name, is_output, null in selection_nullspaces(alg, tuple(selected)):
        # reuse subspace in space-time coordinates: R = T · null(A_sel)
        basis = tuple(linalg.integerize(linalg.matvec(T, v)) for v in null)
        df = classify_reuse_cached(basis, n_space, is_output)
        out.append(dataclasses.replace(df, tensor=name))
    return Dataflow(alg.name, tuple(selected), T, tuple(out))


# ---------------------------------------------------------------------------
# Space-time execution simulator (validates the one-to-one mapping and that
# a schedule really computes the algebra — used by tests and the cost model)
# ---------------------------------------------------------------------------

def simulate(alg: TensorAlgebra, selected: Sequence[str], T: Mat):
    """Execute the loop nest in space-time order on a virtual PE array.

    Returns (result, n_cycles, pe_extent).  Raises if two operations collide
    on the same (PE, cycle) — which full-rank T must prevent — making this a
    direct check of the paper's one-to-one mapping claim.
    """
    import numpy as np

    cols = [alg.loop_index(s) for s in selected]
    outer = [i for i in range(len(alg.loops)) if i not in cols]
    n_space = len(selected) - 1

    operands = alg.random_operands()
    out = np.zeros(alg.tensor_shape(alg.output), dtype=np.int64)

    pts: Dict[Tuple, Tuple] = {}
    lo = [0] * n_space
    hi = [0] * n_space
    tmin, tmax = 0, 0
    for x in itertools.product(*[range(alg.bounds[c]) for c in cols]):
        st = linalg.as_int_tuple(linalg.matvec(T, list(x)))
        p, t = st[:n_space], st[n_space]
        for d in range(n_space):
            lo[d] = min(lo[d], p[d])
            hi[d] = max(hi[d], p[d])
        tmin, tmax = min(tmin, t), max(tmax, t)
        if (p, t) in pts:
            raise InvalidSTT(f"collision at PE {p} cycle {t}")
        pts[(p, t)] = x

    for x_outer in itertools.product(*[range(alg.bounds[i]) for i in outer]):
        for (p, t), x_sel in pts.items():
            full = [0] * len(alg.loops)
            for i, c in enumerate(cols):
                full[c] = x_sel[i]
            for i, c in enumerate(outer):
                full[c] = x_outer[i]
            prod = None
            for ten in alg.inputs:
                v = operands[ten.name][ten.index_of(full)]
                prod = v if prod is None else prod * v
            out[alg.output.index_of(full)] += prod

    pe_extent = tuple(h - l + 1 for l, h in zip(lo, hi))
    n_cycles = tmax - tmin + 1
    ref = alg.reference(operands)
    if not np.array_equal(out, ref):
        raise AssertionError("space-time execution diverged from reference")
    return out, n_cycles, pe_extent


# ---------------------------------------------------------------------------
# Named STT matrices for common dataflows (paper §VI naming scheme)
# ---------------------------------------------------------------------------

def stt_from_name(kind: str) -> Mat:
    """Classic 3-loop STTs.  With loops ordered (p1, p2, t)=(i, j, k) for
    GEMM these generate the canonical dataflows:

      identity      -> multicast/multicast/stationary   (MMT; SUMMA-like)
      output_stationary -> systolic/systolic/stationary (SST; TPU-style)
      weight_stationary -> A systolic, B stationary, C systolic (STS)
      input_stationary  -> A stationary, B systolic, C systolic (TSS)
    """
    I = linalg.mat
    return {
        "identity": I([[1, 0, 0], [0, 1, 0], [0, 0, 1]]),
        # skewed time makes operand reuse vectors pick up dt != 0 -> systolic.
        # For GEMM with loops (m, n, k): reuse(A)=e_n, reuse(B)=e_m,
        # reuse(C)=e_k, so the dataflow of each tensor is T's column for the
        # missing iterator: (0,0,dt) column -> that tensor is stationary.
        "output_stationary": I([[1, 0, 0], [0, 1, 0], [1, 1, 1]]),   # SST
        "weight_stationary": I([[0, 1, 0], [0, 0, 1], [1, 1, 1]]),   # STS
        "input_stationary": I([[1, 0, 0], [0, 0, 1], [1, 1, 1]]),    # TSS
    }[kind]
