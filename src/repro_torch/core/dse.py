"""Design-space exploration: enumerate STT matrices -> distinct dataflows.

The paper sweeps 148 GEMM dataflows and 33 depthwise-conv dataflows in a
16x16 array (Fig. 6).  Their enumeration universe is not spelled out; ours is
stated precisely:

  * loop selections: every ordered choice of 3 iterators out of the nest
    (order matters: the first two map to space, the last to time — but
    permutations of the two space rows produce mirrored hardware, so we
    canonicalize by sorting the space pair),
  * T entries in {-1, 0, 1}, det(T) != 0,
  * dedupe by ``Dataflow.signature`` (per-tensor class + interconnect
    directions) — two T's generating identical hardware count once.

Every enumerated point is costed with ``PaperCycleModel`` to produce the
area/power scatter (benchmarks/fig6_dse.py).

Fast path: the naive loop re-derived the
selected-loop nullspaces (one rref per tensor) and re-ran the full rank-2
classification for *every* candidate T.  Three facts make most of that
redundant:

  1. ``null(A_sel)`` is independent of T — computed once per selection
     (``stt.selection_nullspaces``), then only the cheap ``T @ v``
     transforms run per candidate.
  2. The full-rank filter over the T universe is selection-independent —
     the determinant sieve runs once per (entries, k) and is memoized.
  3. Candidates whose *transformed bases* repeat are duplicates by
     construction, so they are short-circuited before classification even
     starts; classification itself is memoized on the basis
     (``stt.classify_reuse_cached``).

``enumerate_dataflows_reference`` preserves the original per-T pipeline for
regression tests and A/B timing.

PyTorch port: a copy of the reference's ``core/dse.py`` with the same
decisions.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from . import linalg, stt as stt_mod
from .algebra import TensorAlgebra
from .costmodel import ArrayConfig, CostReport, PaperCycleModel
from .stt import Dataflow, DataflowClass, InvalidSTT, apply_stt


@functools.lru_cache(maxsize=None)
def _full_rank_T(entries: Tuple[int, ...], k: int) -> Tuple[linalg.Mat, ...]:
    """All full-rank k x k matrices over ``entries`` (determinant sieve runs
    once per universe, not once per loop selection)."""
    return tuple(T for T, _ in _full_rank_T_pairs(entries, k))


@functools.lru_cache(maxsize=None)
def _full_rank_T_pairs(entries: Tuple[int, ...], k: int
                       ) -> Tuple[Tuple[linalg.Mat, Tuple[Tuple[int, ...],
                                                          ...]], ...]:
    """(exact Fraction matrix, plain-int rows) for every full-rank candidate.

    The int form feeds the enumeration hot loop: transforming integral
    nullspace vectors and hashing the result is ~10x faster in machine ints
    than in ``Fraction``.
    """
    out = []
    for flat in itertools.product(entries, repeat=k * k):
        rows = tuple(tuple(int(v) for v in flat[i * k:(i + 1) * k])
                     for i in range(k))
        T = linalg.mat(rows)
        if linalg.det(T) != 0:
            out.append((T, rows))
    return tuple(out)


def _canon_int(v: Tuple[int, ...]) -> Tuple[int, ...]:
    """Integer-only ``linalg.integerize``: primitive vector, first nonzero
    positive.  Exactly matches integerize() on integral input."""
    import math
    g = 0
    for x in v:
        g = math.gcd(g, abs(x))
    if g == 0:
        return v
    if g != 1:
        v = tuple(x // g for x in v)
    first = next(x for x in v if x)
    return tuple(-x for x in v) if first < 0 else v


@functools.lru_cache(maxsize=None)
def _classify_int(basis: Tuple[Tuple[int, ...], ...], n_space: int,
                  is_output: bool) -> stt_mod.TensorDataflow:
    """Classification memo keyed on plain-int bases (hot-loop friendly)."""
    from fractions import Fraction
    frac = tuple(tuple(Fraction(x) for x in b) for b in basis)
    return stt_mod.classify_reuse_cached(frac, n_space, is_output)


def enumerate_T(entries: Sequence[int] = (-1, 0, 1), k: int = 3
                ) -> Iterable[linalg.Mat]:
    """All full-rank k x k matrices with entries drawn from ``entries``."""
    yield from _full_rank_T(tuple(entries), k)


def loop_selections(alg: TensorAlgebra) -> List[Tuple[str, ...]]:
    """Ordered 3-loop selections with the space pair canonicalized."""
    sels = set()
    for combo in itertools.permutations(alg.loops, 3):
        space = tuple(sorted(combo[:2]))
        sels.add((space[0], space[1], combo[2]))
    return sorted(sels)


def is_realizable(df: Dataflow) -> bool:
    """Filter dataflows the paper's hardware templates cannot build:

    * systolic delay must be a small constant (|dt| <= 2 registers) and the
      hop must reach a neighbouring PE (|dp_i| <= 1),
    * an *output* tensor cannot be pure-multicast over time rank-2 shapes
      with no accumulation order (handled by REDUCTION tree for rank-1).
    """
    for t in df.tensors:
        if t.cls in (DataflowClass.SYSTOLIC, DataflowClass.SYSTOLIC_MULTICAST):
            if any(abs(d) > 1 for d in t.dp) or abs(t.dt) > 2:
                return False
        if t.cls in (DataflowClass.MULTICAST, DataflowClass.REDUCTION,
                     DataflowClass.BROADCAST):
            if any(abs(d) > 1 for d in (t.dp or ())):
                return False
    return True


def enumerate_dataflows(alg: TensorAlgebra,
                        selections: Optional[Sequence[Tuple[str, ...]]] = None,
                        entries: Sequence[int] = (-1, 0, 1),
                        realizable_only: bool = True,
                        ) -> Dict[Tuple, Dataflow]:
    """Map signature -> one representative Dataflow per distinct hardware.

    Fast path: per-selection nullspaces, memoized classification, and
    duplicate-basis short-circuiting (see module docstring).  Produces the
    same representative per signature as the reference implementation
    because candidates are visited in the same order.
    """
    out: Dict[Tuple, Dataflow] = {}
    sels = list(selections) if selections is not None else loop_selections(alg)
    for sel in sels:
        sel = tuple(sel)
        ns = stt_mod.selection_nullspaces(alg, sel)
        if any(len(null) > 2 for _, _, null in ns):
            # some tensor has a rank-3 reuse subspace under this selection
            # for *every* full-rank T — the whole selection is unbuildable
            # on a 2-D PE array (paper handles rank <= 2); skip it upfront.
            continue
        n_space = len(sel) - 1
        # integral nullspace vectors (nullspace() already integerizes)
        null_int = [tuple(linalg.as_int_tuple(v) for v in null)
                    for _, _, null in ns]
        seen_bases = set()
        for T, T_rows in _full_rank_T_pairs(tuple(entries), len(sel)):
            bases = tuple(
                tuple(_canon_int(tuple(sum(r * x for r, x in zip(row, v))
                                       for row in T_rows))
                      for v in null)
                for null in null_int)
            if bases in seen_bases:     # duplicate hardware: skip before
                continue                # classification ever runs
            seen_bases.add(bases)
            tensors = tuple(
                dataclasses.replace(
                    _classify_int(basis, n_space, is_output), tensor=name)
                for (name, is_output, _), basis in zip(ns, bases))
            df = Dataflow(alg.name, sel, T, tensors)
            if realizable_only and not is_realizable(df):
                continue
            key = (df.selected, df.signature)
            if key not in out:
                out[key] = df
    return out


def enumerate_dataflows_reference(
        alg: TensorAlgebra,
        selections: Optional[Sequence[Tuple[str, ...]]] = None,
        entries: Sequence[int] = (-1, 0, 1),
        realizable_only: bool = True,
        ) -> Dict[Tuple, Dataflow]:
    """The original (slow) enumeration: one full apply_stt per candidate T.

    Kept as the regression oracle for ``enumerate_dataflows`` and as the
    baseline for the DSE speedup measurement in benchmarks/fig6_dse.py.
    """
    out: Dict[Tuple, Dataflow] = {}
    sels = list(selections) if selections is not None else loop_selections(alg)
    for sel in sels:
        for flat in itertools.product(entries, repeat=len(sel) ** 2):
            k = len(sel)
            T = linalg.mat([flat[i * k:(i + 1) * k] for i in range(k)])
            if linalg.det(T) == 0:
                continue
            try:
                df = apply_stt(alg, sel, T)
            except (InvalidSTT, ValueError):
                continue
            if realizable_only and not is_realizable(df):
                continue
            key = (df.selected, df.signature)
            if key not in out:
                out[key] = df
    return out


def sweep_with_dataflows(alg: TensorAlgebra,
                         cfg: ArrayConfig = ArrayConfig(),
                         selections: Optional[Sequence[Tuple[str, ...]]]
                         = None,
                         density: Optional[float] = None,
                         calibration=None,
                         ) -> List[Tuple[CostReport, Dataflow]]:
    """Full DSE sweep, keeping the (report, dataflow) association.

    ``Dataflow.name`` is *not* unique across a sweep (hundreds of distinct
    T's share a letter combo), so consumers that need to act on a costed
    point — e.g. lower the pareto winner — must use this pairing rather
    than a name lookup.  ``density`` is the uniform input-density override
    (tensors with an explicit Sparsity pattern keep their own).
    ``calibration`` scales every prediction by the fitted measured/model
    ratio for its template (see ``PaperCycleModel``)."""
    model = PaperCycleModel(cfg, density=density, calibration=calibration)
    return [(model.evaluate(alg, df), df)
            for df in enumerate_dataflows(alg, selections).values()]


def sweep(alg: TensorAlgebra,
          cfg: ArrayConfig = ArrayConfig(),
          selections: Optional[Sequence[Tuple[str, ...]]] = None,
          density: Optional[float] = None,
          calibration=None,
          ) -> List[CostReport]:
    """Full DSE sweep: enumerate + cost every distinct dataflow."""
    return [r for r, _ in sweep_with_dataflows(alg, cfg, selections, density,
                                               calibration)]


def _mesh_shape(mesh) -> Tuple[int, int]:
    """Normalize a mesh argument: a (rows, cols) tuple or a
    ``jax.sharding.Mesh``."""
    if hasattr(mesh, "devices"):
        return tuple(mesh.devices.shape)
    s0, s1 = mesh
    return (int(s0), int(s1))


def search(alg: TensorAlgebra, top_k: int = 5,
           cfg: ArrayConfig = ArrayConfig(),
           selections: Optional[Sequence[Tuple[str, ...]]] = None,
           objective=None,
           density: Optional[float] = None,
           mesh=None,
           calibration=None,
           ) -> List[Tuple[CostReport, Dataflow]]:
    """Ranked design-space search: the DSE as an API the front door eats.

    Sweeps the design space and returns the ``top_k`` best ``(report,
    dataflow)`` pairs — pareto-optimal points first, then the rest, each
    group ordered by ``objective`` (default: cycles, then area, then
    power).  ``repro.generate(alg, search=...)`` consumes the result
    directly: candidates are lowered in rank order and the first one that
    validates becomes the accelerator.

    Sparse ranking: an algebra carrying :class:`~repro.core.algebra.
    Sparsity` patterns is priced with its per-tensor block densities and
    compressed-format traffic terms automatically; ``density`` applies a
    uniform input-density override instead when no pattern is attached.

    Multi-chip ranking: with ``mesh=`` (a ``jax.sharding.Mesh`` or a
    (rows, cols) shape) every candidate is priced by
    :func:`~repro.core.costmodel.mesh_evaluate` — per-device compute from
    the solved partition's spatial split plus collective stall terms —
    and ranked by ``mesh_cycles``: a dataflow that replicates less and
    ships smaller payloads wins even when its single-chip cycles tie.

    Calibrated ranking: ``calibration`` (a fitted measured/model scale
    table, ``repro.tune.calibrate``) re-prices every candidate with its
    template's machine-measured correction before ranking — the measured
    autotuner's feedback path into the analytical search.
    """
    pairs = sweep_with_dataflows(alg, cfg, selections, density, calibration)
    if mesh is not None:
        from .costmodel import mesh_evaluate
        shape = _mesh_shape(mesh)
        pairs = [(mesh_evaluate(alg, df, shape, cfg, density=density,
                                report=rep), df)
                 for rep, df in pairs]
        key = objective or (lambda r: (r.mesh_cycles, r.cycles,
                                       r.area_units, r.power_mw))
        ranked = sorted(pairs, key=lambda p: key(p[0]))
        return ranked[:top_k] if top_k else ranked
    key = objective or (lambda r: (r.cycles, r.area_units, r.power_mw))
    front_ids = {id(r) for r in pareto_front([r for r, _ in pairs])}
    ranked = sorted(pairs,
                    key=lambda p: (id(p[0]) not in front_ids, key(p[0])))
    return ranked[:top_k] if top_k else ranked


def _front2d_keep(group: List[Tuple[float, float, int]]) -> List[int]:
    """Indices of (area, power) points in ``group`` not strictly dominated
    within the group (<= on both and < on at least one)."""
    group = sorted(group)
    keep = []
    best_smaller_area = float("inf")   # min power over strictly smaller areas
    i = 0
    while i < len(group):
        # run of equal areas, sorted by power ascending
        j = i
        run_min_power = group[i][1]
        while j < len(group) and group[j][0] == group[i][0]:
            a, p, idx = group[j]
            # dominated by a strictly-smaller-area point with power <= p, or
            # by an equal-area point with strictly smaller power
            if p >= best_smaller_area or p > run_min_power:
                pass                    # dominated
            else:
                keep.append(idx)
            j += 1
        best_smaller_area = min(best_smaller_area, run_min_power)
        i = j
    return keep


class _Staircase:
    """Minimal (area, power) staircase: areas ascending, powers strictly
    descending.  Supports 'is any kept point <= (a, p) on both coords?'
    queries and insertions in O(log n) amortized."""

    def __init__(self):
        self.areas: List[float] = []
        self.powers: List[float] = []

    def dominates(self, area: float, power: float) -> bool:
        import bisect
        i = bisect.bisect_right(self.areas, area)
        return i > 0 and self.powers[i - 1] <= power

    def insert(self, area: float, power: float) -> None:
        import bisect
        if self.dominates(area, power):
            return
        i = bisect.bisect_left(self.areas, area)
        # drop kept points weakly dominated by the new one
        j = i
        while j < len(self.areas) and self.powers[j] >= power:
            j += 1
        self.areas[i:j] = [area]
        self.powers[i:j] = [power]


def pareto_front(reports: Sequence[CostReport]) -> List[CostReport]:
    """Pareto-optimal points over (cycles, area, power) — all minimized.

    Sort-based sweep instead of the old all-pairs O(n^2) scan: points are
    processed in (cycles, area, power) order, so a point can only be
    dominated by already-processed ones.  Strictly-smaller-cycle groups are
    summarized by a 2-D (area, power) staircase (weak dominance there
    implies strict dominance overall); equal-cycle groups are resolved with
    a 2-D front pass that honours the strictness requirement.
    """
    order = sorted(range(len(reports)),
                   key=lambda i: (reports[i].cycles, reports[i].area_units,
                                  reports[i].power_mw))
    stair = _Staircase()
    front_idx: List[int] = []
    i = 0
    while i < len(order):
        # group of equal cycles
        j = i
        c = reports[order[i]].cycles
        while j < len(order) and reports[order[j]].cycles == c:
            j += 1
        group = order[i:j]
        # vs earlier (strictly smaller cycles): weak 2-D dominance suffices
        alive = [gi for gi in group
                 if not stair.dominates(reports[gi].area_units,
                                        reports[gi].power_mw)]
        # vs same-cycle points: needs strictness in area or power
        survivors = _front2d_keep(
            [(reports[gi].area_units, reports[gi].power_mw, gi)
             for gi in alive])
        front_idx.extend(survivors)
        for gi in group:
            stair.insert(reports[gi].area_units, reports[gi].power_mw)
        i = j
    front_idx.sort()
    return [reports[i] for i in front_idx]


def pareto_front_reference(reports: Sequence[CostReport]
                           ) -> List[CostReport]:
    """Original all-pairs O(n^2) pareto scan — regression oracle."""
    front = []
    for r in reports:
        dominated = any(
            (o.cycles <= r.cycles and o.area_units <= r.area_units
             and o.power_mw <= r.power_mw)
            and (o.cycles < r.cycles or o.area_units < r.area_units
                 or o.power_mw < r.power_mw)
            for o in reports)
        if not dominated:
            front.append(r)
    return front


def search_graph(graph, search: int = 5,
                 cfg: ArrayConfig = ArrayConfig(),
                 mesh=None, dtype: str = "float32"):
    """Graph-level design-space search: per-node dataflow selection with
    inter-node agreement (``repro_torch.graph.planner.plan_graph``).

    Extends :func:`search` from one algebra to an
    :class:`~repro_torch.graph.ir.AlgebraGraph`: each node's candidates are
    ranked by their own compute cycles *plus* the HBM traffic the node's
    input edges would pay under that candidate — an edge that fuses with
    its already-planned producer (tile/partition agreement) costs
    nothing, so fused and unfused schedules compete honestly.  Returns
    the :class:`~repro_torch.graph.planner.GraphPlan`; its ``cost_report()``
    carries the graph-level cycle/byte totals (``hbm_bytes`` vs
    ``hbm_bytes_unfused``) and ``mesh=`` adds the partition-agreement
    constraint with reshard pricing for disagreeing edges.
    """
    from ..graph.planner import plan_graph
    return plan_graph(graph, search=search, cfg=cfg, mesh=mesh,
                      dtype=dtype)
