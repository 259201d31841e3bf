"""Analytical performance / area / power models (paper Fig. 5, Fig. 6).

Two models live here:

1. ``PaperCycleModel`` — reproduces the paper's evaluation setup: a 16x16 PE
   array at 320 MHz with 32 GB/s on-chip bandwidth between the scratchpad and
   the array (§VI-A).  We cannot synthesize RTL (deviation D2 in DESIGN.md),
   so cycles are derived from the space-time geometry the STT induces:

     * per-tile cycle count = time extent of the tile box under T (this is
       exact for box domains and automatically charges systolic dataflows
       their fill/drain skew — the paper's "pipeline overhead"),
     * bandwidth stalls  = max(1, demand / available) with per-tensor traffic
       from the access-matrix extents (unicast tensors are automatically
       charged full-volume traffic because their access map is injective),
     * PE under-utilization from small loop bounds, with packing of multiple
       copies when a bound is below the array dimension (the paper's
       "15 of 16 rows used when p = 3" effect).

2. Area/energy proxies for the design-space exploration (Fig. 6), using
   per-dataflow-module area units and per-element-movement energy, calibrated
   so the paper's qualitative findings hold (MMT/MMS cost the most energy,
   reduction trees are cheap, stationary modules cost area + control energy).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

from . import linalg, tiling
from .algebra import TensorAlgebra
from .stt import Dataflow, DataflowClass
from .tiling import ArrayConfig  # re-export: historic home of ArrayConfig


@dataclasses.dataclass
class CostReport:
    dataflow_name: str
    cycles: float
    macs: int
    peak_macs: int                 # n_pes * cycles
    normalized_perf: float         # macs / peak  (paper Fig. 5 y-axis)
    utilization: float             # spatial utilization of the PE array
    bw_stall_factor: float
    fill_overhead_frac: float
    traffic_bytes: Dict[str, float]
    #: compressed-format index traffic per sparse tensor (block-COO
    #: coordinates moved alongside the payload); empty for dense algebras
    metadata_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: fraction of the loop nest's MACs that touch nonzero blocks
    #: (product of input-tensor block densities; 1.0 = dense)
    work_density: float = 1.0
    #: MACs the lowered kernel actually executes, from the LoweredForm's
    #: batched-matmul dims (batch * m * n * k, density-scaled on the BSR
    #: path).  Equal to ``macs`` for every registry algebra now that batch
    #: loops fold onto the Pallas grid instead of zero-padding the
    #: contraction; a ratio above 1.0 flags an execution path doing more
    #: work than the model prices (e.g. the masked-dense sparse fallback).
    executed_macs: int = 0
    area_units: float = 0.0
    power_mw: float = 0.0
    #: multi-chip terms, filled by ``mesh_evaluate`` from the solved
    #: :class:`~repro.core.plan.PartitionSolution`; zero / empty when the
    #: report was priced single-chip
    mesh_shape: Optional[Tuple[int, int]] = None
    mesh_strategy: str = ""
    per_device_macs: int = 0
    mesh_comm_bytes: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    mesh_cycles: float = 0.0
    #: median measured wall clock expressed at the model's frequency, when
    #: the measured autotuner (repro.tune) has timed this design; None =
    #: never measured.  Sits beside ``cycles`` so modeled vs measured is
    #: one report, not two code paths.
    measured_cycles: Optional[float] = None
    #: True when ``cycles`` (and everything derived from it: peak,
    #: normalized_perf, runtime_ms) was scaled by a fitted
    #: measured/model calibration (repro.tune.calibrate)
    calibrated: bool = False

    @property
    def executed_mac_ratio(self) -> float:
        """executed / priced MACs — 1.0 means the hardware does exactly
        the work the model charges for."""
        return self.executed_macs / self.macs if self.macs else 0.0

    @property
    def runtime_ms(self) -> float:
        return self.cycles / (320e6) * 1e3


# ---------------------------------------------------------------------------
# Geometry helpers — shared with the compiler, see core/tiling.py
# ---------------------------------------------------------------------------

_row_extent = tiling.row_extent
_is_unit_row = tiling.is_unit_row


@functools.lru_cache(maxsize=256)
def _lowered_form(alg: TensorAlgebra):
    """``alg``'s LoweredForm, or None when no lowering is registered.
    Memoized: the form is dataflow-independent, so one lookup serves
    every ``evaluate`` call of a DSE sweep (the hashable algebra is
    already the key all the other memoizations use)."""
    # lazy import: `repro.compile` depends on this module at load time, so
    # the reverse edge (mandated: executed MACs come *from the form* the
    # compiler runs, not from a parallel re-derivation) resolves at call
    # time only
    from ..compile.lowering import lower_form
    try:
        return lower_form(alg)
    except NotImplementedError:
        return None


def _lowered_executed_macs(alg: TensorAlgebra) -> Optional[int]:
    form = _lowered_form(alg)
    return None if form is None else form.executed_macs


# ---------------------------------------------------------------------------
# Cycle model
# ---------------------------------------------------------------------------

class PaperCycleModel:
    #: bytes per block-COO coordinate component (int32 indices)
    INDEX_BYTES = 4

    def __init__(self, cfg: ArrayConfig = ArrayConfig(),
                 density: Optional[float] = None,
                 calibration=None):
        """``density`` is a uniform input-operand density override used to
        rank dataflows for a target sparsity level *without* committing to
        a concrete pattern (``dse.search(..., density=...)``).  Tensors
        carrying an explicit :class:`~repro.core.algebra.Sparsity` always
        use their own block density instead.

        ``calibration`` is a fitted measured/model scale table (duck-typed
        on ``scale_for(template, algebra) -> float``; canonically a
        :class:`repro.tune.calibrate.Calibration`).  When given, every
        predicted cycle count is multiplied by the scale for the design's
        kernel template — the first-principles model times a machine
        correction — and reports carry ``calibrated=True``.  Scales are
        clamped positive by the fit, so calibrated cycles are positive
        whenever analytical cycles are, and same-template rankings are
        preserved."""
        if density is not None and not 0.0 < density <= 1.0:
            raise ValueError(f"density override must be in (0, 1], "
                             f"got {density}")
        if calibration is not None and not callable(
                getattr(calibration, "scale_for", None)):
            raise TypeError("calibration must expose "
                            "scale_for(template, algebra)")
        self.cfg = cfg
        self.density = density
        self.calibration = calibration

    def _calibration_scale(self, alg: TensorAlgebra, df: Dataflow) -> float:
        if self.calibration is None:
            return 1.0
        # the template is the plan layer's total function of the
        # classification — lazy import, same reverse edge as _lowered_form
        from . import plan as plan_mod
        template = plan_mod.kernel_plan_for(df).template
        return float(self.calibration.scale_for(template, alg.name))

    def _density_of(self, alg: TensorAlgebra, name: str,
                    is_output: bool) -> float:
        if is_output:
            return 1.0     # sum-of-products outputs are dense in general
        if alg.sparsity_of(name) is not None:
            return alg.density_of(name)
        return float(self.density) if self.density is not None else 1.0

    def _executed_macs(self, alg: TensorAlgebra, priced_macs: int) -> int:
        """MACs the lowered execution path performs, from the LoweredForm.

        The grid-folded lowerings make this equal the algebra's MACs for
        every registry algebra (the refactor's invariant, asserted by the
        registry-sweep test); algebras with no registered lowering have no
        execution path, so they are priced as themselves.
        """
        executed = _lowered_executed_macs(alg)
        return priced_macs if executed is None else executed

    # -- tiling -------------------------------------------------------------
    def _choose_tile(self, alg: TensorAlgebra, df: Dataflow
                     ) -> Tuple[List[int], Tuple[int, int], float]:
        """Delegates to the shared chooser (core/tiling.py) so the compiler
        and the cost model price/execute with identical tiles."""
        return tiling.choose_tile(alg, df, self.cfg.pe_dims)

    # -- traffic ------------------------------------------------------------
    def _tile_traffic(self, alg: TensorAlgebra, df: Dataflow,
                      tile: Sequence[int]
                      ) -> Tuple[Dict[str, float], Dict[str, float]]:
        """Bytes moved between scratchpad and array per tile, per tensor:
        ``(payload, metadata)``.

        Distinct elements touched by the tile box = product of index-extents
        (exact for box domains).  Multicast/broadcast reuse means an element
        is fetched once; unicast tensors have injective access so the same
        formula automatically yields full-volume traffic.

        Compressed-format terms: a block-sparse tensor only moves its
        nonzero blocks — payload scales by its block density — plus the
        block-COO coordinate list for the blocks the tile touches
        (``rank`` int32 indices per nonzero block).  The uniform
        ``density`` override scales payload only (no pattern, no concrete
        metadata layout to price).
        """
        cols = [alg.loop_index(s) for s in df.selected]
        by = df.by_tensor()
        out: Dict[str, float] = {}
        meta: Dict[str, float] = {}
        for t in alg.tensors:
            a_sel = linalg.submatrix_cols(t.access, cols)
            distinct = 1
            for row in a_sel:
                distinct *= _row_extent(row, tile)
            cls = by[t.name].cls
            factor = 1.0
            if t.is_output and cls not in (DataflowClass.STATIONARY,
                                           DataflowClass.MULTICAST_STATIONARY):
                # non-stationary outputs stream partial results every tile;
                # stationary outputs are written back once per reduction
                # (amortised below by only charging the final tile) — keep 1.
                factor = 1.0
            d = self._density_of(alg, t.name, t.is_output)
            out[t.name] = distinct * self.cfg.elem_bytes * factor * d
            sp = None if t.is_output else alg.sparsity_of(t.name)
            if sp is not None:
                block_elems = 1
                for b in sp.block:
                    block_elems *= b
                nnz_touched = d * distinct / block_elems
                meta[t.name] = nnz_touched * self.INDEX_BYTES * len(sp.block)
        return out, meta

    # -- main entry ----------------------------------------------------------
    def evaluate(self, alg: TensorAlgebra, df: Dataflow) -> CostReport:
        cols = [alg.loop_index(s) for s in df.selected]
        outer = [i for i in range(len(alg.loops)) if i not in cols]
        sel_bounds = [alg.bounds[c] for c in cols]

        tile, copies, util = self._choose_tile(alg, df)
        n_copies = copies[0] * copies[1]

        # time extent of one tile under T (includes systolic skew = fill)
        t_row = df.T[df.n_space]
        tile_cycles = _row_extent(t_row, tile)
        # the "pure compute" floor: MACs in the tile / spatially active PEs
        space_ext = math.prod(_row_extent(r, tile) for r in df.T[:df.n_space])
        compute_cycles = max(1, math.ceil(math.prod(tile) / max(1, space_ext)))
        fill = max(0, tile_cycles - compute_cycles)

        n_tiles_sel = 1
        for b, tb in zip(sel_bounds, tile):
            n_tiles_sel *= math.ceil(b / tb)
        n_outer = 1
        for i in outer:
            n_outer *= alg.bounds[i]
        # Fraction of stages whose blocks are all nonzero: a sparse-aware
        # array skips stages that hit a zero block of any sparse input
        # (independence approximation when several inputs are sparse).
        # This prices the *algebra's* compressed-format dataflow — what
        # the generated hardware would do.  The TPU realization only
        # skips blocks on the BSR path (`CompiledKernel.sparse_mode ==
        # "bsr"`); the masked-dense fallback executes dense and moves the
        # full operand — `executed_mac_ratio` > 1 reports exactly that
        # gap.
        work = 1.0
        for t in alg.inputs:
            work *= self._density_of(alg, t.name, False)
        # packed copies absorb outer/tile iterations
        n_stages = max(1, math.ceil(n_tiles_sel * n_outer / n_copies * work))

        traffic, meta = self._tile_traffic(alg, df, tile)
        tile_bytes = (sum(traffic.values()) + sum(meta.values())) * n_copies
        demand = tile_bytes / max(1, tile_cycles)
        stall = max(1.0, demand / self.cfg.bytes_per_cycle)

        cycles = n_stages * tile_cycles * stall
        # calibration applies before peak/normalized are derived, so every
        # downstream quantity tracks the corrected cycle count
        cycles *= self._calibration_scale(alg, df)
        macs = max(1, round(alg.total_macs() * work))
        peak = int(cycles * self.cfg.n_pes)
        report = CostReport(
            calibrated=self.calibration is not None,
            executed_macs=self._executed_macs(alg, macs),
            dataflow_name=df.name,
            cycles=cycles,
            macs=macs,
            peak_macs=peak,
            normalized_perf=macs / peak if peak else 0.0,
            utilization=util,
            bw_stall_factor=stall,
            fill_overhead_frac=fill / tile_cycles if tile_cycles else 0.0,
            traffic_bytes={k: v * n_stages * n_copies
                           for k, v in traffic.items()},
            metadata_bytes={k: v * n_stages * n_copies
                            for k, v in meta.items()},
            work_density=work,
        )
        report.area_units = self.area_units(alg, df)
        report.power_mw = self.power_mw(alg, df, report)
        return report

    # ------------------------------------------------------------------
    # Area / power proxies (Fig. 6) — unit-calibrated, see module docstring
    # ------------------------------------------------------------------
    #: per-PE area units for each dataflow module (Fig. 3 modules a..f)
    AREA_UNITS = {
        DataflowClass.SYSTOLIC: 2.0,              # reg + neighbour wire
        DataflowClass.STATIONARY: 3.6,            # double-buffer + control
        DataflowClass.MULTICAST: 1.0,             # wire tap
        DataflowClass.REDUCTION: 1.6,             # adder-tree share
        DataflowClass.UNICAST: 2.6,               # private memory port
        DataflowClass.BROADCAST: 1.4,
        DataflowClass.MULTICAST_STATIONARY: 4.4,  # tap + double buffer
        DataflowClass.SYSTOLIC_MULTICAST: 3.0,    # tap + reg
    }
    #: energy (pJ-equivalent units) per element delivered to a PE
    ENERGY_UNITS = {
        DataflowClass.SYSTOLIC: 1.0,              # one register hop
        DataflowClass.STATIONARY: 1.3,            # buffer write + control
        DataflowClass.MULTICAST: 1.9,             # long wire, high fanout
        DataflowClass.REDUCTION: 1.1,             # adder tree is cheap
        DataflowClass.UNICAST: 2.4,               # SRAM port per element
        DataflowClass.BROADCAST: 2.2,
        DataflowClass.MULTICAST_STATIONARY: 2.1,
        DataflowClass.SYSTOLIC_MULTICAST: 1.6,
    }
    MAC_AREA = 10.0
    MAC_ENERGY = 1.0
    #: calibration so the GEMM sweep lands in the paper's 35–63 mW range
    POWER_SCALE_MW = 0.08

    def area_units(self, alg: TensorAlgebra, df: Dataflow) -> float:
        per_pe = self.MAC_AREA
        for t in df.tensors:
            per_pe += self.AREA_UNITS[t.cls]
        return per_pe * self.cfg.n_pes

    def power_mw(self, alg: TensorAlgebra, df: Dataflow,
                 report: CostReport) -> float:
        """Average power = energy / cycle, scaled to mW at 320 MHz."""
        by = df.by_tensor()
        energy = report.macs * self.MAC_ENERGY
        for t in alg.tensors:
            # every MAC delivers/produces one element of each tensor to a PE
            energy += report.macs * self.ENERGY_UNITS[by[t.name].cls] * 0.35
        # scratchpad traffic energy
        for name, b in report.traffic_bytes.items():
            energy += (b / self.cfg.elem_bytes) * 0.8
        per_cycle = energy / max(1.0, report.cycles)
        return per_cycle * self.POWER_SCALE_MW


# ---------------------------------------------------------------------------
# Graph-level totals — fused vs unfused HBM accounting (repro.graph)
# ---------------------------------------------------------------------------

#: HBM <-> scratchpad bandwidth per 320 MHz cycle (≈32 GB/s, the paper's
#: off-array link §VI-A): the denominator for the traffic every
#: *materialized* graph edge pays and every fused edge saves
HBM_BYTES_PER_CYCLE = 100.0


@dataclasses.dataclass
class GraphCostReport:
    """Whole-graph cycle/byte totals for a planned :class:`AlgebraGraph`.

    ``hbm_bytes`` charges each materialized edge one write plus one read
    per unfused consumer (graph inputs are reads, the graph output a
    write, an unfused epilogue a full round trip);
    ``hbm_bytes_unfused`` re-prices the same plan with *every* fusion
    disabled — the honest baseline ``dse.search_graph`` ranks against.
    ``cycles`` = per-node compute cycles + HBM traffic cycles (+ mesh
    reshard traffic over the inter-chip link when planned on a mesh).
    """

    node_cycles: Dict[str, float]
    compute_cycles: float
    edge_bytes: Dict[str, float]            # per-edge HBM bytes charged
    hbm_bytes: float
    hbm_bytes_unfused: float
    fused_edges: Tuple[str, ...]            # "producer->consumer:edge"
    materialized_edges: Tuple[Tuple[str, str], ...]   # (edge desc, why)
    reshard_bytes: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    mesh_shape: Optional[Tuple[int, int]] = None
    #: edges a merged group exports from an intermediate stage for an
    #: out-of-group consumer ("group:edge"), and the HBM traffic those
    #: taps pay (the write plus every out-of-group read, already part
    #: of ``hbm_bytes`` — this attributes it)
    tapped_edges: Tuple[str, ...] = ()
    tap_hbm_bytes: float = 0.0

    @property
    def saved_hbm_bytes(self) -> float:
        return self.hbm_bytes_unfused - self.hbm_bytes

    @property
    def hbm_ratio(self) -> float:
        """unfused / fused HBM traffic (>1 = fusion saves bytes)."""
        return self.hbm_bytes_unfused / max(1.0, self.hbm_bytes)

    @property
    def hbm_cycles(self) -> float:
        return self.hbm_bytes / HBM_BYTES_PER_CYCLE

    @property
    def reshard_cycles(self) -> float:
        return sum(self.reshard_bytes.values()) / INTERCHIP_BYTES_PER_CYCLE

    @property
    def cycles(self) -> float:
        return self.compute_cycles + self.hbm_cycles + self.reshard_cycles

    @property
    def cycles_unfused(self) -> float:
        return (self.compute_cycles
                + self.hbm_bytes_unfused / HBM_BYTES_PER_CYCLE
                + self.reshard_cycles)

    @property
    def runtime_ms(self) -> float:
        return self.cycles / 320e6 * 1e3


# ---------------------------------------------------------------------------
# Multi-chip pricing — collective cost terms from the PartitionSolution
# ---------------------------------------------------------------------------

#: inter-chip link bandwidth per 320 MHz cycle (≈41 GB/s per direction —
#: ICI-class), the denominator for collective stall terms
INTERCHIP_BYTES_PER_CYCLE = 128.0


def mesh_evaluate(alg: TensorAlgebra, df: Dataflow,
                  shape: Tuple[int, int],
                  cfg: ArrayConfig = ArrayConfig(),
                  axes: Tuple[str, str] = ("x", "y"),
                  density: Optional[float] = None,
                  shard_batch: bool = True,
                  report: Optional[CostReport] = None) -> CostReport:
    """Single-chip evaluation plus multi-chip terms priced from the solved
    :class:`~repro.core.plan.PartitionSolution`.

    Per-device compute shrinks by the solver's ``macs_split`` (which is
    where the batch-shard speedup shows up); collective terms charge the
    bytes each device *receives* — per-hop shard bytes for rings and
    gathers, nnz-scaled payloads (plus block-COO metadata) for compressed
    sides, reduction hops for psum / staggered outputs.  ``mesh_cycles``
    = per-device compute cycles + collective cycles, the quantity
    ``dse.search(mesh=...)`` ranks by.  Pass ``report`` to reuse an
    already-computed single-chip evaluation (the DSE does: one model
    pass per candidate, not two).
    """
    from . import plan as plan_mod
    if report is None:
        report = PaperCycleModel(cfg, density=density).evaluate(alg, df)
    form = _lowered_form(alg)
    if form is None:
        return report
    comm = plan_mod.comm_plan_for(
        df, axes, densities={name: alg.density_of(name)
                             for name, _ in alg.sparsity})
    sol = plan_mod.solve_partition(comm, form, axes=axes, shape=shape,
                                   shard_batch=shard_batch)
    comm_bytes = sol.comm_bytes(form, cfg.elem_bytes)
    per_dev = sol.per_device_macs(form)
    compute_cycles = report.cycles * per_dev / max(1, form.executed_macs)
    comm_cycles = sum(comm_bytes.values()) / INTERCHIP_BYTES_PER_CYCLE
    return dataclasses.replace(
        report,
        mesh_shape=tuple(shape),
        mesh_strategy=sol.strategy,
        per_device_macs=sol.per_device_macs(form),
        mesh_comm_bytes=comm_bytes,
        mesh_cycles=compute_cycles + comm_cycles)
