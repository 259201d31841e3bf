"""Plan generation: one STT matrix -> kernel template + collective schedule.

This is TensorLib's "hardware generation" step (§V) re-targeted at TPU
(DESIGN.md §2).  The same per-tensor classification drives two levels:

* **KernelPlan** (intra-chip): which Pallas GEMM template runs on a core —
  the stationary tensor decides which operand block stays resident in VMEM
  across the reduction grid axis (paper Fig. 3 module (c)/(d) = VMEM
  residency; systolic shift = the software pipeline's revolving buffer).

* **CommPlan** (inter-chip): which collectives connect the chip "PE array" —
  multicast = all_gather, reduction tree = psum / psum_scatter, systolic =
  ppermute ring, stationary = sharded with no motion, unicast = fully
  partitioned streaming (no collective).

``plan_for`` is the faithful analogue of the paper's module-selection table:
it is a *total* function of the classification, not of the algebra, which is
exactly the paper's reuse argument — new dataflows reuse the same templates.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, FrozenSet, Mapping, Optional, Tuple, Union

from .stt import Dataflow, DataflowClass


# map: (class, is_output) -> PE-internal module of paper Fig. 3
PAPER_PE_MODULES = {
    (DataflowClass.SYSTOLIC, False): "a:systolic-in",
    (DataflowClass.SYSTOLIC, True): "b:systolic-out",
    (DataflowClass.STATIONARY, False): "c:stationary-in(double-buffer)",
    (DataflowClass.STATIONARY, True): "d:stationary-out(double-buffer)",
    (DataflowClass.MULTICAST, False): "e:direct-in",
    (DataflowClass.UNICAST, False): "e:direct-in",
    (DataflowClass.UNICAST, True): "f:direct-out",
    (DataflowClass.REDUCTION, True): "f:direct-out(+reduction-tree)",
    (DataflowClass.BROADCAST, False): "e:direct-in",
    (DataflowClass.MULTICAST_STATIONARY, False): "e+c:tap+double-buffer",
    (DataflowClass.MULTICAST_STATIONARY, True): "f+d:tree+double-buffer",
    (DataflowClass.SYSTOLIC_MULTICAST, False): "e+a:tap+systolic",
    (DataflowClass.SYSTOLIC_MULTICAST, True): "f+b:tree+systolic",
    (DataflowClass.BROADCAST, True): "f:reduction-tree-2d",
}


@dataclasses.dataclass(frozen=True)
class TensorCommPlan:
    """Mesh-level realization for one tensor (DESIGN.md §2, level 2)."""

    tensor: str
    kind: str          # shard | all_gather | psum | ppermute_ring | stream
    #: every mesh axis the reuse direction moves along, major axis first.
    #: A diagonal direction (e.g. dp = (1, 1)) is realized as two chained
    #: collectives, one per axis — both axes are recorded here instead of
    #: silently dropping the minor one.
    mesh_axes: Tuple[str, ...] = ()
    ring_shift: Tuple[int, ...] = ()  # systolic direction on the mesh
    delay: int = 0
    #: block-level density of the tensor (1.0 = dense).  Sparse operands
    #: currently replicate/move their *masked dense* form between chips;
    #: the density annotates how much of that traffic is payload so mesh
    #: cost calibration can discount it.
    density: float = 1.0

    @property
    def is_sparse(self) -> bool:
        return self.density < 1.0

    @property
    def mesh_axis(self) -> Optional[str]:
        """Major axis of the collective (back-compat accessor)."""
        return self.mesh_axes[0] if self.mesh_axes else None

    @property
    def is_diagonal(self) -> bool:
        """True when the move spans more than one mesh axis (chained)."""
        return len(self.mesh_axes) > 1


@dataclasses.dataclass(frozen=True)
class CommPlan:
    dataflow: str
    tensors: Tuple[TensorCommPlan, ...]

    def by_tensor(self) -> Dict[str, TensorCommPlan]:
        return {t.tensor: t for t in self.tensors}

    @property
    def collective_kinds(self) -> Tuple[str, ...]:
        return tuple(sorted({t.kind for t in self.tensors}))


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """Intra-chip Pallas template selection."""

    dataflow: str
    template: str                      # which kernels/stt_gemm template
    resident_tensor: Optional[str]     # block pinned in VMEM across k-steps
    streamed: Tuple[str, ...]          # operands double-buffered by pipeline
    reduction_in_kernel: bool          # accumulate over a grid axis?


def _axes_for(dp: Tuple[int, ...], axes: Tuple[str, str]) -> Tuple[str, ...]:
    """Every mesh axis a reuse direction moves along, major axis first.

    A diagonal move such as dp = (1, 1) yields both axes: the collective
    is realized as two chained per-axis collectives (or a 2-D collective
    over the axis tuple), not silently truncated to the major axis.
    """
    return tuple(axes[i] for i, d in enumerate(dp) if d != 0)


def comm_plan_for(df: Dataflow, axes: Tuple[str, str] = ("x", "y"),
                  densities: Optional[Dict[str, float]] = None) -> CommPlan:
    """Per-tensor mesh collectives generated from the classification.

    ``axes`` defaults to the ("x", "y") names the dist engines and the
    CommPlan interpreter (``dist/comm_engine.py``) use for the chip mesh.
    ``densities`` (tensor name -> block density) annotates sparse operands
    on the emitted plan — metadata only, the collective kinds are a
    function of the classification alone.
    """
    plans = []
    for t in df.tensors:
        c = t.cls
        if c is DataflowClass.STATIONARY:
            plans.append(TensorCommPlan(t.tensor, "shard"))
        elif c is DataflowClass.MULTICAST:
            plans.append(TensorCommPlan(t.tensor, "all_gather",
                                        _axes_for(t.dp, axes)))
        elif c is DataflowClass.BROADCAST:
            plans.append(TensorCommPlan(t.tensor, "all_gather", tuple(axes)))
        elif c is DataflowClass.REDUCTION:
            plans.append(TensorCommPlan(t.tensor, "psum",
                                        _axes_for(t.dp, axes)))
        elif c is DataflowClass.SYSTOLIC:
            plans.append(TensorCommPlan(t.tensor, "ppermute_ring",
                                        _axes_for(t.dp, axes),
                                        ring_shift=t.dp, delay=t.dt))
        elif c is DataflowClass.MULTICAST_STATIONARY:
            plans.append(TensorCommPlan(t.tensor, "all_gather",
                                        _axes_for(t.dp_multicast, axes)))
        elif c is DataflowClass.SYSTOLIC_MULTICAST:
            plans.append(TensorCommPlan(t.tensor, "ppermute_ring",
                                        _axes_for(t.dp, axes),
                                        ring_shift=t.dp, delay=t.dt))
        else:  # UNICAST
            plans.append(TensorCommPlan(t.tensor, "stream"))
    if densities:
        plans = [dataclasses.replace(p, density=densities.get(p.tensor, 1.0))
                 for p in plans]
    return CommPlan(df.name, tuple(plans))


def kernel_plan_for(df: Dataflow) -> KernelPlan:
    """Select the Pallas GEMM template from the classification.

    TPU adaptation (DESIGN.md D1): the MXU replaces the PE array, so
    "which tensor is stationary" becomes "which block is VMEM-resident
    across the reduction axis of the Pallas grid".
    """
    stationary = [t.tensor for t in df.tensors
                  if t.cls in (DataflowClass.STATIONARY,
                               DataflowClass.MULTICAST_STATIONARY)]
    out_name = df.tensors[-1].tensor
    out_cls = df.tensors[-1].cls

    if out_name in stationary:
        template = "output_stationary"
        resident = out_name
    elif stationary:
        template = "operand_stationary"
        resident = stationary[0]
    elif out_cls is DataflowClass.REDUCTION:
        template = "reduction_tree"
        resident = None
    else:
        template = "streaming"
        resident = None
    streamed = tuple(t.tensor for t in df.tensors if t.tensor != resident)
    return KernelPlan(df.name, template, resident, streamed,
                      reduction_in_kernel=(template == "output_stationary"))


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """The complete generated 'accelerator': paper modules for reference,
    kernel template, and mesh collective schedule."""

    dataflow: Dataflow
    pe_modules: Tuple[str, ...]
    kernel: KernelPlan
    comm: CommPlan


def plan_for(df: Dataflow, axes: Tuple[str, str] = ("x", "y"),
             densities: Optional[Dict[str, float]] = None) -> ExecutionPlan:
    is_out = {t.tensor: (t.tensor == df.tensors[-1].tensor)
              for t in df.tensors}
    modules = tuple(
        f"{t.tensor}->{PAPER_PE_MODULES[(t.cls, is_out[t.tensor])]}"
        for t in df.tensors)
    return ExecutionPlan(df, modules, kernel_plan_for(df),
                         comm_plan_for(df, axes, densities))


# ---------------------------------------------------------------------------
# Partition solver: (CommPlan, LoweredForm, mesh shape) -> PartitionSolution
# ---------------------------------------------------------------------------
# The solver is the single place where LoweredForm dims — batch, m, n, k and
# sparse block coordinates — are mapped onto mesh axes.  It is a *total*
# function of the CommPlan kinds (same reuse argument as plan_for): the
# interpreter (dist/comm_engine.py) materializes it as shard_map specs and
# ring loops, the cost model prices collectives from it, the DSE ranks
# dataflows with it, and Accelerator.describe() reports it.  It is jax-free
# so every consumer (including the pure-python cost model) can call it.

#: side-kind precedence: a GEMM operand fed by several algebra tensors
#: (mttkrp's Khatri-Rao rhs) moves the way its most mobile tensor does.
_KIND_ORDER = ("ppermute_ring", "all_gather", "stream", "shard")

#: bytes per block-COO coordinate component shipped with compressed payloads
INDEX_BYTES = 4


def side_kind(by_tensor: Mapping[str, TensorCommPlan],
              tensors: FrozenSet[str]) -> str:
    kinds = {by_tensor[t].kind for t in tensors if t in by_tensor}
    for k in _KIND_ORDER:
        if k in kinds:
            return k
    return "shard"


AxisSpec = Union[None, str, Tuple[str, ...]]


def _axis_factor(ax: AxisSpec, sizes: Mapping[str, int]) -> int:
    if ax is None:
        return 1
    if isinstance(ax, str):
        return sizes[ax]
    return math.prod(sizes[a] for a in ax)


@dataclasses.dataclass(frozen=True)
class TensorPartition:
    """Stored mesh layout + motion of one GEMM-form side.

    ``dims`` are the LoweredForm dims of the operand in array order
    (batched sides lead with ``"b"``); ``placement`` shards each dim over
    a mesh axis (``None`` = that dim is whole on every device holding it).
    ``motion`` is the collective that moves the side between chips during
    execution (all_gather multicast, ppermute_ring systolic, or None for
    resident data); a compressed side moves as a padded block payload +
    block-COO coordinate list instead of its dense image.
    """

    side: str                             # lhs | rhs | out
    tensors: Tuple[str, ...]              # algebra tensors riding this side
    dims: Tuple[str, ...]
    placement: Tuple[AxisSpec, ...]
    motion: Optional[str] = None          # all_gather | ppermute_ring | None
    motion_axis: Optional[str] = None
    delay: int = 0                        # systolic dt carried by the plan
    density: float = 1.0
    compressed: bool = False              # shipped as BSR payload + coords

    @property
    def axis_of(self) -> Dict[str, AxisSpec]:
        return dict(zip(self.dims, self.placement))

    def shard_factor(self, sizes: Mapping[str, int]) -> int:
        return math.prod(_axis_factor(a, sizes) for a in self.placement)

    @property
    def is_replicated(self) -> bool:
        """True when no dim of the stored layout is sharded at all."""
        return all(a is None for a in self.placement)

    def describe(self) -> str:
        dims = " ".join(
            f"{d}:{'/'.join(a) if isinstance(a, tuple) else (a or '·')}"
            for d, a in zip(self.dims, self.placement))
        mot = f" {self.motion}[{self.motion_axis}]" if self.motion else ""
        comp = " bsr" if self.compressed else ""
        return f"{dims}{mot}{comp}"


@dataclasses.dataclass(frozen=True)
class PartitionSolution:
    """One solved (CommPlan, LoweredForm, mesh) triple.

    ``grid`` is the headline mapping: every LoweredForm dim -> the mesh
    axis (or axes) that spatially split its iteration range.  The
    per-side ``TensorPartition``s derive the stored layouts (which may
    split extra dims for motion, e.g. SUMMA's stored k-split), and
    ``macs_split`` is the product of axis sizes that divide the MAC
    space — the batch-shard / spatial speedup the cost model prices.
    """

    strategy: str
    axes: Tuple[str, str]
    shape: Tuple[int, int]
    grid: Mapping[str, AxisSpec]          # dim -> mesh axis/axes
    lhs: TensorPartition
    rhs: TensorPartition
    out: TensorPartition
    batch_axis: Optional[str] = None
    ring_axes: Tuple[str, ...] = ()
    k_axes: Tuple[str, ...] = ()
    stagger: bool = False                 # dt ppermute schedule active
    macs_split: int = 1
    notes: Tuple[str, ...] = ()           # degradations, for docs/CI

    # -- introspection ----------------------------------------------------
    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axes, self.shape))

    @property
    def n_devices(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def sides(self) -> Tuple[TensorPartition, TensorPartition,
                             TensorPartition]:
        return (self.lhs, self.rhs, self.out)

    def replicated_inputs(self) -> Tuple[str, ...]:
        """Algebra tensors whose stored layout is fully replicated — the
        CI no-silent-replication assert reads this."""
        out = []
        for tp in (self.lhs, self.rhs):
            if tp.is_replicated:
                out.extend(tp.tensors)
        return tuple(sorted(out))

    # -- accounting (priced by the cost model and the benchmarks) ---------
    def _extents(self, form) -> Dict[str, int]:
        return {"b": form.batch_size, "m": form.m, "n": form.n, "k": form.k}

    def _side_elems(self, tp: TensorPartition, ext: Mapping[str, int]
                    ) -> float:
        # ceil per dim: a padded shard still occupies a full shard's
        # storage on every device (what 1xN meshes and size-1 dims see)
        elems = 1.0
        for d, a in zip(tp.dims, tp.placement):
            elems *= math.ceil(ext[d] / _axis_factor(a, self.sizes))
        return elems

    def per_device_elems(self, form) -> Dict[str, float]:
        """Stored elements per device per side.  Compressed payloads
        scale by block density (only nonzero blocks are materialized);
        masked-dense sides store their full shard, zeros included —
        that physical difference is exactly what the compressed-vs-dense
        footprint comparison measures."""
        ext = self._extents(form)
        out = {}
        for tp in self.sides:
            e = self._side_elems(tp, ext)
            out[tp.side] = e * (tp.density if tp.compressed else 1.0)
        return out

    def per_device_bytes(self, form, elem_bytes: int = 4) -> Dict[str, float]:
        """Stored bytes per device per side, incl. block-COO metadata for
        compressed sides (two int32 coords per nonzero block)."""
        ext = self._extents(form)
        out = {}
        for tp in self.sides:
            dense = self._side_elems(tp, ext)
            if tp.compressed and form.sparse is not None:
                be = form.sparse.block[0] * form.sparse.block[1]
                b = (
                    dense * tp.density * elem_bytes
                    + (dense * tp.density / be) * 2 * INDEX_BYTES
                )
            else:
                b = dense * elem_bytes
            out[tp.side] = b
        return out

    def comm_bytes(self, form, elem_bytes: int = 4) -> Dict[str, float]:
        """Bytes *received* per device per side over one execution: each
        hop of a ring and each remote shard of a gather moves one stored
        shard (nnz-scaled for compressed sides); psum / staggered-output
        reductions move one output shard per reduction hop."""
        stored = self.per_device_bytes(form, elem_bytes)
        out = {}
        for tp in (self.lhs, self.rhs):
            hops = 0
            if tp.motion is not None and tp.motion_axis is not None:
                hops = self.sizes[tp.motion_axis] - 1
            out[tp.side] = hops * stored[tp.side]
        hops = 0
        if self.stagger and self.ring_axes:
            hops = self.sizes[self.ring_axes[0]] - 1
        elif self.k_axes and not self.stagger:
            hops = math.prod(self.sizes[a] for a in self.k_axes) - 1
        out["out"] = hops * stored["out"]
        return out

    def per_device_macs(self, form) -> int:
        """MACs each device executes: the iteration space divided by the
        ``grid`` split, ceil'd per dim — splitting a size-1 dim is pure
        padding, not speedup, which is exactly what the replicating
        baselines show.  Scaled by block density on the BSR path."""
        ext = self._extents(form)
        macs = 1
        for d in ("b", "m", "n", "k"):
            macs *= math.ceil(ext[d] / _axis_factor(self.grid.get(d),
                                                    self.sizes))
        if form.sparse is not None:
            macs = round(macs * form.sparse.density)
        return max(1, macs)

    def describe(self) -> Dict[str, str]:
        def ax(a):
            return "/".join(a) if isinstance(a, tuple) else (a or "·")

        lines = {"strategy": self.strategy,
                 "grid": " ".join(f"{d}:{ax(a)}"
                                  for d, a in self.grid.items())}
        for tp in self.sides:
            lines[tp.side] = tp.describe()
        if self.notes:
            lines["notes"] = "; ".join(self.notes)
        return lines


def solve_partition(comm: CommPlan, form, axes: Tuple[str, str] = ("x", "y"),
                    shape: Tuple[int, int] = (2, 2), *,
                    shard_batch: bool = True,
                    compressed: Optional[bool] = None) -> PartitionSolution:
    """Derive the per-tensor mesh partition from the CommPlan kinds.

    This replaces the per-strategy shard/replicate decisions that used to
    live inside ``dist/comm_engine.py``: batch grid dims fold onto a mesh
    axis (replication only as the degenerate solution when no axis is
    free), compressed operands ship as per-shard BSR payloads, and
    input-systolic delay staggering is realized as a ppermute rotation
    schedule over the output ring.

    ``shard_batch=False`` / ``compressed=False`` request the replicating /
    masked-dense baselines (used for footprint A/B comparisons);
    ``compressed=None`` means "compressed whenever the form has a
    structured sparse operand".
    """
    ax0, ax1 = axes
    s0, s1 = int(shape[0]), int(shape[1])
    sizes = {ax0: s0, ax1: s1}
    by = comm.by_tensor()
    lhs_kind = side_kind(by, form.lhs_tensors)
    rhs_kind = side_kind(by, form.rhs_tensors)
    out_tp = comm.tensors[-1]
    out_kind = out_tp.kind

    batched = bool(form.batch) and shard_batch
    sparse_side = form.sparse.side if form.sparse is not None else None
    if compressed is None:
        compressed = sparse_side is not None
    compressed = (
        bool(compressed) and sparse_side is not None and not form.batch
    )
    notes = []

    def dens(tensors: FrozenSet[str]) -> float:
        return math.prod(by[t].density for t in tensors if t in by) or 1.0

    def delay_of(tensors: FrozenSet[str]) -> int:
        return max((by[t].delay for t in tensors if t in by), default=0)

    lhs_names = tuple(sorted(form.lhs_tensors))
    rhs_names = tuple(sorted(form.rhs_tensors))
    out_name = (out_tp.tensor,)
    lb, rb = form.lhs_batched, form.rhs_batched

    def part(side, tensors, dims, axis_of, motion=None, motion_axis=None,
             delay=0):
        placement = tuple(axis_of.get(d) for d in dims)
        return TensorPartition(
            side, tensors, dims, placement, motion, motion_axis, delay,
            density=dens(form.lhs_tensors if side == "lhs" else
                         form.rhs_tensors) if side != "out" else 1.0,
            compressed=compressed and side == sparse_side)

    if out_kind in ("shard", "stream"):
        return _solve_out_stationary(
            comm, form, axes, sizes, lhs_kind, rhs_kind, batched,
            compressed, sparse_side, part, lhs_names, rhs_names, out_name,
            lb, rb, delay_of, notes)
    return _solve_k_spatial(
        comm, form, axes, sizes, lhs_kind, rhs_kind, out_tp, batched,
        compressed, sparse_side, part, lhs_names, rhs_names, out_name,
        lb, rb, delay_of, notes)


def _solve_out_stationary(comm, form, axes, sizes, lhs_kind, rhs_kind,
                          batched, compressed, sparse_side, part,
                          lhs_names, rhs_names, out_name, lb, rb,
                          delay_of, notes):
    """Output (b?, m, n) blocks resident on their chip; the contraction is
    delivered by gathers, rings, or local full-k residency.

    m shards the first axis and n the second (the orientation the classic
    SUMMA/Cannon engines used); a batch dim *takes over the first axis*
    (m goes whole-per-device) — for the registry's batched forms m == 1,
    so this turns pure padding waste into a 1/|axis| batch shard, and for
    a hypothetical batched large-m form the per-device element count is
    identical either way.
    """
    ax0, ax1 = axes
    s0, s1 = sizes[ax0], sizes[ax1]
    square = s0 == s1

    grid = {"b": None, "m": ax0, "n": ax1, "k": None}
    if batched:
        grid["b"], grid["m"] = ax0, None

    # per-side motion: lhs moves along ax1 (its reuse spans n), rhs along
    # ax0.  A batched side whose batch shard occupies its motion axis
    # cannot also split k there: it degrades to resident full k.
    lhs_motion = (
        lhs_kind if lhs_kind in ("all_gather", "ppermute_ring") else None
    )
    rhs_motion = (
        rhs_kind if rhs_kind in ("all_gather", "ppermute_ring") else None
    )
    if batched and rb and rhs_motion is not None:
        rhs_motion = None
        notes.append("rhs k-motion degraded to resident: batch shard "
                     f"occupies {ax0}")

    double_ring = (
        lhs_motion == "ppermute_ring" and rhs_motion == "ppermute_ring"
    )
    if double_ring and (not square or
                        (compressed and sparse_side is not None)):
        # Cannon needs equal ring lengths (and skewed dense k-blocks,
        # which a compressed coordinate list cannot realign): keep the
        # systolic ring on one side — the longer axis, or the compressed
        # side — and degrade the other to all_gather multicast.
        keep_lhs = (sparse_side == "lhs") if compressed else (s1 >= s0)
        if keep_lhs:
            rhs_motion = "all_gather" if s0 > 1 else None
            notes.append("rhs ring degraded to all_gather "
                         "(dt staggering kept on lhs ring)")
        else:
            lhs_motion = "all_gather" if s1 > 1 else None
            notes.append("lhs ring degraded to all_gather "
                         "(dt staggering kept on rhs ring)")
        double_ring = False

    if (compressed and sparse_side == "lhs"
            and rhs_motion == "ppermute_ring"):
        # a ring on the *dense* side would hand the compressed side's
        # global-frame k coordinates only a rotating k-shard to index:
        # the dense side must be full-k at contract time, so its ring
        # degrades to all_gather (its dt collapses; the sparse side's
        # own motion is untouched)
        rhs_motion = "all_gather" if s0 > 1 else None
        notes.append("dense rhs ring degraded to all_gather (compressed "
                     "lhs needs full-k contract)")
    if (compressed and sparse_side == "rhs"
            and lhs_motion == "ppermute_ring"):
        lhs_motion = "all_gather" if s1 > 1 else None
        notes.append("dense lhs ring degraded to all_gather (compressed "
                     "rhs needs full-k contract)")

    ring_axes = tuple(ax for ax, mot in ((ax1, lhs_motion), (ax0, rhs_motion))
                      if mot == "ppermute_ring")

    lhs_axis_of = {"b": grid["b"] if lb else None, "m": grid["m"],
                   "k": ax1 if lhs_motion else None}
    rhs_axis_of = {"b": grid["b"] if rb else None, "n": grid["n"],
                   "k": ax0 if rhs_motion else None}
    out_axis_of = {"b": grid["b"], "m": grid["m"], "n": grid["n"]}

    lhs = part("lhs", lhs_names, ("b", "m", "k") if lb else ("m", "k"),
               lhs_axis_of, lhs_motion, ax1 if lhs_motion else None,
               delay_of(form.lhs_tensors))
    rhs = part("rhs", rhs_names, ("b", "k", "n") if rb else ("k", "n"),
               rhs_axis_of, rhs_motion, ax0 if rhs_motion else None,
               delay_of(form.rhs_tensors))
    out = part("out", out_name,
               ("b", "m", "n") if form.batch else ("m", "n"), out_axis_of)

    strategy = ("cannon" if double_ring else
                "summa" if lhs_motion == "all_gather"
                and rhs_motion == "all_gather" else
                "ring_hybrid" if ring_axes else
                "multicast_hybrid" if lhs_motion or rhs_motion else "local")
    macs_split = math.prod(_axis_factor(grid[d], sizes)
                           for d in ("b", "m", "n"))
    return PartitionSolution(
        strategy, axes, (s0, s1), grid, lhs, rhs, out,
        batch_axis=grid["b"], ring_axes=ring_axes, macs_split=macs_split,
        notes=tuple(notes))


def _solve_k_spatial(comm, form, axes, sizes, lhs_kind, rhs_kind, out_tp,
                     batched, compressed, sparse_side, part, lhs_names,
                     rhs_names, out_name, lb, rb, delay_of, notes):
    """The contraction dim is spatial over ``k_axes``; partial products
    reduce over those axes — one psum (reduction-class outputs) or a
    staggered accumulate-rotate ppermute ring (systolic-class outputs).

    Staggering (the executed dt schedule): with a ring output of length S
    the accumulator circulates in m-chunks — device r adds its partial
    for chunk ``(r - t) mod S`` at step t, the chip-scale image of the
    input-systolic time offset — so the mobile tensor (the rotating
    output) stores 1/S of itself per device instead of a full replica.
    """
    ax0, ax1 = axes
    out_kind = out_tp.kind
    if out_kind == "psum":
        k_axes = tuple(a for a in out_tp.mesh_axes if a in sizes) or (ax0,)
    elif out_kind == "ppermute_ring":
        k_axes = (out_tp.mesh_axis if out_tp.mesh_axis in sizes else ax1,)
    else:                         # all_gather: 2-D reduction tree
        k_axes = (ax0, ax1)
    other = next((a for a in axes if a not in k_axes), None)
    if batched and other is None:
        batched = False
        notes.append("batch replicated (degenerate): both axes carry the "
                     "reduction tree")

    ring = out_kind == "ppermute_ring"
    S = sizes[k_axes[0]] if ring else 0
    stagger = ring and S > 1

    # the fully-partitioned ("shard"/"stream") input also splits its non-k
    # dim over the remaining axis; batch takes that axis when present, and
    # a staggered output chunks m over the ring axis instead
    shard_m = (
        other is not None
        and not batched
        and lhs_kind in ("shard", "stream")
        and not stagger
    )
    shard_n = other is not None and not batched and not shard_m

    grid = {"b": other if batched else None,
            "m": other if shard_m else None,
            "n": other if shard_n else None,
            "k": k_axes if len(k_axes) > 1 else k_axes[0]}

    lhs_axis_of = {"b": grid["b"] if lb else None, "m": grid["m"],
                   "k": grid["k"]}
    rhs_axis_of = {"b": grid["b"] if rb else None, "n": grid["n"],
                   "k": grid["k"]}
    out_axis_of = {"b": grid["b"],
                   "m": k_axes[0] if stagger else grid["m"],
                   "n": grid["n"]}

    lhs = part("lhs", lhs_names, ("b", "m", "k") if lb else ("m", "k"),
               lhs_axis_of, None, None, delay_of(form.lhs_tensors))
    rhs = part("rhs", rhs_names, ("b", "k", "n") if rb else ("k", "n"),
               rhs_axis_of, None, None, delay_of(form.rhs_tensors))
    out_motion = "ppermute_ring" if stagger else None
    out = dataclasses.replace(
        part("out", out_name,
             ("b", "m", "n") if form.batch else ("m", "n"), out_axis_of),
        motion=out_motion, motion_axis=k_axes[0] if stagger else None,
        delay=out_tp.delay)

    macs_split = math.prod(_axis_factor(grid[d], sizes)
                           for d in ("b", "m", "n", "k"))
    strategy = (
        "k_spatial_stagger"
        if stagger
        else ("k_spatial_ring" if ring else "k_spatial")
    )
    return PartitionSolution(
        strategy, axes, (sizes[ax0], sizes[ax1]), grid, lhs, rhs, out,
        batch_axis=grid["b"], ring_axes=k_axes if ring else (),
        k_axes=k_axes, stagger=stagger, macs_split=macs_split,
        notes=tuple(notes))
