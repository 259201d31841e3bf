"""The front door: ``repro_torch.generate`` — one call from algebra to
accelerator, on the card.

The port of the reference's ``api.py``.  ``generate`` runs the whole
single-device pipeline — classification (``core/stt.py``), plan
(``core/plan.py``), lowering and tiling (``compile.lower``) — and returns
an :class:`Accelerator` whose ``__call__`` runs the selected template's
CUDA kernel:

    import repro_torch
    acc = repro_torch.generate("gemm", "output_stationary")   # on cuda
    c = acc({"A": a, "B": b})

    acc = repro_torch.generate(alg, search=5)                 # DSE pick
    acc = repro_torch.generate("gemm", tune=4)                # measured
    acc = repro_torch.generate("gemm", sparsity={"A": sp})    # BSR kernel
    gacc = repro_torch.generate(graph)                        # megakernels

    from repro_torch.dist.engine import square_submesh
    multi = acc.sharded(square_submesh(2))                    # on a mesh
    c = multi({"A": a, "B": b})                               # every rank

Entry points run on the card unless the caller passes ``device="cpu"``
(the kernels' plain versions); with no card and no device given they
raise.  On a mesh (``generate(mesh=...)`` / :meth:`Accelerator.sharded`)
every rank of the mesh — one process a position, see
``repro_torch.dist.spawn`` — calls the accelerator with the same
operands, and the generated CommPlan runs through
``dist/comm_engine.py``; the dataflow classification drives both levels
from the same plan.  SUMMA / Cannon / ring-reduce are not modes a user
selects — they fall out of ``gemm`` x the MMT / SST / K-spatial
dataflows.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .compile import lower as _lower
from .compile.pipeline import CompiledKernel
from .core import dse as _dse
from .core import stt as _stt
from .core.algebra import PAPER_ALGEBRAS, Sparsity, TensorAlgebra, get_algebra
from .core.costmodel import CostReport
from .core.plan import ExecutionPlan
from .core.stt import Dataflow
from .core.tiling import ArrayConfig
from .graph.ir import AlgebraGraph
from .kernels.ops import resolve_device

DataflowLike = Union[Dataflow, str, None]


def _resolve_algebra(alg: Union[TensorAlgebra, str],
                     bounds: Optional[Dict[str, int]]) -> TensorAlgebra:
    if isinstance(alg, str):
        if alg not in PAPER_ALGEBRAS:
            raise ValueError(f"unknown algebra {alg!r}; "
                             f"registry: {sorted(PAPER_ALGEBRAS)}")
        return get_algebra(alg, **(bounds or {}))
    if bounds:
        return alg.with_bounds(**bounds)
    return alg


def _resolve_dataflow(alg: TensorAlgebra, dataflow: DataflowLike) -> Dataflow:
    if dataflow is None:
        dataflow = "output_stationary"
    if isinstance(dataflow, str):
        return _stt.apply_stt(alg, alg.loops[:3],
                              _stt.stt_from_name(dataflow))
    return dataflow


@dataclasses.dataclass
class Accelerator:
    """A generated accelerator: one handle over both pipeline levels.

    ``__call__`` executes on one device (the lowered template's kernel)
    or, when bound to a mesh via :meth:`sharded` / ``generate(mesh=...)``,
    across the mesh's ranks with every transfer prescribed by the
    generated CommPlan.
    """

    kernel: CompiledKernel
    #: DSE candidates considered when built via ``generate(search=...)``,
    #: best first; ``candidates[0]`` is the one this accelerator runs.
    candidates: Optional[Tuple[Tuple[CostReport, Dataflow], ...]] = None
    #: the measured autotuner's result when built via ``generate(tune=...)``
    #: (:class:`repro_torch.tune.TuneResult`): winning variant, measured
    #: medians, whether the on-disk tuning cache answered
    tune_result: Optional[object] = None
    #: the 2-D ``DeviceMesh`` this accelerator runs on (None: one device)
    mesh: Optional[object] = None
    #: mesh-execution options forwarded to the CommPlan interpreter:
    #: sparse shipping mode ("auto" | "bsr" | "dense") and batch sharding
    #: (False = replicating baseline, for footprint A/B comparisons)
    sparse_mode_mesh: str = "auto"
    shard_batch: bool = True
    _mesh_prog: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False)

    # -- introspection ----------------------------------------------------
    @property
    def algebra(self) -> TensorAlgebra:
        return self.kernel.algebra

    @property
    def dataflow(self) -> Dataflow:
        return self.kernel.dataflow

    @property
    def plan(self) -> ExecutionPlan:
        """The full generated plan: PE modules, KernelPlan, CommPlan."""
        return self.kernel.plan

    @property
    def template(self) -> str:
        return self.kernel.template

    @property
    def device(self) -> torch.device:
        return self.kernel.device

    def cost_report(self) -> CostReport:
        """Paper cost model's view of this exact (algebra, dataflow,
        config) — same tile chooser the executed blocks come from."""
        return self.kernel.cost_report()

    @property
    def partition(self):
        """The solved per-tensor mesh partition
        (:class:`~repro_torch.core.plan.PartitionSolution`); requires a
        bound mesh."""
        if self.mesh is None:
            raise ValueError("partition requires a mesh-bound accelerator; "
                             "call .sharded(mesh) first")
        return self._program().solution

    def describe(self) -> str:
        df = self.dataflow
        rep = self.cost_report()
        form = self.kernel.form
        lines = [f"Accelerator({self.algebra.name} x {df.name})",
                 f"  kernel: template={self.template} "
                 f"blocks={self.kernel.blocks} "
                 + (f"batch={form.batch} " if form.batch else "")
                 + f"resident={self.plan.kernel.resident_tensor} "
                 f"device={self.device}",
                 f"  macs:   executed={rep.executed_macs} "
                 f"ratio={rep.executed_mac_ratio:.2f} (executed/priced)"]
        if self.kernel.source == "tuned" or self.tune_result is not None:
            tr = self.tune_result
            bits = [f"source={self.kernel.source}",
                    f"grid_order={self.kernel.grid_order}",
                    f"accum={self.kernel.accum}"]
            if self.kernel.measured_s is not None:
                bits.append(f"measured={self.kernel.measured_s * 1e3:.3f}ms")
            if tr is not None:
                if tr.speedup is not None:
                    bits.append(f"speedup={tr.speedup:.2f}x")
                bits.append("cache-hit" if tr.cache_hit
                            else f"trials={len(tr.trials)}")
            lines.append("  tuned:  " + " ".join(bits))
        elif self.kernel.source != "analytical":
            lines.append(f"  knobs:  source={self.kernel.source} "
                         f"grid_order={self.kernel.grid_order} "
                         f"accum={self.kernel.accum}")
        if rep.measured_cycles is not None or rep.calibrated:
            cyc = (f"  cycles: model={rep.cycles:.0f}"
                   + (" (calibrated)" if rep.calibrated else ""))
            if rep.measured_cycles is not None:
                cyc += f" measured={rep.measured_cycles:.0f}"
            lines.append(cyc)
        if self.algebra.is_sparse:
            dens = " ".join(f"{name}:{self.algebra.density_of(name):.3f}"
                            for name, _ in self.algebra.sparsity)
            skip = ""
            if form.batch_keep is not None:
                skip = (f" batch_slices={len(form.batch_keep)}"
                        f"/{form.batch_full[0]}")
            lines.append(f"  sparse: mode={self.kernel.sparse_mode} "
                         f"{dens}{skip}")
        kinds = " ".join(
            f"{t.tensor}:{t.kind}"
            + (f"[{','.join(t.mesh_axes)}]" if t.mesh_axes else "")
            for t in self.plan.comm.tensors)
        lines.append(f"  comm:   {kinds}")
        if self.mesh is not None:
            sol = self.partition
            shape = dict(zip(self.mesh.mesh_dim_names,
                             tuple(self.mesh.shape)))
            lines.append(
                f"  mesh:   {shape} strategy={sol.strategy}"
                + (f" batch_axis={sol.batch_axis}" if sol.batch_axis
                   else ""))
            eb = self.kernel.dtype.itemsize
            stored = sol.per_device_bytes(form, eb)
            moved = sol.comm_bytes(form, eb)
            for tp in sol.sides:
                names = "+".join(tp.tensors)
                lines.append(
                    f"    {tp.side} ({names}): {tp.describe()} "
                    f"stored={stored[tp.side]:.0f}B/dev "
                    f"comm={moved[tp.side]:.0f}B/dev")
        return "\n".join(lines)

    # -- execution --------------------------------------------------------
    def _program(self):
        if self._mesh_prog is None:
            from .dist import comm_engine
            self._mesh_prog = comm_engine.compile_comm_plan(
                self.plan.comm, self.kernel.form, self.mesh,
                dtype=self.kernel.dtype, shard_batch=self.shard_batch,
                sparse=self.sparse_mode_mesh, device=self.device)
        return self._mesh_prog

    def __call__(self, operands: Dict[str, object]) -> torch.Tensor:
        if self.mesh is None:
            return self.kernel(operands)
        k = self.kernel
        # same dtype cast + sparsity-pattern enforcement as the
        # single-device path, so both levels compute the same function of
        # the operands
        cast = k.cast_operands(operands)
        lhs, rhs = k.form.prepare(cast)
        out2d = self._program()(lhs, rhs)
        return k.form.finish(out2d)

    def sharded(self, mesh, *, sparse: str = "auto",
                shard_batch: bool = True) -> "Accelerator":
        """Bind this accelerator to a 2-D ``DeviceMesh``: execution becomes
        the CommPlan interpreter's mesh program (chip-level wires), with
        the same :class:`~repro_torch.core.plan.PartitionSolution` driving
        both levels.  Every rank of the mesh then calls it with the same
        operands.

        Structured block-sparse operands ship **compressed** by default
        (``sparse='auto'``/``'bsr'``): each rank holds only its shard's
        nonzero blocks plus their block-COO coordinates, and the CommPlan
        collectives move that payload — no rank materializes the dense
        operand.  ``sparse='dense'`` requests the masked-dense shipping
        baseline (exact, but every transfer moves zero blocks too), kept
        for footprint comparisons.  ``shard_batch=False`` likewise keeps
        the replicating-batch baseline.
        """
        from torch.distributed.device_mesh import DeviceMesh
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"sharded() takes a torch.distributed "
                            f"DeviceMesh, got {type(mesh).__name__}")
        if sparse not in ("auto", "bsr", "dense"):
            raise ValueError(f"sparse must be 'auto', 'bsr' or 'dense', "
                             f"got {sparse!r}")
        form = self.kernel.form
        if sparse == "bsr" and (form.sparse is None or form.batch):
            # an explicit compressed request must not silently densify:
            # masked-mode and batched sparse forms have no structured 2-D
            # operand the collectives could ship as BSR payload
            raise ValueError(
                "sparse='bsr' requested but this form has no structured "
                "2-D sparse operand (masked-dense / batched patterns); "
                "use sparse='auto' (compresses whenever possible) or "
                "'dense'")
        return dataclasses.replace(self, mesh=mesh, sparse_mode_mesh=sparse,
                                   shard_batch=shard_batch, _mesh_prog=None)

    def validate(self, seed: int = 0, atol: float = 1e-3) -> float:
        """Run on random operands and compare against ``alg.reference``.

        Validates the *bound* execution path: the single-device kernel
        when no mesh is attached, the CommPlan-driven mesh program when
        one is (every rank of the mesh must call it).  Returns the max abs
        error; raises on mismatch."""
        if self.mesh is None:
            return self.kernel.validate(seed=seed, atol=atol)
        operands = self.algebra.random_operands(seed)
        got = self(operands).to(torch.float64).cpu().numpy()
        want = self.algebra.reference(operands).astype(np.float64)
        err = float(np.abs(got - want).max()) if got.size else 0.0
        if got.shape != want.shape or err > atol:
            raise AssertionError(
                f"sharded {self.algebra.name} x {self.dataflow.name} "
                f"diverged from reference: shape {got.shape} vs "
                f"{want.shape}, max err {err:.3e}")
        return err


def generate(alg: Union[TensorAlgebra, str, AlgebraGraph],
             dataflow: DataflowLike = None, *,
             search: Union[int, Sequence[Tuple[CostReport, Dataflow]],
                           None] = None,
             tune: Union[bool, int, None] = None,
             mesh=None,
             bounds: Optional[Dict[str, int]] = None,
             sparsity: Optional[Dict[str, Sparsity]] = None,
             cfg: ArrayConfig = ArrayConfig(),
             dtype: torch.dtype = torch.float32,
             device=None,
             validate: Optional[bool] = None):
    """Generate a complete accelerator from a tensor algebra.

    Args:
      alg: a :class:`TensorAlgebra` or a registry name (``"gemm"``, ...).
      dataflow: a :class:`Dataflow`, a named STT (``"identity"``,
        ``"output_stationary"``, ``"weight_stationary"``,
        ``"input_stationary"``), or None for the output-stationary
        default.  Mutually exclusive with ``search``.
      search: ``top_k`` (int) to run ``dse.search`` here, or a ranked
        ``[(report, dataflow), ...]`` from a previous search.  Candidates
        are lowered best-first; the first that lowers (and validates)
        wins.
      tune: measured autotuning (``repro_torch.tune``): True runs the
        timing-driven tuner over the analytical top candidates (an int
        sets the candidate width, default 4), picks the dataflow +
        kernel variant with the best *measured* median on ``device``,
        and persists the winner in the on-disk tuning cache — so a
        second ``generate(tune=...)`` on the same shape is a pure cache
        hit.  The result is ``Accelerator.tune_result`` and shows in
        ``describe()``.  Mutually exclusive with ``dataflow``/``search``.
      bounds: loop-bound overrides forwarded to the algebra.
      sparsity: per-tensor block-sparse patterns (tensor name ->
        :class:`~repro_torch.core.algebra.Sparsity`), applied via
        ``TensorAlgebra.with_sparsity``.  A pattern with a structured 2-D
        image under the lowering (gemm A or B, conv2d B and mttkrp A with
        whole-window blocks) runs on the BSR kernel, which reads only the
        nonzero blocks; the others run masked-dense.
      dtype: ``torch.float32`` (default) or ``torch.bfloat16``.
      device: where the accelerator runs: the card by default (raises
        without one), ``"cpu"`` for the plain versions.
      mesh: bind the result to a 2-D ``DeviceMesh`` (of ``device``'s
        type) — ``__call__`` then runs the generated CommPlan through
        ``dist/comm_engine.py`` on every rank of the mesh.

    Returns an :class:`Accelerator` — or, when ``alg`` is an
    :class:`~repro_torch.graph.ir.AlgebraGraph`, a
    :class:`~repro_torch.graph.executor.GraphAccelerator`: the whole DAG
    is planned (``graph.planner``: epilogue folding, per-node dataflow
    selection, tile agreement, merged-group derivation — the reference's
    decisions), every node lowers through this same pipeline, and each
    merged-eligible group runs as one fused-chain or fused-DAG kernel
    launch.  For graphs, ``search`` is the per-node DSE width (int),
    ``tune=k`` measures each merged group against sequential dispatch
    (m-block ladder x stage interleave, at most ``k`` trials a group,
    8 for ``tune=True``) and keeps the winner, and ``dataflow`` /
    ``bounds`` / ``sparsity`` do not apply.
    """
    if isinstance(alg, AlgebraGraph):
        if dataflow is not None or bounds or sparsity:
            raise ValueError(
                "graph generation plans per-node dataflows itself: "
                "dataflow=/bounds=/sparsity= do not apply; use search= "
                "for the per-node DSE width and tune= for merged-group "
                "measurement")
        if search is not None and not isinstance(search, int):
            raise ValueError("for a graph, search= must be an int "
                             "(per-node DSE width)")
        from .graph import executor as _graph_exec
        group_trials = None
        if tune:
            group_trials = (tune if isinstance(tune, int)
                            and not isinstance(tune, bool) else 8)
        return _graph_exec.build(alg, search=search, cfg=cfg, dtype=dtype,
                                 validate=validate, device=device,
                                 tune=group_trials, mesh=mesh)
    if not isinstance(alg, (str, TensorAlgebra)):
        raise TypeError(f"generate() takes a TensorAlgebra, a registry "
                        f"name or an AlgebraGraph, got "
                        f"{type(alg).__name__}")
    device = resolve_device(device)
    algebra = _resolve_algebra(alg, bounds)
    if sparsity:
        algebra = algebra.with_sparsity(**sparsity)

    candidates: Optional[Tuple[Tuple[CostReport, Dataflow], ...]] = None
    if tune:
        if dataflow is not None or search is not None:
            raise ValueError("tune= is mutually exclusive with dataflow= "
                             "and search=")
        from .tune import tuner as _tuner
        width = (tune if isinstance(tune, int)
                 and not isinstance(tune, bool) else 4)
        result = _tuner.tune(algebra, search=width, cfg=cfg, dtype=dtype,
                             device=device, validate=validate)
        acc = Accelerator(result.kernel, tune_result=result)
        return acc.sharded(mesh) if mesh is not None else acc
    if search is not None:
        if dataflow is not None:
            raise ValueError("pass either dataflow= or search=, not both")
        ranked = (_dse.search(algebra, top_k=search, cfg=cfg)
                  if isinstance(search, int) else list(search))
        if not ranked:
            raise ValueError("search produced no candidates")
        errors = []
        kernel = None
        taken = 0
        for rep, df in ranked:
            taken += 1
            try:
                kernel = _lower(algebra, df, cfg=cfg, dtype=dtype,
                                device=device, validate=validate)
                break
            except Exception as e:          # try the next-ranked candidate
                errors.append(f"{df.name}: {e}")
        if kernel is None:
            raise RuntimeError(
                "no search candidate lowered successfully:\n  "
                + "\n  ".join(errors))
        # winner first, then the remaining candidates in rank order
        candidates = (ranked[taken - 1],) + tuple(
            r for i, r in enumerate(ranked) if i != taken - 1)
    else:
        df = _resolve_dataflow(algebra, dataflow)
        kernel = _lower(algebra, df, cfg=cfg, dtype=dtype, device=device,
                        validate=validate)
    acc = Accelerator(kernel, candidates=candidates)
    return acc.sharded(mesh) if mesh is not None else acc
