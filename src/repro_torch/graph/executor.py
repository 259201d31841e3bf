"""GraphAccelerator — the fused executable ``repro_torch.generate(graph)``
returns.

The port of the reference's ``graph/executor.py``.  Every
merged-eligible group in ``plan.groups`` lowers to ONE kernel launch
(``compile.pipeline.lower_group`` -> ``kernels/fused_chain.py``), and
``__call__`` dispatches that launch when the group's external inputs are
ready instead of one template launch per member node.  Nodes outside any
merged group — and every node of a group that planned ineligible or was
built with ``merge=False`` — dispatch one by one through the STT
templates.  The HBM accounting in ``cost_report()`` is the cost model's
view of the same schedule either way.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..compile import pipeline
from ..core.costmodel import GraphCostReport
from ..kernels import epilogue as epilogue_mod
from ..kernels.ops import resolve_device
from .ir import AlgebraGraph
from .planner import GraphPlan, plan_graph


#: reserved operand-key prefix; ``build()`` rejects graphs whose tensor
#: or edge names use it (a collision would silently shadow the operand)
BIAS_KEY_PREFIX = "bias:"


def bias_operand_key(edge: str) -> str:
    """Operand-dict key a fused bias vector rides under (prefixed so it
    can never collide with an algebra tensor name)."""
    return f"{BIAS_KEY_PREFIX}{edge}"


def _check_bias_namespace(graph: AlgebraGraph) -> None:
    """Reject names inside the reserved ``bias:`` operand namespace.

    The executor injects fused bias vectors into each kernel's operand
    dict under ``bias_operand_key(edge)``; a user tensor or edge named
    inside that prefix would silently shadow (or be shadowed by) the
    injected operand.  Caught at build time instead.
    """
    offenders = []
    for e in graph.inputs:
        if e.startswith(BIAS_KEY_PREFIX):
            offenders.append(f"graph input edge {e!r}")
    for node in graph.topo_nodes:
        if node.output.startswith(BIAS_KEY_PREFIX):
            offenders.append(f"edge {node.output!r} (node {node.name})")
        if node.algebra is not None:
            for t in (*node.algebra.inputs, node.algebra.output):
                if t.name.startswith(BIAS_KEY_PREFIX):
                    offenders.append(
                        f"tensor {t.name!r} (node {node.name})")
    if offenders:
        raise ValueError(
            f"name(s) collide with the reserved {BIAS_KEY_PREFIX!r} "
            f"operand-key prefix: {', '.join(sorted(set(offenders)))}; "
            f"rename them — the executor uses that namespace to route "
            f"fused bias vectors into kernels")


@dataclasses.dataclass
class GraphAccelerator:
    """Executable for a planned :class:`AlgebraGraph` on one device.

    ``__call__`` takes one array per graph input edge and returns the
    graph output, running each planned node's compiled kernel once (a
    diamond fan-out reuses the memoized edge value — producers are never
    re-computed) with folded epilogues applied inside the kernels.
    Nodes belonging to a merged group (``group_kernels``) do not
    dispatch individually: the whole group runs as one kernel launch,
    its intermediates never becoming separate tensors.
    """

    graph: AlgebraGraph
    plan: GraphPlan
    kernels: Dict[str, pipeline.CompiledKernel]
    device: torch.device
    #: group name -> merged megakernel; populated for the eligible groups
    #: when built with ``merge=True``
    group_kernels: Dict[str, pipeline.CompiledGroupKernel] = (
        dataclasses.field(default_factory=dict))
    #: group name -> :class:`~repro_torch.tune.GroupTuneResult` when
    #: built with ``tune=k`` (measured merged-vs-sequential verdicts)
    group_tuning: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: whether ``build(merge=...)`` allowed merged lowering at all —
    #: lets ``describe()`` say *why* an eligible group runs sequentially
    merge_enabled: bool = True
    validated: bool = False

    @property
    def dtype(self) -> torch.dtype:
        return pipeline.torch_dtype(self.plan.dtype)

    def __call__(self, operands: Mapping[str, object]) -> torch.Tensor:
        missing = [e for e in self.graph.inputs if e not in operands]
        if missing:
            raise ValueError(f"missing graph input(s): {missing}")
        values: Dict[str, torch.Tensor] = {
            e: torch.as_tensor(operands[e], device=self.device)
            for e in self.graph.inputs}
        folded = {n for p in self.plan.nodes.values() for n in p.folded}
        merged = {g.name: g for g in self.plan.groups
                  if g.name in self.group_kernels}
        member_of = {s: g for g in merged.values() for s in g.stages}
        # dispatch units: merged groups fire once (when their external
        # inputs are ready), everything else per node.  A plain topo walk
        # is NOT a valid schedule: a tapped intermediate only
        # materializes when its whole group fires, so an out-of-group
        # consumer between two members must wait — a ready queue over
        # units handles any interleaving.
        units = []
        for node in self.graph.topo_nodes:
            if node.name in folded:
                continue                 # runs inside its producer kernel
            g = member_of.get(node.name)
            if g is not None:
                if node.name != g.stages[-1]:
                    continue             # runs inside the merged kernel
                units.append(("group", g))
            else:
                units.append(("node", node))
        pending = units
        while pending:
            later = []
            for kind, u in pending:
                if all(e in values for e in self._unit_inputs(kind, u)):
                    self._run_unit(kind, u, values)
                else:
                    later.append((kind, u))
            if len(later) == len(pending):   # pragma: no cover
                raise RuntimeError(
                    f"graph execution deadlocked; unschedulable units: "
                    f"{[getattr(u, 'name', u) for _, u in later]}")
            pending = later
        return values[self.graph.output]

    def _unit_inputs(self, kind, u):
        """Edges a dispatch unit needs materialized before it can run."""
        if kind == "group":
            if u.kind == "dag":
                return [e for e, _ in u.ext_inputs]
            return ([u.lhs_edge] + list(u.rhs_edges)
                    + [e for e in u.bias_edges if e is not None])
        edges = list(u.inputs)
        p = self.plan.nodes.get(u.name)
        if p is not None:
            if p.bias_edge is not None:
                edges.append(p.bias_edge)
            if p.residual_edge is not None:
                edges.append(p.residual_edge)
        return edges

    def _run_unit(self, kind, u, values) -> None:
        f32 = torch.float32
        if kind == "group":
            gk = self.group_kernels[u.name]
            if gk.kind == "dag":
                res, *taps = gk([values[e] for e, _ in u.ext_inputs])
                values[u.result_edge] = res
                # memoize tapped intermediates like ordinary edges:
                # out-of-group consumers read them, the producer never
                # re-runs
                for (_, tedge), t in zip(u.taps, taps):
                    values[tedge] = t
            else:
                values[u.result_edge] = gk(
                    values[u.lhs_edge],
                    [values[e] for e in u.rhs_edges],
                    [values[e] for e in u.bias_edges if e is not None])
            return
        node = u
        if node.algebra is not None:
            p = self.plan.nodes[node.name]
            kern = self.kernels[node.name]
            ops = {t.name: values[e]
                   for t, e in zip(node.algebra.inputs, node.inputs)}
            if kern.bias_tensor is not None:
                ops[kern.bias_tensor] = values[p.bias_edge]
            out = kern(ops)
            if p.epilogue and not p.epilogue_fused:
                # legal-but-not-in-kernel spec: apply on the finished
                # tensor (the cost model charged the round trip)
                bias = (None if p.bias_edge is None
                        else values[p.bias_edge].to(f32))
                out = epilogue_mod.apply_epilogue(
                    out.to(f32), p.epilogue, bias=bias).to(kern.dtype)
            if p.residual_edge is not None:
                # folded external residual stream, dispatched
                # sequentially: fp32 add after the epilogue — the exact
                # math the merged dag kernel runs in its flush
                out = (out.to(f32) + values[p.residual_edge].to(f32)
                       ).to(kern.dtype)
            values[p.result_edge] = out
        elif node.op == "add":
            a = values[node.inputs[0]].to(f32)
            b = values[node.inputs[1]].to(f32)
            values[node.output] = (a + b).to(self.dtype)
        else:
            bias = (None if len(node.inputs) == 1
                    else values[node.inputs[1]].to(f32))
            x = values[node.inputs[0]].to(f32)
            values[node.output] = epilogue_mod.apply_epilogue(
                x, (node.op,), bias=bias).to(self.dtype)

    def cost_report(self) -> GraphCostReport:
        """Graph-level cycle/byte totals — fused edges priced at zero
        HBM traffic, with the unfused baseline alongside."""
        return self.plan.cost_report()

    def validate(self, seed: int = 0, atol: float = 1e-3,
                 rtol: float = 1e-5) -> float:
        """Execute on random integer operands and compare against the
        graph's float64 numpy oracle; returns max abs error, raises on
        mismatch.  ``rtol`` scales with the output magnitude: a chain
        compounds fp32 rounding where a single exact integer gemm does
        not."""
        operands = self.graph.random_operands(seed)
        got = self(operands).detach().to("cpu", torch.float64).numpy()
        want = np.asarray(self.graph.reference(operands), np.float64)
        err = float(np.abs(got - want).max()) if got.size else 0.0
        bound = atol + rtol * (float(np.abs(want).max()) if want.size
                               else 0.0)
        if got.shape != want.shape or err > bound:
            raise AssertionError(
                f"graph execution diverged from reference: shape "
                f"{got.shape} vs {want.shape}, max err {err:.3e} "
                f"(bound {bound:.3e})")
        self.validated = True
        return err

    def describe(self) -> str:
        """Plan description + one line per fused group stating how it
        actually executes: merged (with the chosen knobs) or sequential
        **with the fallback reason verbatim** — "why didn't this fuse"
        must be diagnosable from here alone."""
        lines = [self.plan.describe()]
        for g in self.plan.groups:
            gk = self.group_kernels.get(g.name)
            if gk is not None:
                lines.append(
                    f"  merged {g.name}: one kernel launch, bm={gk.bm} "
                    f"interleave={gk.interleave} ({gk.source})")
                continue
            if not g.eligible:
                why = g.reason
            elif not self.merge_enabled:
                why = "merging disabled (merge=False)"
            else:
                res = self.group_tuning.get(g.name)
                why = ("tuner verdict: sequential dispatch measured "
                       "faster" if res is not None and not res.merged
                       else "tuned cache verdict: sequential dispatch "
                            "wins on this machine")
            lines.append(f"  sequential {g.name}: {why}")
        return "\n".join(lines)


def build(graph: AlgebraGraph, *,
          search: Optional[int] = None,
          plan: Optional[GraphPlan] = None,
          cfg=None, dtype=torch.float32,
          validate: Optional[bool] = None,
          merge: bool = True,
          device=None,
          tune: Optional[int] = None,
          mesh=None) -> GraphAccelerator:
    """Plan (unless a plan is given) and lower a graph to an executable.

    Each node lowers through the one compile pipeline (``pipeline.lower``)
    with the plan's agreed blocks, folded epilogue spec and fused-group
    tag; an unconstrained node lowers with none of them and therefore
    shares the standalone ``generate(alg)`` cache entry.

    ``merge=True`` (default) additionally lowers every merged-eligible
    fused group to a single megakernel (``pipeline.lower_group``);
    ``merge=False`` keeps per-node dispatch — the merged kernels'
    baseline.  ``tune=k`` measures merged variants (m-block ladder x
    interleave, at most ``k`` trials per group) against sequential
    dispatch and keeps whichever wins, persisting the verdict in the
    on-disk tuning cache.  ``device`` defaults to the card (raises
    without one).  ``mesh=`` waits for the mesh slice and raises.
    """
    if mesh is not None:
        raise NotImplementedError(
            "graph execution on a mesh (build(mesh=...)) arrives with the "
            "mesh slice")
    device = resolve_device(device)
    _check_bias_namespace(graph)
    from ..core.costmodel import ArrayConfig
    cfg = cfg if cfg is not None else ArrayConfig()
    if plan is None:
        plan = plan_graph(graph, search=search, cfg=cfg,
                          dtype=pipeline._dtype_name(
                              pipeline.torch_dtype(dtype)))
    kernels: Dict[str, pipeline.CompiledKernel] = {}
    for name, p in plan.nodes.items():
        fused_ep = p.epilogue if p.epilogue_fused else ()
        bias_key = (bias_operand_key(p.bias_edge)
                    if (fused_ep and p.bias_edge is not None
                        and epilogue_mod.needs_bias(fused_ep)) else None)
        kernels[name] = pipeline.lower(
            p.node.algebra, p.dataflow, cfg=cfg,
            dtype=pipeline.torch_dtype(p.dtype), device=device,
            validate=validate,
            blocks=p.blocks if p.blocks_constrained else None,
            epilogue=fused_ep, bias_tensor=bias_key,
            fused_group=plan.fused_group_for(name))
    group_kernels: Dict[str, pipeline.CompiledGroupKernel] = {}
    group_tuning: Dict[str, Any] = {}
    if merge:
        for g in plan.groups:
            if not g.eligible:
                continue                 # planner fallback: sequential
            if tune:
                from ..tune import tuner as tuner_mod
                res = tuner_mod.tune_group(plan, g, device=device,
                                           max_trials=tune)
                group_tuning[g.name] = res
                if res.merged and res.kernel is not None:
                    group_kernels[g.name] = res.kernel
                continue
            gk = pipeline.lower_group(plan, g, device=device,
                                      validate=validate)
            if gk is not None:          # None: tuned sequential verdict
                group_kernels[g.name] = gk
    return GraphAccelerator(graph=graph, plan=plan, kernels=kernels,
                            device=device, group_kernels=group_kernels,
                            group_tuning=group_tuning,
                            merge_enabled=bool(merge))
