"""Whole-graph planning: dataflow selection with inter-node agreement.

``plan_graph`` turns a validated :class:`~repro_torch.graph.ir.AlgebraGraph`
into a :class:`GraphPlan` in four passes:

1. **Epilogue folding** — a sole-consumer chain of epilogue nodes
   hanging off an algebra node's output is folded into that node's
   kernel epilogue spec (``kernels/epilogue.py``), so bias/activation/
   softmax run on the fp32 output block inside the producing Pallas
   kernel instead of as separate HBM round trips.  Folding stops at a
   fan-out, a dtype change, or a spec the registry rejects; a folded
   spec the *lowered form* rejects (row-wise op on a reshaped output)
   still executes with the node but outside the kernel, and the cost
   model charges it the round trip.

2. **Per-node dataflow selection** — extends ``dse.search`` node by
   node in topological order: each candidate dataflow is priced by its
   own compute cycles *plus* the HBM traffic of the node's input edges,
   where an edge that can fuse with its already-planned producer under
   this candidate's template costs nothing.  A candidate that keeps a
   producer's output VMEM-resident can therefore beat one with fewer
   raw cycles — fused vs unfused is ranked honestly, per edge.

3. **Tile agreement** — for every fusable algebra→algebra edge the
   producer's output block schedule is made to match the consumer's
   input block schedule: when the intermediate fits the VMEM residency
   budget both sides get whole-tensor blocks (the producer flushes one
   block, the consumer streams it as its full lhs — bit-exactly one
   ``jnp.dot`` per node); otherwise the block sizes are narrowed to a
   common divisor fixpoint.  On a mesh the producer's output partition
   must also land on the same axes as the consumer's lhs partition
   (``plan.solve_partition``) or the edge is demoted to a resharded
   materialization charged at the inter-chip link.

4. **Edge pricing** — every edge decision becomes bytes in a
   :class:`~repro_torch.core.costmodel.GraphCostReport`: materialized edges
   pay a write plus a read per unfused consumer, fused edges pay
   nothing, and the same plan re-priced with fusion disabled gives the
   ``hbm_bytes_unfused`` baseline.

A final pass (3b) walks the fused edges into connected components and
emits one :class:`FusedGroupPlan` per >=2-member component — the
schedule of the merged Pallas megakernel (``kernels/fused_chain.py``)
that runs the whole group as ONE ``pallas_call`` with intermediates in
VMEM scratch.  A purely lhs-chained component keeps the streamed
``kind="chain"`` template (m-block ladder, two interleaves); anything
richer — an edge landing on a consumer's **rhs** (the transpose folds
into the kernel's scratch read), a **batched** producer (batched_gemv's
(batch, n) image), a folded **residual** stream, or an intermediate
that must also feed an out-of-group consumer (exported as a **tap**
output) — lowers through the stage-major ``kind="dag"`` template.
Each group carries a VMEM-budget verdict: when the scratch exceeds
``_vmem_resident_limit`` (or total residency exceeds the budget) the
group is marked ineligible and the executor dispatches its members
sequentially instead.

PyTorch port: a copy of the reference's ``graph/planner.py`` that makes
the same decisions.  Only its imports and one field name change: the
reference's ``cfg.vmem_budget_bytes`` is the port's
``cfg.strip_budget_bytes`` (same value, see ``core/tiling.ArrayConfig``).
Every fallback reason is kept verbatim — "VMEM" included — and so is the
reference's non-converging tile agreement (``_agree_blocks``) at widths
where the gcd-narrowing fixpoint gives up.  The merged groups run on the
CUDA megakernels of ``kernels/fused_chain.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..compile import pipeline
from ..compile.lowering import LoweredForm, lower_form
from ..core import plan as plan_mod, tiling
from ..core.costmodel import (ArrayConfig, CostReport, GraphCostReport,
                              HBM_BYTES_PER_CYCLE, PaperCycleModel)
from ..core.stt import Dataflow
from ..kernels import epilogue as epilogue_mod
from ..kernels import fused_chain as fused_chain_mod
from .ir import AlgebraGraph, GraphNode


def _vmem_resident_limit(cfg: ArrayConfig) -> int:
    """fp32 bytes an intermediate may occupy and still be scheduled as a
    single whole-tensor block (VMEM-resident between producer flush and
    consumer stream).  1/8 of the budget leaves room for the producer's
    operand blocks and the consumer's accumulator alongside it."""
    return cfg.strip_budget_bytes // 8


@dataclasses.dataclass
class NodePlan:
    """The planned schedule of one algebra node (epilogues folded in)."""

    node: GraphNode
    dataflow: Dataflow
    report: CostReport
    form: LoweredForm
    template: str
    blocks: Tuple[int, int, int]
    blocks_constrained: bool            # True: agreement overrode chooser
    epilogue: Tuple[str, ...]           # folded epilogue spec
    bias_edge: Optional[str]            # graph edge feeding the bias op
    epilogue_fused: bool                # spec runs inside the kernel
    folded: Tuple[str, ...]             # epilogue node names folded here
    result_edge: str                    # edge this node's execution yields
    dtype: str
    #: external residual stream folded onto this node's output (an
    #: ``add`` node whose other operand is a graph input); applied in
    #: fp32 after the epilogue, in-kernel when merged, post-kernel when
    #: dispatched sequentially
    residual_edge: Optional[str] = None


@dataclasses.dataclass
class EdgeDecision:
    """Fuse-or-materialize verdict for one consumed edge instance."""

    edge: str
    producer: Optional[str]             # planned algebra node name, or None
    consumer: str
    fused: bool
    reason: str                         # why not fused ("" when fused)
    bytes_hbm: float                    # read bytes this consumer pays
    reshard_bytes: float = 0.0          # inter-chip bytes (mesh mismatch)
    #: which consumer operand the edge lands on: "lhs" (streamed A) or
    #: "rhs" (the (n, k)-stored B — fused via a transposed scratch read)
    side: str = "lhs"


@dataclasses.dataclass
class FusedGroupPlan:
    """A component of fused nodes the executor may run as ONE merged
    Pallas kernel (``kernels/fused_chain.py``): stage order, per-stage
    specs, the agreed m-block, and the VMEM verdict.  ``eligible=False``
    keeps the group as documentation of why the executor falls back to
    sequential dispatch.

    ``kind="chain"`` is the streamed lhs-chained template (``chain`` /
    ``lhs_edge`` / ``rhs_edges`` / ``bias_edges`` describe it);
    ``kind="dag"`` is the stage-major template: ``dag`` holds the bound
    :class:`~repro_torch.kernels.fused_chain.DagStage` specs, ``ext_inputs``
    the ordered external operands as ``(edge, role)`` with role in
    ``{"lhs", "rhs", "a3d", "vec", "res", "bias"}``, and ``taps`` the
    ``(stage name, edge)`` intermediates exported to HBM for
    out-of-group consumers."""

    name: str                           # group id ("mg:<s0>+<s1>+...")
    stages: Tuple[str, ...]             # algebra node names, chain order
    lhs_edge: str                       # external (m, k0) input edge
    rhs_edges: Tuple[str, ...]          # per-stage weight edge ((n, k))
    bias_edges: Tuple[Optional[str], ...]   # per-stage bias edge or None
    chain: Tuple[fused_chain_mod.ChainStage, ...]
    m: int
    k0: int
    bm: int                             # agreed m-block (grid phases)
    dtype: str
    result_edge: str                    # edge the group's primary out yields
    scratch_bytes: int                  # intermediate strip at bm
    vmem_bytes: int                     # total residency estimate
    eligible: bool
    reason: str = ""                    # why not eligible ("" when it is)
    kind: str = "chain"                 # "chain" | "dag"
    dag: Tuple[fused_chain_mod.DagStage, ...] = ()
    ext_inputs: Tuple[Tuple[str, str], ...] = ()    # (edge, role)
    taps: Tuple[Tuple[str, str], ...] = ()          # (stage name, edge)


@dataclasses.dataclass
class GraphPlan:
    """plan_graph's result: per-node schedules + per-edge verdicts."""

    graph: AlgebraGraph
    cfg: ArrayConfig
    dtype: str
    nodes: Dict[str, NodePlan]          # algebra node name -> plan (topo)
    edges: List[EdgeDecision]
    group: str                          # fused-group id for cache keys
    mesh_shape: Optional[Tuple[int, int]] = None
    axes: Tuple[str, str] = ("x", "y")
    #: fused-node chains the executor may merge into one Pallas kernel
    groups: List[FusedGroupPlan] = dataclasses.field(default_factory=list)

    @property
    def order(self) -> Tuple[str, ...]:
        return tuple(self.nodes)

    def node_plan_for_edge(self, edge: str) -> Optional[NodePlan]:
        for np_ in self.nodes.values():
            if np_.result_edge == edge:
                return np_
        return None

    def fused_group_for(self, name: str) -> Optional[str]:
        """The ``fused_group`` cache-key tag for one node's lowering —
        None when the node is entirely unconstrained by the graph, so a
        single-node graph shares the standalone ``lower(alg)`` entry."""
        p = self.nodes[name]
        if p.blocks_constrained or p.epilogue:
            return self.group
        return None

    def cost_report(self) -> GraphCostReport:
        return _price(self)

    def describe(self) -> str:
        rep = self.cost_report()
        lines = [
            f"GraphPlan(group={self.group!r}, dtype={self.dtype}, "
            f"mesh={self.mesh_shape})"
        ]
        for name, p in self.nodes.items():
            ep = (
                f" epilogue={list(p.epilogue)}"
                f"{'' if p.epilogue_fused else ' (unfused)'}"
                if p.epilogue
                else ""
            )
            lines.append(
                f"  {name}: {p.node.algebra.name} df={p.dataflow.name} "
                f"template={p.template} blocks={p.blocks}{ep} "
                f"-> {p.result_edge}"
            )
        for e in self.edges:
            if e.producer is None:
                continue
            verdict = "fused" if e.fused else f"HBM ({e.reason})"
            lines.append(f"  edge {e.producer}->{e.consumer} "
                         f"[{e.edge}]: {verdict}")
        for g in self.groups:
            verdict = ("merged kernel" if g.eligible
                       else f"sequential ({g.reason})")
            tap = (f" taps={[e for _, e in g.taps]}" if g.taps else "")
            lines.append(
                f"  group {g.name} [{g.kind}]: {len(g.stages)} stages "
                f"bm={g.bm} scratch={g.scratch_bytes}B{tap} -> {verdict}")
        lines.append(
            f"  hbm_bytes={rep.hbm_bytes:.0f} "
            f"unfused={rep.hbm_bytes_unfused:.0f} "
            f"saved={rep.saved_hbm_bytes:.0f} "
            f"cycles={rep.cycles:.0f}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Pass 1 — epilogue folding
# ---------------------------------------------------------------------------

def _fold_epilogues(graph: AlgebraGraph) -> Dict[str, dict]:
    """For each algebra node, walk the sole-consumer epilogue chain off
    its output and fold it; returns per-node folding records.  A
    sole-consumer ``add`` node whose *other* operand is a graph input
    folds too (an external residual stream: applied in fp32 after the
    epilogue) and ends the walk; an add whose other operand is produced
    inside the graph stays a standalone node — its group-internal read
    becomes a tap export instead."""
    out: Dict[str, dict] = {}
    for node in graph.topo_nodes:
        if node.algebra is None:
            continue
        spec: List[str] = []
        bias_edge: Optional[str] = None
        residual_edge: Optional[str] = None
        folded: List[str] = []
        edge = node.output
        while True:
            consumers = graph.consumers_of(edge)
            if len(consumers) != 1 or edge == graph.output:
                break
            c = consumers[0]
            if c.algebra is None and c.op == "add":
                if (c.dtype or None) != (node.dtype or None):
                    break
                other = [e for e in c.inputs if e != edge]
                if len(other) == 1 and other[0] in graph.inputs:
                    residual_edge = other[0]
                    folded.append(c.name)
                    edge = c.output
                break                       # nothing folds after the add
            if c.algebra is not None or c.inputs[0] != edge:
                break                       # algebra consumer / bias feed
            if (c.dtype or None) != (node.dtype or None):
                break                       # dtype change: materialize
            try:
                epilogue_mod.validate_spec(tuple(spec) + (c.op,))
            except ValueError:
                break                       # e.g. a second bias op
            spec.append(c.op)
            if epilogue_mod.parse_op(c.op)[0] == "bias":
                bias_edge = c.inputs[1]
            folded.append(c.name)
            edge = c.output
        out[node.name] = dict(epilogue=tuple(spec), bias_edge=bias_edge,
                              residual_edge=residual_edge,
                              folded=tuple(folded), result_edge=edge)
    return out


# ---------------------------------------------------------------------------
# Fusability — producer side, consumer side, partition agreement
# ---------------------------------------------------------------------------

def _producer_fusable(p: NodePlan) -> Optional[str]:
    """Why this node's output cannot stay on-chip for a consumer
    (None = eligible).  The output must be a 2-D identity-finished
    matmul image — either the plain (m, n) form or a batched form whose
    single batch axis IS the output's leading axis (batched_gemv's
    (batch, n) image, the LoweredForm batch folding) — and any
    folded epilogue must run in-kernel."""
    alg = p.node.algebra
    out_shape = alg.tensor_shape(alg.output)
    if p.form.batch:
        if len(p.form.batch) != 1 or p.form.m != 1:
            return (f"producer batch grid {p.form.batch} has no 2-D "
                    f"(batch, n) image the merged template can stream")
        if out_shape != (p.form.batch[0], p.form.n):
            return (f"producer finish reshapes "
                    f"{(p.form.batch[0], p.form.n)} -> {out_shape}")
    elif out_shape != (p.form.m, p.form.n):
        return (f"producer finish reshapes {(p.form.m, p.form.n)} "
                f"-> {out_shape}")
    if p.epilogue and not p.epilogue_fused:
        return "producer epilogue applies outside the kernel"
    return None


def _consumer_fusable(node: GraphNode, edge: str
                      ) -> Tuple[Optional[str], str]:
    """``(why-not, side)`` for this consumer streaming ``edge`` from
    VMEM (why None = it can).  A gemm's A operand maps identically onto
    the kernel lhs; its B operand fuses on the **rhs** side — the edge
    arrives in B's (n, k) storage layout and the kernel reads the
    producer's scratch transposed, so no materialized transpose exists.
    mttkrp/ttmc mix their rhs factors in ``prepare`` and stay unfused."""
    alg = node.algebra
    pos = node.inputs.index(edge)
    tname = alg.inputs[pos].name
    if alg.name != "gemm":
        return (f"consumer {alg.name} prepares its operands "
                f"(non-identity)", "lhs")
    return None, ("lhs" if tname == "A" else "rhs")


def _edge_fuse_reason(p: NodePlan, c_node: GraphNode, c_dtype: str,
                      c_template: str, edge: str,
                      graph: AlgebraGraph, cfg: ArrayConfig
                      ) -> Tuple[Optional[str], str]:
    """Full single-chip fusability verdict for producer-plan -> consumer
    as ``(why-not, side)`` (why None = fusable).  Residency constraints:
    a reduction-tree consumer streams full-k blocks; an rhs-landing edge
    is contracted over in full by every consumer row; and a batched
    producer computes whole-tensor in one stage-major phase — each needs
    the intermediate VMEM-resident."""
    why = _producer_fusable(p)
    if why is not None:
        return why, "lhs"
    why, side = _consumer_fusable(c_node, edge)
    if why is not None:
        return why, side
    if p.dtype != c_dtype:
        return (f"dtype changes {p.dtype} -> {c_dtype} across the edge",
                side)
    shape = graph.edge_shape(edge)
    nbytes = 4 * int(np.prod(shape))
    limit = _vmem_resident_limit(cfg)
    if side == "rhs" and nbytes > limit:
        return (f"rhs-landing intermediate {shape} must stay "
                f"VMEM-resident ({nbytes}B > {limit}B residency limit)",
                side)
    if p.form.batch and nbytes > limit:
        return (f"batched producer output {shape} must stay "
                f"VMEM-resident ({nbytes}B > {limit}B residency limit)",
                side)
    if (c_template == "reduction_tree" and nbytes > limit):
        return (f"consumer reduction-tree needs the full {shape} "
                f"intermediate resident ({nbytes}B > budget)", side)
    return None, side


def _solve(p_or_df: Dataflow, form: LoweredForm, axes, shape):
    return plan_mod.solve_partition(
        plan_mod.comm_plan_for(p_or_df, axes), form, axes=axes, shape=shape)


def _partition_agrees(p: NodePlan, c_df: Dataflow, c_form: LoweredForm,
                      axes: Tuple[str, str], shape: Tuple[int, int],
                      side: str = "lhs") -> Optional[str]:
    """Mesh agreement: the producer's out shards must land where the
    consumer's streamed operand expects them — lhs side pairs edge
    m <-> lhs m / n <-> lhs k; an rhs-landing edge arrives in B's (n, k)
    storage, pairing edge m <-> rhs n / n <-> rhs k — else the edge pays
    an inter-chip reshard (None = agrees)."""
    sol_p = _solve(p.dataflow, p.form, axes, shape)
    sol_c = _solve(c_df, c_form, axes, shape)
    out_ax = sol_p.out.axis_of
    if side == "rhs":
        c_ax, pairs, label = sol_c.rhs.axis_of, (("m", "n"), ("n", "k")), \
            "rhs"
    else:
        c_ax, pairs, label = sol_c.lhs.axis_of, (("m", "m"), ("n", "k")), \
            "lhs"
    for pd, cd in pairs:
        if out_ax.get(pd) != c_ax.get(cd):
            return (f"partition mismatch: producer out {pd}="
                    f"{out_ax.get(pd)!r} vs consumer {label} {cd}="
                    f"{c_ax.get(cd)!r}")
    return None


# ---------------------------------------------------------------------------
# Pass 3 — tile agreement
# ---------------------------------------------------------------------------

def _agree_blocks(plans: Dict[str, NodePlan], fused: List[EdgeDecision],
                  graph: AlgebraGraph, cfg: ArrayConfig) -> None:
    """Make producer output blocks match consumer lhs blocks on every
    fused edge (fixpoint: agreement on one edge can narrow another)."""
    limit = _vmem_resident_limit(cfg)
    for _ in range(1 + len(fused)):
        changed = False
        for e in fused:
            p, c = plans[e.producer], plans[e.consumer]
            m_e, n_e = graph.edge_shape(e.edge)
            bn_c = c.blocks[1]
            if 4 * m_e * n_e <= limit:
                bm, bn = m_e, n_e       # whole tensor: one resident block
                if 4 * m_e * c.form.n <= limit:
                    # consumer accumulator fits too: single-dot schedule
                    # (bit-identical to the oracle's one jnp.dot)
                    bn_c = c.form.n
            else:
                bm = math.gcd(math.gcd(p.blocks[0], c.blocks[0]), m_e)
                bn = math.gcd(math.gcd(p.blocks[1], c.blocks[2]), n_e)
            new_p = (bm, bn, p.blocks[2])
            new_c = (bm, bn_c, bn)
            if new_p != p.blocks:
                p.blocks, p.blocks_constrained, changed = new_p, True, True
            if new_c != c.blocks:
                c.blocks, c.blocks_constrained, changed = new_c, True, True
        if not changed:
            return
    raise RuntimeError("tile agreement did not converge")   # pragma: no cover


# ---------------------------------------------------------------------------
# Pass 3b — merged-kernel group derivation
# ---------------------------------------------------------------------------

def _group_eligibility(chain: List[str], plans: Dict[str, NodePlan],
                       cfg: ArrayConfig) -> Optional[str]:
    """Why this fused component cannot run as one megakernel (None = it
    can).  Stages must be gemms — or batched forms with a 2-D (batch, n)
    image — with in-kernel epilogues and one shared dtype; anything else
    dispatches sequentially (still fused in the schedule/cost-model
    sense)."""
    for name in chain:
        p = plans[name]
        if p.node.algebra.name != "gemm" and not p.form.batch:
            return (f"stage {name} is {p.node.algebra.name}; the merged "
                    f"template chains gemm stages only")
        if p.form.batch and _producer_fusable(p) is not None:
            return f"stage {name}: {_producer_fusable(p)}"
        if p.epilogue and not p.epilogue_fused:
            return (f"stage {name} epilogue applies outside the kernel")
    dtypes = {plans[n].dtype for n in chain}
    if len(dtypes) > 1:
        return f"stages disagree on dtype ({sorted(dtypes)})"
    return None


def _components(plans: Dict[str, NodePlan],
                decisions: List[EdgeDecision]) -> List[List[str]]:
    """Connected components of the fused producer->consumer edges, each
    in topo order (``plans`` preserves the graph's topo order)."""
    parent: Dict[str, str] = {n: n for n in plans}

    def find(x: str) -> str:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for e in decisions:
        if e.fused and e.producer is not None:
            parent[find(e.producer)] = find(e.consumer)
    comps: Dict[str, List[str]] = {}
    for name in plans:
        comps.setdefault(find(name), []).append(name)
    return [names for names in comps.values() if len(names) >= 2]


def _schedulable_subgroups(names: List[str],
                           plans: Dict[str, NodePlan],
                           graph: AlgebraGraph) -> List[List[str]]:
    """Split a fused component into single-dispatch-schedulable runs.

    A merged group fires as ONE kernel at its last member, so none of
    its *external* inputs may depend — through out-of-group nodes — on
    any member's output (an out-of-group consumer of a tap that feeds a
    later member would deadlock the dispatch).  Greedy topo scan: a
    member whose inputs reach the open subgroup's outputs from outside
    closes the subgroup and starts the next one (the closed group's
    results materialize before the next group fires, so later reads of
    them are legal ext inputs)."""
    dep_cache: Dict[Tuple[str, frozenset], bool] = {}

    def depends_on(edge: str, outputs: frozenset) -> bool:
        key = (edge, outputs)
        if key in dep_cache:
            return dep_cache[key]
        dep_cache[key] = False          # cycle-safe default (DAG anyway)
        if edge in outputs:
            hit = True
        else:
            prod = graph.producer_of(edge)
            hit = prod is not None and any(
                depends_on(e, outputs) for e in prod.inputs)
        dep_cache[key] = hit
        return hit

    subgroups: List[List[str]] = []
    current: List[str] = []
    cur_outs: frozenset = frozenset()
    for n in names:
        p = plans[n]
        ins = list(p.node.inputs)
        if p.bias_edge is not None:
            ins.append(p.bias_edge)
        if p.residual_edge is not None:
            ins.append(p.residual_edge)
        internal = {plans[m].result_edge for m in current}
        conflict = any(e not in internal and depends_on(e, cur_outs)
                       for e in ins)
        if conflict:
            subgroups.append(current)
            current, cur_outs = [], frozenset()
        current.append(n)
        cur_outs = cur_outs | {p.result_edge}
    subgroups.append(current)
    return [s for s in subgroups if len(s) >= 2]


def _derive_groups(plans: Dict[str, NodePlan],
                   decisions: List[EdgeDecision],
                   graph: AlgebraGraph, cfg: ArrayConfig
                   ) -> List[FusedGroupPlan]:
    """Turn each connected component of fused edges into a
    :class:`FusedGroupPlan`.

    A purely lhs-chained component whose intermediates are sole-consumed
    keeps the streamed ``kind="chain"`` template.  Everything else —
    rhs-landing edges, batched stages, folded residual streams, and
    intermediates that also feed out-of-group consumers — lowers through
    the stage-major ``kind="dag"`` template; an intermediate some
    outsider reads is exported as a **tap** output, so the producer
    still runs exactly once.
    """
    folded_names = {n for p in plans.values() for n in p.folded}
    groups: List[FusedGroupPlan] = []
    runs = [sub for comp in _components(plans, decisions)
            for sub in _schedulable_subgroups(comp, plans, graph)]
    for names in runs:
        p0, p_last = plans[names[0]], plans[names[-1]]
        gname = "mg:" + "+".join(names)
        member_set = set(names)
        owner_at = {plans[n].result_edge: i for i, n in enumerate(names)}

        def out_of_group_readers(edge):
            return [c.name for c in graph.consumers_of(edge)
                    if c.name not in member_set
                    and c.name not in folded_names]

        # which members must export their intermediate to HBM
        tap_members: List[Tuple[str, str]] = []
        for i, n in enumerate(names[:-1]):
            redge = plans[n].result_edge
            if out_of_group_readers(redge) or redge == graph.output:
                tap_members.append((n, redge))

        why = _group_eligibility(names, plans, cfg)
        if why is not None:
            groups.append(FusedGroupPlan(
                name=gname, stages=tuple(names),
                lhs_edge=p0.node.inputs[0], rhs_edges=(), bias_edges=(),
                chain=(), m=p0.form.m, k0=p0.form.k, bm=p0.blocks[0],
                dtype=p0.dtype, result_edge=p_last.result_edge,
                scratch_bytes=0, vmem_bytes=0, eligible=False,
                reason=why, kind="dag" if tap_members else "chain",
                taps=tuple(tap_members)))
            continue

        # chain-template test: linear lhs chaining, sole-consumed
        # intermediates, external weights, no batch/residual/taps
        is_chain = not tap_members and not any(
            plans[n].form.batch or plans[n].residual_edge is not None
            for n in names)
        if is_chain:
            for i, n in enumerate(names[:-1]):
                redge = plans[n].result_edge
                nxt = plans[names[i + 1]]
                readers = [c.name for c in graph.consumers_of(redge)
                           if c.name not in folded_names]
                if (nxt.node.inputs[0] != redge
                        or readers != [names[i + 1]]
                        or redge == graph.output):
                    is_chain = False
                    break
            if is_chain and any(plans[n].node.inputs[1] in owner_at
                                for n in names):
                is_chain = False        # an rhs lands in-group: dag

        if is_chain:
            groups.append(_chain_group(names, plans, cfg, gname))
        else:
            groups.append(_dag_group(names, plans, graph, cfg, gname,
                                     tap_members, owner_at))
    return groups


def _chain_group(chain: List[str], plans: Dict[str, NodePlan],
                 cfg: ArrayConfig, gname: str) -> FusedGroupPlan:
    """The streamed lhs-chained template."""
    p0 = plans[chain[0]]
    stage_specs = tuple(
        fused_chain_mod.ChainStage(
            k=plans[n].form.k, n=plans[n].form.n,
            epilogue=plans[n].epilogue,
            has_bias=(plans[n].bias_edge is not None
                      and epilogue_mod.needs_bias(plans[n].epilogue)))
        for n in chain)
    # gemm stores its inputs as (A, B): inputs[0] is the streamed
    # lhs edge, inputs[1] the (n, k)-stored weight edge
    rhs_edges = tuple(plans[n].node.inputs[1] for n in chain)
    bias_edges = tuple(
        plans[n].bias_edge if st.has_bias else None
        for n, st in zip(chain, stage_specs))
    m, k0, bm = p0.form.m, p0.form.k, p0.blocks[0]
    eb = _elem_bytes(p0.dtype)
    scratch = fused_chain_mod.chain_scratch_bytes(stage_specs, bm, eb)
    vmem = fused_chain_mod.chain_vmem_bytes(stage_specs, m, k0, bm, eb)
    eligible, reason = True, ""
    if scratch > _vmem_resident_limit(cfg):
        eligible = False
        reason = (f"intermediate scratch strip {scratch}B exceeds "
                  f"the VMEM residency limit "
                  f"{_vmem_resident_limit(cfg)}B")
    elif vmem > cfg.strip_budget_bytes:
        eligible = False
        reason = (f"total residency {vmem}B exceeds the VMEM budget "
                  f"{cfg.strip_budget_bytes}B")
    return FusedGroupPlan(
        name=gname, stages=tuple(chain),
        lhs_edge=p0.node.inputs[0], rhs_edges=rhs_edges,
        bias_edges=bias_edges, chain=stage_specs, m=m, k0=k0, bm=bm,
        dtype=p0.dtype, result_edge=plans[chain[-1]].result_edge,
        scratch_bytes=scratch, vmem_bytes=vmem,
        eligible=eligible, reason=reason)


def _dag_group(names: List[str], plans: Dict[str, NodePlan],
               graph: AlgebraGraph, cfg: ArrayConfig, gname: str,
               tap_members: List[Tuple[str, str]],
               owner_at: Dict[str, int]) -> FusedGroupPlan:
    """Bind a component to the stage-major DAG template: resolve every
    operand to an external slot or an earlier stage's scratch, assign
    tap output slots, and gate on whole-tensor VMEM residency."""
    ext: List[Tuple[str, str]] = []
    ext_slots: Dict[Tuple[str, str], int] = {}

    def ext_slot(edge: str, role: str) -> int:
        key = (edge, role)
        if key not in ext_slots:
            ext_slots[key] = len(ext)
            ext.append(key)
        return ext_slots[key]

    tap_of = {n: slot for slot, (n, _) in enumerate(tap_members)}
    dag: List[fused_chain_mod.DagStage] = []
    for i, n in enumerate(names):
        p = plans[n]
        node = p.node
        if p.form.batch:
            m_eff, k_eff, n_eff = p.form.batch[0], p.form.k, p.form.n
            kind = "batched"
            lhs_src = ("ext", ext_slot(node.inputs[0], "a3d"))
            j = owner_at.get(node.inputs[1])
            rhs_src = (("scr", j) if j is not None and j < i
                       else ("ext", ext_slot(node.inputs[1], "vec")))
        else:
            m_eff, k_eff, n_eff = p.form.m, p.form.k, p.form.n
            kind = "dot"
            j = owner_at.get(node.inputs[0])
            lhs_src = (("scr", j) if j is not None and j < i
                       else ("ext", ext_slot(node.inputs[0], "lhs")))
            j = owner_at.get(node.inputs[1])
            rhs_src = (("scr", j) if j is not None and j < i
                       else ("ext", ext_slot(node.inputs[1], "rhs")))
        res_src = None
        if p.residual_edge is not None:
            j = owner_at.get(p.residual_edge)
            res_src = (("scr", j) if j is not None and j < i
                       else ("ext", ext_slot(p.residual_edge, "res")))
        has_bias = (p.bias_edge is not None
                    and epilogue_mod.needs_bias(p.epilogue))
        bias_idx = ext_slot(p.bias_edge, "bias") if has_bias else -1
        dag.append(fused_chain_mod.DagStage(
            m=m_eff, k=k_eff, n=n_eff, kind=kind, lhs=lhs_src,
            rhs=rhs_src, res=res_src, epilogue=p.epilogue,
            has_bias=has_bias, bias=bias_idx, tap=tap_of.get(n, -1)))

    p0, p_last = plans[names[0]], plans[names[-1]]
    eb = _elem_bytes(p0.dtype)
    scratch = fused_chain_mod.dag_scratch_bytes(dag, eb)
    ext_bytes = 0
    for edge, role in ext:
        nel = int(np.prod(graph.edge_shape(edge)))
        ext_bytes += nel * (4 if role in ("res", "bias") else eb)
    out_bytes = dag[-1].m * dag[-1].n * eb
    out_bytes += sum(st.m * st.n * eb for st in dag if st.tap >= 0)
    vmem = ext_bytes + out_bytes + scratch
    eligible, reason = True, ""
    if scratch > _vmem_resident_limit(cfg):
        eligible = False
        reason = (f"DAG intermediate scratch {scratch}B exceeds the "
                  f"VMEM residency limit {_vmem_resident_limit(cfg)}B")
    elif vmem > cfg.strip_budget_bytes:
        eligible = False
        reason = (f"total residency {vmem}B exceeds the VMEM budget "
                  f"{cfg.strip_budget_bytes}B")
    else:
        try:
            fused_chain_mod.validate_dag(dag)
        except ValueError as e:         # defensive: unbindable wiring
            eligible, reason = False, f"DAG binding failed: {e}"
    return FusedGroupPlan(
        name=gname, stages=tuple(names),
        lhs_edge=p0.node.inputs[0], rhs_edges=(), bias_edges=(),
        chain=(), m=dag[-1].m, k0=dag[0].k, bm=dag[-1].m,
        dtype=p0.dtype, result_edge=p_last.result_edge,
        scratch_bytes=scratch, vmem_bytes=vmem,
        eligible=eligible, reason=reason, kind="dag", dag=tuple(dag),
        ext_inputs=tuple(ext), taps=tuple(tap_members))


# ---------------------------------------------------------------------------
# Pass 4 — pricing
# ---------------------------------------------------------------------------

def _elem_bytes(dtype: str) -> int:
    return int(np.dtype(dtype if dtype != "bfloat16" else "float16"
                        ).itemsize)


def _price(plan: GraphPlan, assume_unfused: bool = False
           ) -> GraphCostReport:
    graph, cfg = plan.graph, plan.cfg
    edge_bytes: Dict[str, float] = {}
    reshard: Dict[str, float] = {}

    def size_bytes(edge: str, dtype: str) -> float:
        return float(np.prod(graph.edge_shape(edge))) * _elem_bytes(dtype)

    def charge(edge: str, b: float) -> None:
        edge_bytes[edge] = edge_bytes.get(edge, 0.0) + b

    fused_edges: List[str] = []
    materialized: List[Tuple[str, str]] = []
    # reads: one per consumed edge instance unless the edge fuses
    for e in plan.edges:
        dtype = (
            plan.nodes[e.consumer].dtype
            if e.consumer in plan.nodes
            else plan.dtype
        )
        if e.fused and not assume_unfused:
            fused_edges.append(f"{e.producer}->{e.consumer}:{e.edge}")
            continue
        charge(e.edge, size_bytes(e.edge, dtype))
        if e.producer is not None:
            why = e.reason or ("fusion disabled" if assume_unfused
                               else "")
            materialized.append((f"{e.producer}->{e.consumer}:{e.edge}",
                                 why))
        if e.reshard_bytes and not assume_unfused:
            reshard[e.edge] = reshard.get(e.edge, 0.0) + e.reshard_bytes
    # writes: a produced edge hits HBM unless every consumer fused it
    for name, p in plan.nodes.items():
        consumers = [e for e in plan.edges if e.producer == name]
        all_fused = (
            consumers
            and all(e.fused for e in consumers)
            and not assume_unfused
        )
        if p.result_edge == graph.output or not all_fused:
            charge(p.result_edge, size_bytes(p.result_edge, p.dtype))
        if p.epilogue and (assume_unfused or not p.epilogue_fused):
            # outside-the-kernel epilogue: one extra round trip
            charge(p.result_edge, 2 * size_bytes(p.result_edge, p.dtype))
    # standalone epilogue nodes (never folded): read + write round trip;
    # their *input* read is already charged via plan.edges
    folded = {n for p in plan.nodes.values() for n in p.folded}
    for node in graph.topo_nodes:
        if node.algebra is None and node.name not in folded:
            charge(node.output, size_bytes(node.output, plan.dtype))

    # tap attribution: a merged group's exported intermediates are
    # already inside edge_bytes (write + out-of-group reads); name them
    tapped: List[str] = []
    tap_bytes = 0.0
    if not assume_unfused:
        for g in plan.groups:
            if not g.eligible:
                continue
            for _, tedge in g.taps:
                tapped.append(f"{g.name}:{tedge}")
                tap_bytes += edge_bytes.get(tedge, 0.0)

    node_cycles = {n: p.report.cycles for n, p in plan.nodes.items()}
    compute = sum(node_cycles.values())
    hbm = sum(edge_bytes.values())
    if assume_unfused:
        unfused = hbm
    else:
        unfused = _price(plan, assume_unfused=True).hbm_bytes_unfused
    return GraphCostReport(
        node_cycles=node_cycles, compute_cycles=compute,
        edge_bytes=edge_bytes, hbm_bytes=hbm, hbm_bytes_unfused=unfused,
        fused_edges=tuple(fused_edges),
        materialized_edges=tuple(materialized),
        reshard_bytes=reshard, mesh_shape=plan.mesh_shape,
        tapped_edges=tuple(tapped), tap_hbm_bytes=tap_bytes)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def plan_graph(graph: AlgebraGraph, *,
               search: Optional[int] = None,
               cfg: ArrayConfig = ArrayConfig(),
               dtype: str = "float32",
               mesh=None,
               axes: Tuple[str, str] = ("x", "y")) -> GraphPlan:
    """Plan a graph: fold epilogues, pick per-node dataflows, agree
    tiles/partitions across fusable edges, price every edge.

    ``search=None`` uses the default output-stationary schedule per
    node; ``search=k`` runs the per-node DSE over the top-k candidates
    of ``dse.search``, ranking each candidate by its compute cycles plus
    the HBM traffic its input edges would actually pay (fused = free).
    ``mesh`` (a Mesh or (rows, cols)) adds the partition-agreement
    constraint and prices disagreeing edges as inter-chip reshards.
    """
    from ..core import dse

    mesh_shape = None if mesh is None else dse._mesh_shape(mesh)
    folds = _fold_epilogues(graph)
    model = PaperCycleModel(cfg)
    group = (
        "g:"
        + "|".join(n.name for n in graph.topo_nodes)
        + "->"
        + graph.output
    )

    plans: "Dict[str, NodePlan]" = {}
    result_owner: Dict[str, str] = {}   # result edge -> planned node name
    decisions: List[EdgeDecision] = []

    for node in graph.topo_nodes:
        if node.algebra is None:
            continue
        alg = node.algebra
        fold = folds[node.name]
        node_dtype = node.dtype or dtype
        form = lower_form(alg)
        epilogue = fold["epilogue"]
        ep_reason = (
            pipeline._epilogue_legal_for_form(alg, form, epilogue)
            if epilogue
            else None
        )
        epilogue_fused = bool(epilogue) and ep_reason is None

        if search:
            candidates = dse.search(alg, top_k=search, cfg=cfg)
        else:
            df0 = pipeline.default_dataflow(alg)
            candidates = [(model.evaluate(alg, df0), df0)]

        best = None
        for rep, df in candidates:
            template = plan_mod.kernel_plan_for(df).template
            extra = 0.0
            for pos, edge in enumerate(node.inputs):
                owner = result_owner.get(edge)
                if owner is None:
                    continue
                why, side = _edge_fuse_reason(
                    plans[owner], node, node_dtype, template, edge,
                    graph, cfg)
                if why is None and mesh_shape is not None:
                    why = _partition_agrees(plans[owner], df, form,
                                            axes, mesh_shape, side=side)
                if why is not None:
                    shape = graph.edge_shape(edge)
                    extra += (float(np.prod(shape))
                              * _elem_bytes(node_dtype)
                              / HBM_BYTES_PER_CYCLE)
            score = rep.cycles + extra
            if best is None or score < best[0]:
                best = (score, rep, df, template)
        _, rep, df, template = best

        blocks = tiling.form_blocks(alg, df, form, cfg.pe_dims)
        if epilogue_fused and epilogue_mod.has_softmax(epilogue):
            blocks = (blocks[0], form.n, blocks[2])
        p = NodePlan(
            node=node, dataflow=df, report=rep, form=form,
            template=template, blocks=blocks, blocks_constrained=False,
            epilogue=epilogue, bias_edge=fold["bias_edge"],
            epilogue_fused=epilogue_fused, folded=fold["folded"],
            result_edge=fold["result_edge"], dtype=node_dtype,
            residual_edge=fold["residual_edge"])
        plans[node.name] = p
        result_owner[p.result_edge] = node.name

        # decide each input edge against its (already planned) producer
        for pos, edge in enumerate(node.inputs):
            owner = result_owner.get(edge)
            if owner is None or owner == node.name:
                decisions.append(EdgeDecision(
                    edge=edge, producer=None, consumer=node.name,
                    fused=False, reason="graph input",
                    bytes_hbm=float(np.prod(graph.edge_shape(edge)))
                    * _elem_bytes(node_dtype)))
                continue
            why, side = _edge_fuse_reason(
                plans[owner], node, node_dtype, template, edge, graph,
                cfg)
            reshard_b = 0.0
            if why is None and mesh_shape is not None:
                why = _partition_agrees(plans[owner], df, form,
                                        axes, mesh_shape, side=side)
                if why is not None:
                    reshard_b = (
                        float(np.prod(graph.edge_shape(edge)))
                        * _elem_bytes(node_dtype)
                    )
            nbytes = (
                0.0
                if why is None
                else float(np.prod(graph.edge_shape(edge)))
                * _elem_bytes(node_dtype)
            )
            decisions.append(EdgeDecision(
                edge=edge, producer=owner, consumer=node.name,
                fused=why is None, reason=why or "", bytes_hbm=nbytes,
                reshard_bytes=reshard_b, side=side))
        if fold["bias_edge"] is not None:
            decisions.append(EdgeDecision(
                edge=fold["bias_edge"], producer=None,
                consumer=node.name, fused=False, reason="graph input",
                bytes_hbm=float(np.prod(
                    graph.edge_shape(fold["bias_edge"])))
                * _elem_bytes(node_dtype)))
        if fold["residual_edge"] is not None:
            # external residual stream folded onto this node's output:
            # still a real HBM read
            decisions.append(EdgeDecision(
                edge=fold["residual_edge"], producer=None,
                consumer=node.name, fused=False, reason="graph input",
                bytes_hbm=float(np.prod(
                    graph.edge_shape(fold["residual_edge"])))
                * _elem_bytes(node_dtype)))

    # standalone (unfolded) epilogue nodes read their tensor input too
    folded_names = {n for p in plans.values() for n in p.folded}
    for node in graph.topo_nodes:
        if node.algebra is None and node.name not in folded_names:
            for e in node.inputs:
                decisions.append(EdgeDecision(
                    edge=e, producer=result_owner.get(e),
                    consumer=node.name, fused=False,
                    reason="standalone epilogue node",
                    bytes_hbm=float(np.prod(graph.edge_shape(e)))
                    * _elem_bytes(dtype)))

    plan = GraphPlan(graph=graph, cfg=cfg, dtype=dtype, nodes=plans,
                     edges=decisions, group=group, mesh_shape=mesh_shape,
                     axes=axes)
    # block agreement drives the *streamed* chain template: only
    # lhs-landing edges off non-batched producers constrain m/n blocks
    # (rhs-landing and batched edges are whole-tensor VMEM-resident by
    # construction — the dag template pins them full-size)
    _agree_blocks(plans,
                  [e for e in decisions
                   if e.fused and e.side == "lhs"
                   and not plans[e.producer].form.batch],
                  graph, cfg)
    plan.groups = _derive_groups(plans, decisions, graph, cfg)
    return plan
