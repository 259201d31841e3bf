"""The AlgebraGraph IR: a DAG of tensor algebras and epilogue ops.

Nodes are either

* **algebra** nodes — one :class:`~repro_torch.core.algebra.TensorAlgebra`
  whose ordered ``inputs`` edges bind to ``alg.inputs`` by position, or
* **epilogue** nodes — one elementwise / row-wise post-processing op
  from the ``kernels/epilogue.py`` registry (``"gelu"``,
  ``"scale:0.125"``, ``"softmax"``, ``"bias"``).  A ``"bias"`` node
  takes a second input edge: the rank-1 bias vector.
* **add** nodes — ``op == "add"``: elementwise sum of two same-shape
  edges (the transformer residual stream).  Adds are not epilogue ops:
  the planner folds one into the producing kernel only when its other
  operand is a graph input (an external residual stream); otherwise it
  stays a standalone node and the edge it reads from a merged group is
  exported as a tap.

Edges are tensors, named by strings; every edge has exactly one
producer (a node or the graph input list) and any number of consumers.
Shapes are inferred from the algebras' loop bounds and validated at
construction — a shape-mismatched wiring fails here, not at trace time.

The IR is deliberately *functional*: ``reference(operands)`` evaluates
the whole graph with the numpy loop-nest oracle
(``TensorAlgebra.reference``) composed with the numpy epilogue mirror,
which is the bit-for-bit semantics every execution plan must reproduce.

PyTorch port: a copy of the reference's ``graph/ir.py`` on the port's
``core.algebra`` and ``kernels.epilogue`` (the reference module reaches
jax through its epilogue import).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from ..core.algebra import TensorAlgebra
from ..kernels import epilogue as epilogue_mod


@dataclasses.dataclass(frozen=True)
class GraphNode:
    """One node: an algebra or a single epilogue op.

    ``inputs`` are edge names; for algebra nodes they bind positionally
    to ``algebra.inputs`` (e.g. gemm's ``("A", "B")``), for epilogue
    nodes the first is the tensor and an optional second is the bias
    vector (``op == "bias"`` only).  ``dtype`` overrides the graph-level
    compute dtype for this node (None = inherit).
    """

    name: str
    inputs: Tuple[str, ...]
    output: str
    algebra: Optional[TensorAlgebra] = None
    op: Optional[str] = None
    dtype: Optional[str] = None

    @property
    def kind(self) -> str:
        return "algebra" if self.algebra is not None else "epilogue"

    def __post_init__(self):
        if (self.algebra is None) == (self.op is None):
            raise ValueError(f"node {self.name!r}: exactly one of "
                             f"algebra= or op= must be given")
        if self.algebra is not None:
            want = len(self.algebra.inputs)
            if len(self.inputs) != want:
                raise ValueError(
                    f"node {self.name!r}: algebra {self.algebra.name} has "
                    f"{want} input tensors, got {len(self.inputs)} edges")
        elif self.op == "add":
            if len(self.inputs) != 2:
                raise ValueError(
                    f"node {self.name!r}: add takes 2 input edges, "
                    f"got {len(self.inputs)}")
        else:
            opname, _ = epilogue_mod.parse_op(self.op)
            want = 2 if opname == "bias" else 1
            if len(self.inputs) != want:
                raise ValueError(
                    f"node {self.name!r}: epilogue op {self.op!r} takes "
                    f"{want} input edge(s), got {len(self.inputs)}")


@dataclasses.dataclass(frozen=True)
class AlgebraGraph:
    """A validated DAG of :class:`GraphNode`.

    ``inputs`` are the external edge names (the operand-dict keys of the
    generated :class:`~repro_torch.graph.executor.GraphAccelerator`);
    ``output`` is the edge whose value ``__call__`` returns.
    """

    nodes: Tuple[GraphNode, ...]
    inputs: Tuple[str, ...]
    output: str

    def __post_init__(self):
        names = [n.name for n in self.nodes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate node names: {names}")
        produced: Dict[str, str] = {}
        for n in self.nodes:
            if n.output in produced:
                raise ValueError(
                    f"edge {n.output!r} produced by both "
                    f"{produced[n.output]!r} and {n.name!r}")
            if n.output in self.inputs:
                raise ValueError(f"edge {n.output!r} is both a graph "
                                 f"input and {n.name!r}'s output")
            produced[n.output] = n.name
        known = set(self.inputs) | set(produced)
        for n in self.nodes:
            for e in n.inputs:
                if e not in known:
                    raise ValueError(f"node {n.name!r} consumes unknown "
                                     f"edge {e!r}")
        if self.output not in produced:
            raise ValueError(f"graph output {self.output!r} is not "
                             f"produced by any node")
        # topo-sort (also rejects cycles) and cache derived maps; the
        # dataclass is frozen so object.__setattr__ is the sanctioned way
        object.__setattr__(self, "_topo", self._topo_sort())
        object.__setattr__(self, "_shapes", self._infer_shapes())

    # -- topology ---------------------------------------------------------
    def producer_of(self, edge: str) -> Optional[GraphNode]:
        """The node producing ``edge`` (None for graph inputs)."""
        for n in self.nodes:
            if n.output == edge:
                return n
        return None

    def consumers_of(self, edge: str) -> Tuple[GraphNode, ...]:
        return tuple(n for n in self.nodes if edge in n.inputs)

    def node(self, name: str) -> GraphNode:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(name)

    def _topo_sort(self) -> Tuple[GraphNode, ...]:
        ready = set(self.inputs)
        order: List[GraphNode] = []
        pending = list(self.nodes)
        while pending:
            nxt = [n for n in pending if all(e in ready for e in n.inputs)]
            if not nxt:
                raise ValueError(
                    f"graph has a cycle through "
                    f"{sorted(n.name for n in pending)}")
            for n in nxt:
                order.append(n)
                ready.add(n.output)
                pending.remove(n)
        return tuple(order)

    @property
    def topo_nodes(self) -> Tuple[GraphNode, ...]:
        """Nodes in a topological order (producers before consumers)."""
        return self._topo

    # -- shapes -----------------------------------------------------------
    def _expected_input_shape(self, node: GraphNode, pos: int,
                              shapes: Dict[str, Tuple[int, ...]]
                              ) -> Optional[Tuple[int, ...]]:
        if node.algebra is not None:
            return node.algebra.tensor_shape(node.algebra.inputs[pos])
        x_shape = shapes.get(node.inputs[0])
        if pos == 0:
            return None          # epilogue x: any shape, propagated below
        if node.op == "add":
            return x_shape       # both addends share one shape
        return None if x_shape is None else (x_shape[-1],)

    def _infer_shapes(self) -> Dict[str, Tuple[int, ...]]:
        shapes: Dict[str, Tuple[int, ...]] = {}
        for node in self._topo:
            for pos, e in enumerate(node.inputs):
                want = self._expected_input_shape(node, pos, shapes)
                if want is None:
                    continue
                have = shapes.get(e)
                if have is None:
                    shapes[e] = want
                elif have != want:
                    raise ValueError(
                        f"edge {e!r} shape mismatch: produced/used as "
                        f"{have}, but node {node.name!r} expects {want}")
            if node.algebra is not None:
                shapes[node.output] = node.algebra.tensor_shape(
                    node.algebra.output)
            else:
                if node.inputs[0] not in shapes:
                    raise ValueError(
                        f"cannot infer shape of edge {node.inputs[0]!r} "
                        f"feeding epilogue node {node.name!r}")
                shapes[node.output] = shapes[node.inputs[0]]
        return shapes

    def edge_shape(self, edge: str) -> Tuple[int, ...]:
        try:
            return self._shapes[edge]
        except KeyError:
            raise KeyError(f"edge {edge!r} has no inferred shape "
                           f"(unused graph input?)") from None

    # -- oracle -----------------------------------------------------------
    def reference(self, operands: Mapping[str, np.ndarray]) -> np.ndarray:
        """Evaluate the graph with the numpy loop-nest oracle + numpy
        epilogue mirror — the semantics every execution must match."""
        values: Dict[str, np.ndarray] = {
            e: np.asarray(operands[e]) for e in self.inputs}
        for node in self._topo:
            if node.algebra is not None:
                ins = dict(zip((t.name for t in node.algebra.inputs),
                               (values[e] for e in node.inputs)))
                values[node.output] = node.algebra.reference(ins)
            elif node.op == "add":
                values[node.output] = (
                    np.asarray(values[node.inputs[0]], np.float64)
                    + np.asarray(values[node.inputs[1]], np.float64))
            else:
                bias = (values[node.inputs[1]] if len(node.inputs) == 2
                    else None)
                values[node.output] = epilogue_mod.apply_epilogue_np(
                    values[node.inputs[0]], (node.op,), bias=bias)
        return values[self.output]

    def random_operands(self, seed: int = 0) -> Dict[str, np.ndarray]:
        """Random integer operands for every graph input (same
        convention as ``TensorAlgebra.random_operands``)."""
        rng = np.random.default_rng(seed)
        return {e: rng.integers(-4, 5, size=self.edge_shape(e)
                                ).astype(np.int64)
                for e in self.inputs}

    def describe(self) -> str:
        lines = [f"AlgebraGraph(inputs={list(self.inputs)}, "
                 f"output={self.output!r})"]
        for n in self._topo:
            what = n.algebra.name if n.algebra is not None else n.op
            lines.append(f"  {n.name}: {what}({', '.join(n.inputs)}) "
                         f"-> {n.output} {self.edge_shape(n.output)}")
        return "\n".join(lines)
