"""repro_torch.graph — whole-graph accelerator generation on the card.

The port of the reference's ``graph`` package:

* :mod:`repro_torch.graph.ir`         — the :class:`AlgebraGraph` IR,
* :mod:`repro_torch.graph.planner`    — per-node dataflow selection with
  inter-node tile/partition agreement, epilogue folding and merged-group
  derivation (the reference's decisions, value for value),
* :mod:`repro_torch.graph.executor`   — the :class:`GraphAccelerator`
  ``repro_torch.generate(graph)`` returns,
* :mod:`repro_torch.graph.from_model` — a dense model layer as a graph.
"""
from .executor import GraphAccelerator
from .ir import AlgebraGraph, GraphNode
from .planner import FusedGroupPlan, GraphPlan, plan_graph

__all__ = ["AlgebraGraph", "GraphNode", "GraphAccelerator",
           "FusedGroupPlan", "GraphPlan", "plan_graph"]
