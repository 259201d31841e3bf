"""TensorLib core for the PyTorch port: STT dataflow generation.

Copies of the reference's jax-free ``core`` modules (same decisions,
own import paths) plus ``hopper``, the H100 counterpart of the
reference's TPU model.

Public API:
    algebra.get_algebra / PAPER_ALGEBRAS  — Table II tensor algebras
    stt.apply_stt                          — STT matrix -> Dataflow
    stt.simulate                           — space-time functional simulator
    plan.plan_for                          — Dataflow -> kernel + collectives
    costmodel.PaperCycleModel              — paper Fig. 5/6 analytical model
    dse.enumerate_dataflows / sweep        — design-space exploration
    hopper.H100 / RooflineTerms            — target-hardware roofline model
"""
from . import algebra, costmodel, dse, hopper, linalg, plan, stt, tiling
from .algebra import PAPER_ALGEBRAS, Sparsity, TensorAlgebra, get_algebra
from .costmodel import ArrayConfig, CostReport, PaperCycleModel
from .hopper import H100, HopperSpec, RooflineTerms
from .plan import CommPlan, ExecutionPlan, KernelPlan, plan_for
from .stt import (Dataflow, DataflowClass, InvalidSTT, apply_stt, simulate,
                  stt_from_name)

__all__ = [
    "algebra", "costmodel", "dse", "hopper", "linalg", "plan", "stt",
    "tiling", "PAPER_ALGEBRAS", "Sparsity", "TensorAlgebra", "get_algebra",
    "ArrayConfig", "CostReport", "PaperCycleModel",
    "H100", "HopperSpec", "RooflineTerms",
    "CommPlan", "ExecutionPlan", "KernelPlan", "plan_for",
    "Dataflow", "DataflowClass", "InvalidSTT", "apply_stt", "simulate",
    "stt_from_name",
]
