"""Mesh-level realization of generated CommPlans.

The port of the reference's ``dist`` package.  The compile pipeline
(``repro_torch.compile``) executes the intra-chip KernelPlan; this package
executes the *inter-chip* half of a generated accelerator over
``torch.distributed``, one process per mesh position: each
``TensorCommPlan.kind`` maps to a collective (all_gather = multicast
wires, psum = reduction tree, ppermute ring = systolic nearest-neighbour
links, shard = stationary residency).

Modules:
    comm_engine — the generic CommPlan interpreter: any generated plan ->
                  mesh program (``compile_comm_plan``); what
                  ``repro_torch.generate(...).sharded(mesh)`` executes
    schedules — CommPlan -> named collective schedule (SUMMA / Cannon / ...)
    engine    — hand-written GEMM schedules, kept as the test oracles the
                interpreter is checked against
    spawn     — the rank launcher (``run_ranks``, ``single_rank``)
    selftest, comm_selftest, partition_selftest, sparse_selftest — the
                reference's batteries, each run as
                ``python -m repro_torch.dist.<name>`` over gloo ranks on
                the CPU
"""
from . import comm_engine, engine, schedules, spawn
from .comm_engine import compile_comm_plan
from .schedules import schedule_from_comm_plan

__all__ = ["comm_engine", "compile_comm_plan", "engine", "schedules",
           "schedule_from_comm_plan", "spawn"]
