"""CommPlan -> named mesh-level collective schedule.

A copy of the reference's ``dist/schedules.py`` (pure Python) over the
port's ``core.plan``.

``plan.comm_plan_for`` emits one collective kind per tensor; the *set* of
kinds identifies the classic distributed-GEMM algorithm the dataflow maps
to on a chip mesh (the paper's PE-array wires, chip-scale):

    all_gather inputs + sharded output      -> SUMMA
    ppermute-ring inputs + sharded output   -> Cannon
    sharded operand + psum output           -> ring reduce-scatter family
    streamed (unicast) operand              -> fully-partitioned streaming
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from ..core.plan import CommPlan


@dataclasses.dataclass(frozen=True)
class CollectiveSchedule:
    """A named schedule plus the per-tensor collective ops realizing it."""

    name: str
    comm: CommPlan

    @property
    def per_tensor(self) -> Tuple[Tuple[str, str], ...]:
        return tuple((t.tensor, t.kind) for t in self.comm.tensors)

    def __str__(self) -> str:
        ops = " ".join(f"{t}:{k}" for t, k in self.per_tensor)
        return f"{self.name}[{ops}]"


def schedule_from_comm_plan(comm: CommPlan) -> CollectiveSchedule:
    """Classify a generated CommPlan as a named distributed algorithm."""
    kinds = [t.kind for t in comm.tensors]
    out_kind = kinds[-1]
    in_kinds = kinds[:-1]

    if out_kind == "psum":
        name = "ring-reduce"              # partial sums combined on the mesh
    elif all(k == "all_gather" for k in in_kinds):
        name = "summa"                    # multicast panels, local rank-k
    elif all(k == "ppermute_ring" for k in in_kinds):
        name = "cannon"                   # skewed blocks circulate on rings
    elif "stream" in in_kinds:
        name = "streaming"                # an operand has no reuse to exploit
    elif "ppermute_ring" in in_kinds or "all_gather" in in_kinds:
        name = "hybrid"                   # mixed stationary/moving operands
    else:
        name = "local"                    # fully sharded, no motion
    return CollectiveSchedule(name, comm)
