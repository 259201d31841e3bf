"""Distributed STT-GEMM engine selftests, over gloo ranks on the CPU.

    PYTHONPATH=src python -m repro_torch.dist.selftest

The port of the reference's ``dist/selftest.py``; the 8 fake devices
become 8 ranks (``spawn.run_ranks``).  Checks:
  * CommPlan -> schedule classification for the classic GEMM STTs,
  * SUMMA (all_gather schedule) vs the numpy oracle on a 2x4 mesh,
  * ring-reduce (psum schedule) vs the oracle on a 2x4 mesh,
  * Cannon (ppermute-ring schedule) vs the oracle on a 2x2 submesh,
  * schedule selection driven end-to-end from apply_stt + comm_plan_for.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import algebra, plan, stt
from . import engine, schedules, spawn
from .cases import build_meshes


def _gemm_schedule(kind: str):
    g = algebra.gemm(32, 32, 32)
    df = stt.apply_stt(g, ("m", "n", "k"), stt.stt_from_name(kind))
    return df, schedules.schedule_from_comm_plan(plan.comm_plan_for(df))


def operands(seed: int = 0):
    """The selftest's (32, 32) x (32, 32) standard-normal operands."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((32, 32)).astype(np.float32),
            rng.standard_normal((32, 32)).astype(np.float32))


def oracle_ranks(device: str = "cpu", backend=None) -> dict:
    """Rank function: the three hand-written schedules on their meshes;
    rank 0's global outputs."""
    dev = torch.device(device)
    meshes = build_meshes([(2, 4), (2, 2)], device=dev, backend=backend)
    a, b = (torch.as_tensor(x, device=dev) for x in operands())
    out = {"summa": engine.summa_matmul(a, b, meshes[(2, 4)]),
           "ring_reduce": engine.ring_reduce_matmul(a, b, meshes[(2, 4)])}
    sq = meshes[(2, 2)]
    if sq.get_coordinate() is not None:
        out["cannon"] = engine.cannon_matmul(a, b, sq)
    return {k: v.cpu().numpy() for k, v in out.items()}


def main() -> None:
    a, b = operands()
    want = a.astype(np.float64) @ b.astype(np.float64)

    # 1. classification of the classic STTs
    _, summa = _gemm_schedule("identity")
    assert summa.name == "summa", summa
    df_sst, cannon = _gemm_schedule("output_stationary")
    assert cannon.name == "cannon", cannon
    _, hybrid = _gemm_schedule("weight_stationary")
    assert hybrid.name == "hybrid", hybrid
    print(f"schedule classification: {summa} / {cannon} / {hybrid}")

    got = spawn.run_ranks(oracle_ranks, 8, device="cpu")
    # 2.-4. the three schedules against the oracle
    for name, mesh in (("summa", "2x4"), ("ring_reduce", "2x4"),
                       ("cannon", "2x2")):
        np.testing.assert_allclose(got[name], want, rtol=1e-4, atol=1e-4)
        print(f"{name}_matmul ({mesh} mesh) matches oracle")

    # 5. end-to-end: the SST dataflow's own comm plan drives Cannon
    assert df_sst.name == "MNK-SST"
    kinds = {t.tensor: t.kind for t in plan.comm_plan_for(df_sst).tensors}
    assert kinds == {"A": "ppermute_ring", "B": "ppermute_ring",
                     "C": "shard"}
    print("ALL DIST SELFTESTS PASSED")


if __name__ == "__main__":
    main()
