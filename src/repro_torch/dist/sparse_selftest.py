"""Sparse-accelerator mesh-parity selftest, over gloo ranks on the CPU.

    PYTHONPATH=src python -m repro_torch.dist.sparse_selftest

The port of the reference's ``dist/sparse_selftest.py`` (4 ranks on a
2x2 mesh in place of fake devices): a block-sparse GEMM accelerator bound
to the mesh must match both the masked dense oracle (``alg.reference`` on
masked operands) and the single-device BSR kernel, across several
densities.  The mesh path ships the operand **compressed** (per-rank BSR
payload + block-COO coordinates through the CommPlan collectives — the
solver reports ``compressed``); the masked-dense baseline
(``sparse='dense'``) runs alongside to show both paths are exact and that
the compressed footprint is the smaller one.
"""
from __future__ import annotations

import numpy as np

from . import cases as cases_mod
from . import spawn
from .cases import case

DENSITIES = (0.25, 0.5, 1.0)


def sparse_cases():
    return [case(f"sparse-{density}-{mode}", "gemm",
                 dict(m=16, n=16, k=16), "output_stationary", (2, 2),
                 sparsity=(("random", "A", (16, 16), (4, 4), density, 7),),
                 seed=11, sparse=mode)
            for density in DENSITIES for mode in ("auto", "dense")]


def check_density(records, density: float) -> tuple:
    """Compressed and masked-dense mesh outputs equal the reference and
    the single-device BSR kernel; returns (compressed, dense) lhs
    bytes a device."""
    import repro_torch
    comp = records[f"sparse-{density}-auto"]
    dense = records[f"sparse-{density}-dense"]
    c = next(c for c in sparse_cases() if c.label.endswith(
        f"{density}-auto"))
    alg = c.build_algebra()
    acc = repro_torch.generate(alg, device="cpu")
    assert acc.kernel.sparse_mode == "bsr", acc.kernel.sparse_mode
    assert comp["lhs_compressed"], comp["solution"]
    operands = c.build_operands(alg)
    want = alg.reference(operands)
    single = acc(operands).numpy().round().astype(np.int64)
    np.testing.assert_array_equal(single, want)
    for rec in (comp, dense):
        np.testing.assert_array_equal(rec["out"].round().astype(np.int64),
                                      want)
        assert rec["agree"]
    comp_b = comp["footprint"]["lhs"]
    dense_b = dense["footprint"]["lhs"]
    if density < 1.0:
        assert comp_b < dense_b, (comp_b, dense_b)
    comm = acc.plan.comm.by_tensor()["A"]
    assert abs(comm.density - density) < 1e-9, comm
    return comm.kind, comp_b, dense_b


def main() -> None:
    records = spawn.run_ranks(cases_mod.run_cases, 4, device="cpu",
                              args=(sparse_cases(),))
    for density in DENSITIES:
        kind, comp_b, dense_b = check_density(records, density)
        print(f"sparse-mesh-parity density={density:.2f} comm={kind} "
              f"compressed={comp_b:.0f}B/dev dense={dense_b:.0f}B/dev OK")
    print("ALL SPARSE MESH SELFTESTS PASSED")


if __name__ == "__main__":
    main()
