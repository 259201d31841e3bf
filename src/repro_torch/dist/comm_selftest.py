"""CommPlan-interpreter selftests, over gloo ranks on the CPU.

    PYTHONPATH=src python -m repro_torch.dist.comm_selftest

The port of the reference's ``dist/comm_selftest.py`` (8 ranks in place
of 8 fake devices).  Checks:
  * ``repro_torch.generate(alg, mesh=square_submesh(2))`` is numerically
    correct (vs ``alg.reference`` *and* vs the single-device
    accelerator) for all six registry algebras under the default
    output-stationary dataflow — the mesh execution is driven by the
    generated CommPlan, not a hand-picked schedule function;
  * the classic schedules are recovered as special cases and match the
    hand-written engines kept as oracles: SUMMA = gemm x MMT (2x4 mesh),
    Cannon = gemm x SST (2x2), ring-reduce = gemm x a K-spatial STT;
  * a weight-stationary (hybrid single-ring) dataflow also executes
    correctly end-to-end.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import algebra, linalg, stt
from . import cases as cases_mod
from . import engine, spawn

#: small even bounds: the python loop-nest oracle stays fast and integer
#: operands keep the fp32 paths exact
SMALL_BOUNDS = {
    "gemm": dict(m=16, n=16, k=16),
    "batched_gemv": dict(m=4, k=8, n=8),
    "conv2d": dict(k=8, c=4, y=6, x=6, p=3, q=3),
    "depthwise_conv": dict(k=8, y=6, x=6, p=3, q=3),
    "mttkrp": dict(i=8, j=8, k=4, l=4),
    "ttmc": dict(i=4, j=4, k=4, l=4, m=4),
}

K_SPATIAL_T = cases_mod.K_SPATIAL_T


def algebra_cases():
    """Every registry algebra under output-stationary on a 2x2 mesh."""
    return [cases_mod.case(f"os-{name}", name, SMALL_BOUNDS[name],
                           "output_stationary", (2, 2))
            for name in sorted(algebra.PAPER_ALGEBRAS)]


def single_device(c: cases_mod.Case) -> np.ndarray:
    """The port's one-device output for a case (on the CPU)."""
    import repro_torch
    alg = c.build_algebra()
    acc = repro_torch.generate(alg, c.build_dataflow(alg), device="cpu",
                               dtype=cases_mod.DTYPES[c.dtype],
                               validate=False)
    return acc(c.build_operands(alg)).to(torch.float32).numpy()


def check_algebra(c: cases_mod.Case, rec: dict) -> None:
    """Sharded == single == reference, and nothing replicated."""
    alg = c.build_algebra()
    want = alg.reference(c.build_operands(alg))
    single = single_device(c).round().astype(np.int64)
    multi = rec["out"].round().astype(np.int64)
    np.testing.assert_array_equal(single, want)
    np.testing.assert_array_equal(multi, want)
    assert rec["agree"], f"{c.label}: ranks rebuilt different outputs"
    # no silent replication: the solver must shard every input side, and
    # fold batch grid dims onto a mesh axis
    assert not rec["replicated_inputs"], (
        f"{c.algebra}: inputs {rec['replicated_inputs']} fell back to "
        f"replication (partition {rec['solution']})")
    if c.algebra in ("batched_gemv", "depthwise_conv"):
        assert rec["batch_axis"] is not None, (
            f"{c.algebra}: batch dim replicated ({rec['solution']})")


def check_all_algebras(records) -> None:
    for c in algebra_cases():
        rec = records[c.label]
        check_algebra(c, rec)
        print(f"{c.algebra:15s} strategy={rec['strategy']} "
              f"batch_axis={rec['batch_axis']}: "
              f"sharded == single == reference")


def classic_ranks(device: str = "cpu", backend=None) -> dict:
    """Rank function: gemm x {MMT, SST, K-spatial, STS} through the
    interpreter beside the hand-written oracles, on normal operands."""
    import repro_torch

    dev = torch.device(device)
    meshes = cases_mod.build_meshes([(2, 4), (2, 2)], device=dev,
                                    backend=backend)
    mesh24, sq = meshes[(2, 4)], meshes[(2, 2)]
    g = algebra.gemm(32, 32, 32)
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.standard_normal((32, 32)), dtype=torch.float32,
                        device=dev)
    b = torch.as_tensor(rng.standard_normal((32, 32)), dtype=torch.float32,
                        device=dev)
    operands = {"A": a, "B": b}          # C = A @ B^T (paper GEMM layout)
    out = {}

    def gen(df, mesh):
        return repro_torch.generate(g, df, mesh=mesh, device=dev,
                                    validate=False)

    acc = gen("identity", mesh24)
    out["summa"] = (acc._program().strategy, acc(operands),
                    engine.summa_matmul(a, b.T, mesh24))
    df = stt.apply_stt(g, ("m", "n", "k"), linalg.mat(
        [list(r) for r in K_SPATIAL_T]))
    acc = gen(df, mesh24)
    kinds = {t.tensor: t.kind for t in acc.plan.comm.tensors}
    out["ring_reduce"] = (acc._program().strategy, acc(operands),
                          engine.ring_reduce_matmul(a, b.T, mesh24))
    out["ring_reduce_kinds"] = kinds
    if sq.get_coordinate() is not None:
        acc = gen("output_stationary", sq)
        out["cannon"] = (acc._program().strategy, acc(operands),
                         engine.cannon_matmul(a, b.T, sq))
        # hybrid: weight-stationary (STS) — B resident, A systolic, C on
        # an output ring; no hand-written engine ever existed for it
        out["hybrid_err"] = gen("weight_stationary", sq).validate(seed=5)
    return {k: (tuple(x.cpu().numpy() if torch.is_tensor(x) else x
                      for x in v) if isinstance(v, tuple) else v)
            for k, v in out.items()}


def check_classic_oracles(got) -> None:
    for name, strategy, mesh in (("summa", "summa", "2x4"),
                                 ("cannon", "cannon", "2x2"),
                                 ("ring_reduce", "k_spatial", "2x4")):
        strat, mine, oracle = got[name]
        assert strat.startswith(strategy), (name, strat)
        np.testing.assert_allclose(mine, oracle, rtol=1e-4, atol=1e-4)
        print(f"{name}-as-oracle: generate(gemm, ...) == {name}_matmul "
              f"({mesh}, strategy={strat})")
    assert got["ring_reduce_kinds"]["C"] == "psum", got["ring_reduce_kinds"]
    print(f"hybrid STS executes from its CommPlan "
          f"(max err {got['hybrid_err']:.1e})")


def engine_ranks(device: str = "cpu", backend=None):
    """Rank function: a mesh-bound ``AcceleratorEngine`` on a 2x2 mesh
    serving three algebras (one of them twice); the outputs, the
    engine's stats and its gemm ``describe()`` on rank 0."""
    from ..serve.engine import AcceleratorEngine

    dev = torch.device(device)
    sq = cases_mod.build_meshes([(2, 2)], device=dev, backend=backend)[
        (2, 2)]
    if sq.get_coordinate() is None:
        return None
    eng = AcceleratorEngine(mesh=sq, device=dev)
    outs = {}
    for name in ("gemm", "batched_gemv", "depthwise_conv", "gemm"):
        alg = algebra.get_algebra(name, **SMALL_BOUNDS[name])
        outs[name] = eng.submit(name, alg.random_operands(seed=2),
                                bounds=SMALL_BOUNDS[name]).cpu().numpy()
    return {"outs": outs, "stats": eng.stats(), "handles": len(eng._accs),
            "describe": eng.describe("gemm", bounds=SMALL_BOUNDS["gemm"])}


def outside_rank_error(device: str = "cpu", backend=None) -> list:
    """Rank function: every rank of the world tries to compile a 2x2
    program; the error each rank outside the mesh gets, by rank."""
    import torch.distributed as dist

    from .comm_engine import compile_comm_plan

    dev = torch.device(device)
    sq = cases_mod.build_meshes([(2, 2)], device=dev, backend=backend)[
        (2, 2)]
    msg = None
    if sq.get_coordinate() is None:
        import repro_torch
        acc = repro_torch.generate("gemm", bounds=SMALL_BOUNDS["gemm"],
                                   device=dev, validate=False)
        try:
            compile_comm_plan(acc.plan.comm, acc.kernel.form, sq)
        except ValueError as e:
            msg = str(e)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, msg)
    return every


def battery(case_list, device: str = "cpu", backend=None) -> dict:
    """Rank function: the cases, the classic oracles, the hand-written
    schedules, the mesh-bound engine and the outside-rank error, in one
    world."""
    from .selftest import oracle_ranks

    return {"cases": cases_mod.run_cases(case_list, device, backend,
                                         repeat=2, single=True),
            "classic": classic_ranks(device, backend),
            "oracles": oracle_ranks(device, backend),
            "engine": engine_ranks(device, backend),
            "outside": outside_rank_error(device, backend)}


def main() -> None:
    records = spawn.run_ranks(cases_mod.run_cases, 4, device="cpu",
                              args=(algebra_cases(),))
    check_all_algebras(records)
    check_classic_oracles(spawn.run_ranks(classic_ranks, 8, device="cpu"))
    print("ALL COMM-ENGINE SELFTESTS PASSED")


if __name__ == "__main__":
    main()
