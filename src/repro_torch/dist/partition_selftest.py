"""Unified-partition selftests, over gloo ranks on the CPU.

    PYTHONPATH=src python -m repro_torch.dist.partition_selftest

The port of the reference's ``dist/partition_selftest.py`` (8 ranks in
place of 8 fake devices): the acceptance battery for the partition
solver as the interpreter executes it.

  * **Degenerate + skewed meshes**: every registry algebra under every
    named STT executes correctly on 1x1, 1x8, 8x1, 2x4 and 2x2 meshes
    with deliberately non-divisible loop bounds.
  * **No silent replication**: every case above shards at least one dim
    of every input side, and batched forms shard their batch dim.
  * **Batch sharding**: batched_gemv / depthwise_conv per-device operand
    bytes are 1/|batch axis| of the ``shard_batch=False`` replicating
    baseline, with parity intact.
  * **Compressed collectives**: block-sparse operands ship as BSR
    payloads + coordinate lists (the solution reports ``compressed``)
    with parity against the masked dense oracle, and their per-device
    stored bytes scale with density vs the ``sparse='dense'`` baseline.
  * **Executed dt staggering**: input-systolic plans run the
    ``k_spatial_stagger`` schedule; the mobile (output) tensor stores
    1/S per device instead of a full replica.
"""
from __future__ import annotations

import numpy as np

from ..core import algebra
from . import cases as cases_mod
from . import spawn
from .cases import NAMED_DATAFLOWS, case

#: deliberately non-divisible bounds: every mesh shape below forces
#: padding on at least one dim
SKEWED_BOUNDS = {
    "gemm": dict(m=6, n=10, k=7),
    "batched_gemv": dict(m=5, k=6, n=9),
    "conv2d": dict(k=8, c=4, y=6, x=6, p=3, q=3),
    "depthwise_conv": dict(k=6, y=5, x=5, p=2, q=2),
    "mttkrp": dict(i=8, j=8, k=4, l=4),
    "ttmc": dict(i=4, j=4, k=4, l=4, m=4),
}
MESH_SHAPES = ((1, 1), (1, 8), (8, 1), (2, 4), (2, 2))
BATCHED = ("batched_gemv", "depthwise_conv")
DENSITIES = (0.25, 0.5, 1.0)
STAGGER_SHAPES = (((2, 4), 4), ((2, 2), 2), ((1, 8), 8))


def _mesh(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def degenerate_cases():
    """Every algebra x named dataflow x mesh shape."""
    return [case(f"deg-{name}-{df}-{_mesh(shape)}", name,
                 SKEWED_BOUNDS[name], df, shape)
            for name in sorted(algebra.PAPER_ALGEBRAS)
            for df in NAMED_DATAFLOWS for shape in MESH_SHAPES]


def batch_cases():
    out = []
    for name in BATCHED:
        bounds = dict(SKEWED_BOUNDS[name])
        bounds["m" if name == "batched_gemv" else "k"] = 8   # divisible b
        for shard in (True, False):
            out.append(case(f"batch-{name}-{'shard' if shard else 'rep'}",
                            name, bounds, "output_stationary", (2, 4),
                            seed=5, shard_batch=shard))
    return out


def compressed_cases():
    out = []
    for shape in ((2, 2), (2, 4)):
        for density in DENSITIES:
            sp = (("random", "A", (16, 16), (4, 4), density, 7),)
            for mode in ("auto", "dense"):
                out.append(case(
                    f"comp-{_mesh(shape)}-{density}-{mode}", "gemm",
                    dict(m=16, n=16, k=16), "output_stationary", shape,
                    sparsity=sp, seed=11, sparse=mode))
    out += [
        case("comp-gemm-B", "gemm", dict(m=16, n=16, k=16),
             "output_stationary", (2, 2), seed=11,
             sparsity=(("random", "B", (16, 16), (4, 4), 0.5, 9),)),
        case("comp-conv2d-B", "conv2d", dict(k=8, c=4, y=6, x=6, p=3, q=3),
             "output_stationary", (2, 2), seed=11,
             sparsity=(("random", "B", (8, 4, 3, 3), (2, 2, 3, 3), 0.5,
                        5),)),
        case("comp-mttkrp-A", "mttkrp", dict(i=8, j=8, k=4, l=4),
             "output_stationary", (2, 2), seed=11,
             sparsity=(("random", "A", (8, 4, 4), (2, 2, 4), 0.5, 5),)),
    ]
    return out


#: the compressed side each extra sparse case must report
COMPRESSED_SIDE = {"comp-gemm-B": "rhs", "comp-conv2d-B": "lhs",
                   "comp-mttkrp-A": "lhs"}


def stagger_cases():
    return [case(f"stagger-{_mesh(shape)}", "gemm", dict(m=16, n=16, k=16),
                 "weight_stationary", shape) for shape, _ in STAGGER_SHAPES]


def batched_sparse_cases():
    return [case("bsparse-batched_gemv", "batched_gemv",
                 dict(m=8, k=8, n=8), "output_stationary", (2, 2), seed=1,
                 sparsity=(("coords", "B", (2, 2),
                            ((0, 0), (0, 1), (2, 0))),))]


def all_cases():
    return (degenerate_cases() + batch_cases() + compressed_cases()
            + stagger_cases() + batched_sparse_cases())


def _int(out) -> np.ndarray:
    return np.asarray(out).round().astype(np.int64)


def want_of(c) -> np.ndarray:
    alg = c.build_algebra()
    return alg.reference(c.build_operands(alg))


def check_exact(c, rec, want=None) -> None:
    """The mesh output equals the reference exactly, on every rank."""
    want = want_of(c) if want is None else want
    np.testing.assert_array_equal(_int(rec["out"]), want, err_msg=(
        f"{c.label} ({rec['strategy']})"))
    assert rec["agree"], f"{c.label}: ranks rebuilt different outputs"


def check_degenerate(c, rec, want=None) -> None:
    check_exact(c, rec, want)
    assert not rec["replicated_inputs"], (
        f"{c.label}: inputs {rec['replicated_inputs']} silently replicated")
    if c.algebra in BATCHED:
        assert rec["batch_axis"] is not None, (
            f"{c.label}: batch replicated (solution {rec['solution']})")


def check_batch(records, name) -> int:
    new = records[f"batch-{name}-shard"]
    old = records[f"batch-{name}-rep"]
    assert old["batch_axis"] is None
    f_b = new["sizes"][new["batch_axis"]]
    for side in ("lhs", "rhs", "out"):
        ratio = new["footprint"][side] / old["footprint"][side]
        assert abs(ratio - 1.0 / f_b) < 1e-9, (name, side, ratio)
    return f_b


def check_compressed(records, shape, density) -> tuple:
    comp = records[f"comp-{_mesh(shape)}-{density}-auto"]
    dense = records[f"comp-{_mesh(shape)}-{density}-dense"]
    assert comp["lhs_compressed"], comp["solution"]
    assert not dense["lhs_compressed"]
    c_b, d_b = comp["footprint"]["lhs"], dense["footprint"]["lhs"]
    # payload ~ density x dense shard + coordinate metadata
    assert c_b <= d_b * density + 64, (density, c_b, d_b)
    return c_b, d_b


def check_stagger(rec, S: int) -> None:
    assert rec["strategy"] == "k_spatial_stagger", rec["strategy"]
    assert rec["out_motion"] == "ppermute_ring"
    assert rec["out_m_axis"] == rec["ring_axes"][0]
    full = rec["m"] * rec["n"] * 4
    # the m dim is chunked 1/S by the rotation schedule
    assert rec["footprint"]["out"] * S <= full, (rec["footprint"], full, S)


def check_batched_sparse(c):
    """Single-device facts of the batched sparse case: all-zero batch
    slices are skipped and the executed MACs shrink.  Returns the form
    and the cost report."""
    import repro_torch
    acc = repro_torch.generate(c.build_algebra(), device="cpu")
    form = acc.kernel.form
    assert form.batch_keep == (0, 1, 4, 5), form.batch_keep
    rep = acc.cost_report()
    assert rep.executed_mac_ratio < 1.0 / rep.work_density, (
        "slice skipping did not reduce executed MACs")
    return form, rep


def check(records) -> None:
    for name in sorted(algebra.PAPER_ALGEBRAS):
        strategies = set()
        cs = [c for c in degenerate_cases() if c.algebra == name]
        want = want_of(cs[0])
        for c in cs:
            check_degenerate(c, records[c.label], want)
            strategies.add(records[c.label]["strategy"])
        print(f"degenerate-mesh {name:15s} {len(cs)} cases "
              f"strategies={sorted(strategies)}")
    for c in batch_cases():
        check_exact(c, records[c.label])
    for name in BATCHED:
        f_b = check_batch(records, name)
        axis = records[f"batch-{name}-shard"]["batch_axis"]
        print(f"batch-shard {name:15s} batch_axis={axis} per-device "
              f"bytes = 1/{f_b} of replicating baseline")
    for c in compressed_cases():
        check_exact(c, records[c.label])
    for shape in ((2, 2), (2, 4)):
        for density in DENSITIES:
            c_b, d_b = check_compressed(records, shape, density)
            strat = records[f"comp-{_mesh(shape)}-{density}-auto"][
                "strategy"]
            print(f"compressed {shape} density={density:.2f} {strat:12s} "
                  f"lhs {c_b:.0f}B/dev vs dense {d_b:.0f}B/dev")
    for label, side in COMPRESSED_SIDE.items():
        rec = records[label]
        assert rec[f"{side}_compressed"], (label, rec["solution"])
        print(f"compressed {label[5:]:10s} side={side} "
              f"{rec['strategy']:17s} OK")
    for c, (shape, S) in zip(stagger_cases(), STAGGER_SHAPES):
        rec = records[c.label]
        check_exact(c, rec)
        check_stagger(rec, S)
        print(f"stagger {shape} S={S}: out stores "
              f"{rec['footprint']['out']:.0f}B/dev vs "
              f"{rec['m'] * rec['n'] * 4}B replicated (<= 1/{S})")
    (c,) = batched_sparse_cases()
    form, rep = check_batched_sparse(c)
    check_exact(c, records[c.label])
    print(f"batched-sparse batched_gemv keeps {form.batch}"
          f"/{form.batch_full} slices, ratio "
          f"{rep.executed_mac_ratio:.2f} < {1.0 / rep.work_density:.2f}")


def main() -> None:
    records = spawn.run_ranks(cases_mod.run_cases, 8, device="cpu",
                              args=(all_cases(),))
    check(records)
    print("ALL PARTITION SELFTESTS PASSED")


if __name__ == "__main__":
    main()
