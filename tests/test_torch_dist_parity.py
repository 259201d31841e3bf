"""The port's mesh path against the reference's, case for case.

One subprocess with 8 fake XLA devices runs the reference's
``compile_comm_plan`` / ``comm_engine.describe`` and its sharded calls
for ``CASES``; one world of 8 gloo ranks runs the port's on the same
operands (standard normal, made here with numpy).  The describe dicts and
the per-device footprints must be equal; the outputs agree within
1e-5 x max|out| — the k reduction may sum in another order (psum over two
axes as two all_reduces, gathers and rings in the port's order), which
moves fp32 results by a few ulps.  ``schedule_from_comm_plan`` and the
spec strings are compared directly.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.core import algebra as ralgebra  # noqa: E402
from repro.core import plan as rplan  # noqa: E402
from repro.core import stt as rstt  # noqa: E402
from repro.dist import schedules as rschedules  # noqa: E402
from repro_torch.core import algebra as talgebra  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core import stt as tstt  # noqa: E402
from repro_torch.dist import cases as cases_mod  # noqa: E402
from repro_torch.dist import schedules as tschedules  # noqa: E402
from repro_torch.dist import spawn  # noqa: E402
from repro_torch.dist.comm_engine import Spec  # noqa: E402
from repro_torch.dist.partition_selftest import SKEWED_BOUNDS  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
case = cases_mod.case
N = "normal"
GEMM16 = dict(m=16, n=16, k=16)


def _cases():
    out = [case(f"os-{name}", name, SKEWED_BOUNDS[name],
                "output_stationary", (2, 2), operands=N)
           for name in sorted(talgebra.PAPER_ALGEBRAS)]
    out += [case(f"{name}-{df}-{r}x{c}", name, SKEWED_BOUNDS[name], df,
                 (r, c), operands=N)
            for name in ("gemm", "batched_gemv")
            for df in cases_mod.NAMED_DATAFLOWS for r, c in ((2, 4), (1, 8))]
    out += [
        case("gemm-kspatial-2x4", "gemm", GEMM16, cases_mod.K_SPATIAL_T,
             (2, 4), operands=N),
        case("batched_gemv-rep-2x4", "batched_gemv",
             dict(m=8, k=6, n=9), "output_stationary", (2, 4),
             operands=N, shard_batch=False),
        case("gemm-A-0.25-2x4", "gemm", GEMM16, "output_stationary",
             (2, 4), operands=N,
             sparsity=(("random", "A", (16, 16), (4, 4), 0.25, 7),)),
        case("gemm-A-0.25-2x4-dense", "gemm", GEMM16, "output_stationary",
             (2, 4), operands=N, sparse="dense",
             sparsity=(("random", "A", (16, 16), (4, 4), 0.25, 7),)),
        case("gemm-B-2x2", "gemm", GEMM16, "output_stationary", (2, 2),
             operands=N,
             sparsity=(("random", "B", (16, 16), (4, 4), 0.5, 9),)),
        case("conv2d-B-2x2", "conv2d", dict(k=8, c=4, y=6, x=6, p=3, q=3),
             "output_stationary", (2, 2), operands=N,
             sparsity=(("random", "B", (8, 4, 3, 3), (2, 2, 3, 3), 0.5,
                        5),)),
        case("mttkrp-A-2x2", "mttkrp", dict(i=8, j=8, k=4, l=4),
             "output_stationary", (2, 2), operands=N,
             sparsity=(("random", "A", (8, 4, 4), (2, 2, 4), 0.5, 5),)),
    ]
    out += [case(f"stagger-{r}x{c}", "gemm", GEMM16, "weight_stationary",
                 (r, c), operands=N) for r, c in ((2, 4), (2, 2), (1, 8))]
    return out


CASES = _cases()

_REFERENCE = r"""
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh
import repro
from repro.core import algebra, linalg, stt
from repro.core.algebra import Sparsity
from repro.dist import comm_engine

spec = json.load(open(sys.argv[1]))
ops = np.load(sys.argv[2])
devs = jax.devices()
assert len(devs) >= 8, devs
info, outs = {}, {}
for c in spec:
    alg = algebra.get_algebra(c["algebra"], **c["bounds"])
    pats = {}
    for e in c["sparsity"]:
        if e[0] == "random":
            _, name, shape, block, density, seed = e
            pats[name] = Sparsity.random(tuple(shape), tuple(block),
                                         density, seed=seed)
        else:
            _, name, block, coords = e
            pats[name] = Sparsity(tuple(block),
                                  tuple(tuple(x) for x in coords))
    if pats:
        alg = alg.with_sparsity(**pats)
    df = c["dataflow"]
    if not isinstance(df, str):
        df = stt.apply_stt(alg, alg.loops[:3], linalg.mat(df))
    acc = repro.generate(alg, df, validate=False)
    r, k = c["mesh"]
    mesh = Mesh(np.asarray(devs[:r * k]).reshape(r, k), ("x", "y"))
    sh = acc.sharded(mesh, sparse=c["sparse"],
                     shard_batch=c["shard_batch"])
    operands = {t.name: ops[c["label"] + "/" + t.name] for t in alg.inputs}
    outs[c["label"]] = np.asarray(sh(operands))
    prog = sh._program()
    form = acc.kernel.form
    info[c["label"]] = {
        "describe": comm_engine.describe(acc.plan.comm, form, mesh),
        "footprint": prog.footprint(form), "strategy": prog.strategy,
        "ring_axes": list(prog.ring_axes), "pads": list(prog.pads)}
json.dump(info, open(sys.argv[3], "w"))
np.savez(sys.argv[4], **outs)
"""


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_parity")
    spec = []
    ops = {}
    for c in CASES:
        alg = c.build_algebra()
        for name, v in c.build_operands(alg).items():
            ops[f"{c.label}/{name}"] = v
        df = c.dataflow if isinstance(c.dataflow, str) else [
            list(r) for r in c.dataflow]
        spec.append({"label": c.label, "algebra": c.algebra,
                     "bounds": dict(c.bounds), "dataflow": df,
                     "mesh": list(c.mesh), "sparsity": c.sparsity,
                     "sparse": c.sparse, "shard_batch": c.shard_batch})
    paths = [tmp / n for n in ("spec.json", "ops.npz", "info.json",
                               "outs.npz")]
    paths[0].write_text(json.dumps(spec))
    np.savez(paths[1], **ops)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "")
                               .split(os.pathsep) if p])
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, *map(str, paths)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        port = spawn.run_ranks(cases_mod.run_cases, 8, device="cpu",
                               args=(CASES,), timeout=240)
        log, _ = ref.communicate(timeout=240)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, log
    info = json.loads(paths[2].read_text())
    outs = dict(np.load(paths[3]))
    return port, info, outs


@pytest.mark.parametrize("c", CASES, ids=lambda c: c.label)
def test_mesh_program_matches_the_reference(both, c):
    port, info, outs = both
    mine, theirs = port[c.label], info[c.label]
    assert mine["describe"] == theirs["describe"]
    assert mine["footprint"] == theirs["footprint"]
    assert mine["strategy"] == theirs["strategy"]
    assert list(mine["ring_axes"]) == theirs["ring_axes"]
    assert list(mine["pads"]) == theirs["pads"]
    want = outs[c.label]
    assert mine["out"].shape == want.shape
    tol = 1e-5 * max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(mine["out"] - want).max()) <= tol
    assert mine["agree"]


_ALGS = sorted(ralgebra.PAPER_ALGEBRAS)
_STTS = ("identity", "output_stationary", "weight_stationary",
         "input_stationary")


@pytest.mark.parametrize("df", _STTS)
@pytest.mark.parametrize("name", _ALGS)
def test_schedule_from_comm_plan_matches(name, df):
    ra = ralgebra.get_algebra(name)
    ta = talgebra.get_algebra(name)
    rdf = rstt.apply_stt(ra, ra.loops[:3], rstt.stt_from_name(df))
    tdf = tstt.apply_stt(ta, ta.loops[:3], tstt.stt_from_name(df))
    want = rschedules.schedule_from_comm_plan(rplan.comm_plan_for(rdf))
    got = tschedules.schedule_from_comm_plan(tplan.comm_plan_for(tdf))
    assert got.name == want.name
    assert got.per_tensor == want.per_tensor
    assert str(got) == str(want)


@pytest.mark.parametrize("entries", [(), ("x",), ("x", None),
                                     (("x", "y"), None), (None, "x", "y"),
                                     (None, None, ("y", "x"))],
                         ids=str)
def test_spec_prints_as_partition_spec(entries):
    assert str(Spec(*entries)) == str(P(*entries))
    assert repr(Spec(*entries)) == repr(P(*entries))
