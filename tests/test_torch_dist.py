"""The port's mesh path on the CPU: the CommPlan interpreter over gloo
ranks (``repro_torch.dist``), ``Accelerator.sharded``,
``generate(mesh=...)`` and a mesh-bound ``AcceleratorEngine``.

One world of 8 gloo ranks (``dist.spawn.run_ranks``) runs every case
once, in a module fixture (``comm_selftest.battery``): every registry
algebra x named STT x {1x1, 1x8, 8x1, 2x4, 2x2} at the skewed bounds on
integer operands, the batch-shard, compressed and stagger batteries, the
bf16 gemm, the classic oracles and the engine.  Each test below reads its
case's record.  Integer fp32 operands make every path exact, so outputs
are compared for equality; the bf16 gemm is held within 2e-2 x max|out|
(bf16 operands, fp32 accumulation), the normal-operand oracles within
1e-4 (fp32 sums in another order).
"""
import functools
import operator
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.core import algebra  # noqa: E402
from repro_torch.dist import (comm_engine, comm_selftest,  # noqa: E402
                              partition_selftest, selftest, spawn,
                              sparse_selftest)
from repro_torch.dist.cases import case  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402

BF16 = case("bf16-gemm", "gemm", dict(m=32, n=24, k=40),
            "output_stationary", (2, 2), operands="normal",
            dtype="bfloat16")
DEGENERATE = partition_selftest.degenerate_cases()
CASES = (DEGENERATE + partition_selftest.batch_cases()
         + partition_selftest.compressed_cases()
         + partition_selftest.stagger_cases()
         + partition_selftest.batched_sparse_cases()
         + comm_selftest.algebra_cases() + sparse_selftest.sparse_cases()
         + [BF16])


@pytest.fixture(scope="module")
def world():
    return spawn.run_ranks(comm_selftest.battery, 8, device="cpu",
                           args=(CASES,), timeout=240)


@functools.lru_cache(maxsize=None)
def reference(name: str, bounds: tuple, seed: int) -> np.ndarray:
    alg = algebra.get_algebra(name, **dict(bounds))
    return alg.reference(alg.random_operands(seed=seed))


@pytest.mark.parametrize("c", DEGENERATE, ids=lambda c: c.label)
def test_every_algebra_stt_and_mesh_is_exact(world, c):
    rec = world["cases"][c.label]
    want = reference(c.algebra, c.bounds, c.seed)
    partition_selftest.check_degenerate(c, rec, want)
    # every rank's output equals its one-device accelerator's exactly
    assert rec["equal_single"], "the mesh differs from one device"
    assert rec["repeat_same"], "a second call gave other bits"


@pytest.mark.parametrize("c", comm_selftest.algebra_cases(),
                         ids=lambda c: c.label)
def test_output_stationary_on_2x2_matches_single_and_reference(world, c):
    comm_selftest.check_algebra(c, world["cases"][c.label])


@pytest.mark.parametrize("name", partition_selftest.BATCHED)
def test_batch_shard_stores_one_over_axis(world, name):
    recs = world["cases"]
    for c in partition_selftest.batch_cases():
        if c.algebra == name:
            partition_selftest.check_exact(c, recs[c.label])
    assert partition_selftest.check_batch(recs, name) == 2


@pytest.mark.parametrize("shape", ((2, 2), (2, 4)))
@pytest.mark.parametrize("density", partition_selftest.DENSITIES)
def test_compressed_matches_dense_with_smaller_footprint(world, shape,
                                                         density):
    recs = world["cases"]
    for c in partition_selftest.compressed_cases():
        if c.mesh == shape and f"-{density}-" in c.label:
            partition_selftest.check_exact(c, recs[c.label])
            if c.sparse == "dense":
                np.testing.assert_array_equal(
                    recs[c.label]["out"],
                    recs[c.label.replace("-dense", "-auto")]["out"])
    comp, dense = partition_selftest.check_compressed(recs, shape, density)
    if density < 1.0:
        assert comp < dense


@pytest.mark.parametrize("label,side",
                         sorted(partition_selftest.COMPRESSED_SIDE.items()))
def test_compressed_side_ships_bsr(world, label, side):
    c = next(c for c in partition_selftest.compressed_cases()
             if c.label == label)
    rec = world["cases"][label]
    partition_selftest.check_exact(c, rec)
    assert rec[f"{side}_compressed"], rec["solution"]


@pytest.mark.parametrize("i", range(len(partition_selftest.STAGGER_SHAPES)))
def test_stagger_stores_one_over_s(world, i):
    c = partition_selftest.stagger_cases()[i]
    shape, S = partition_selftest.STAGGER_SHAPES[i]
    rec = world["cases"][c.label]
    partition_selftest.check_exact(c, rec)
    partition_selftest.check_stagger(rec, S)
    assert rec["sizes"][rec["ring_axes"][0]] == S


def test_batched_sparse_skips_slices_on_the_mesh(world):
    (c,) = partition_selftest.batched_sparse_cases()
    partition_selftest.check_batched_sparse(c)
    partition_selftest.check_exact(c, world["cases"][c.label])


@pytest.mark.parametrize("density", sparse_selftest.DENSITIES)
def test_sparse_mesh_parity(world, density):
    kind, comp, dense = sparse_selftest.check_density(world["cases"],
                                                      density)
    assert kind == "ppermute_ring"


def test_bf16_gemm_within_tolerance(world):
    rec = world["cases"][BF16.label]
    alg = BF16.build_algebra()
    ops = BF16.build_operands(alg)
    rounded = {k: torch.as_tensor(v).to(torch.bfloat16).double().numpy()
               for k, v in ops.items()}
    want = alg.reference(rounded)
    tol = 2e-2 * np.abs(want).max()
    assert np.abs(rec["out"] - want).max() <= tol
    acc = repro_torch.generate(alg, "output_stationary", device="cpu",
                               dtype=torch.bfloat16, validate=False)
    one = acc(ops).to(torch.float32).numpy()
    assert np.abs(rec["out"] - one).max() <= tol
    assert rec["agree"] and rec["repeat_same"]


@pytest.mark.parametrize("name", ("summa", "cannon", "ring_reduce"))
def test_interpreter_recovers_classic_oracle(world, name):
    strategy, mine, oracle = world["classic"][name]
    assert strategy.startswith({"summa": "summa", "cannon": "cannon",
                                "ring_reduce": "k_spatial"}[name])
    np.testing.assert_allclose(mine, oracle, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ("summa", "cannon", "ring_reduce"))
def test_hand_written_schedule_matches_numpy(world, name):
    a, b = selftest.operands()
    want = a.astype(np.float64) @ b.astype(np.float64)
    np.testing.assert_allclose(world["oracles"][name], want, rtol=1e-4,
                               atol=1e-4)


def test_classic_checks_and_hybrid(world):
    comm_selftest.check_classic_oracles(world["classic"])
    assert world["classic"]["hybrid_err"] == 0.0
    assert world["classic"]["ring_reduce_kinds"]["C"] == "psum"


def test_every_case_gives_the_same_bits_twice(world):
    recs = world["cases"]
    assert len(recs) == len(CASES)
    assert all(r["repeat_same"] and r["agree"] for r in recs.values())
    assert all(r["equal_single"] for label, r in recs.items()
               if label != BF16.label)
    assert all(r["on_mesh_device"] and set(r["devices"]) == {"cpu"}
               for r in recs.values())


def test_mesh_bound_engine_records_partitions(world):
    got = world["engine"]
    st = got["stats"]
    assert st["requests"] == 4 and got["handles"] == 3
    assert st["algebras"] == ["batched_gemv", "depthwise_conv", "gemm"]
    parts = st["partitions"]
    assert parts["gemm"] == {"strategy": "cannon", "batch_axis": None,
                             "replicated_inputs": ()}
    for name in ("batched_gemv", "depthwise_conv"):
        assert parts[name]["batch_axis"] == "x"
        assert parts[name]["replicated_inputs"] == ()
    for name, out in got["outs"].items():
        b = comm_selftest.SMALL_BOUNDS[name]
        np.testing.assert_array_equal(
            out, reference(name, tuple(sorted(b.items())), 2))
    assert "mesh:   {'x': 2, 'y': 2} strategy=cannon" in got["describe"]
    assert "stored=" in got["describe"] and "comm=" in got["describe"]


def test_ranks_outside_a_submesh_cannot_run_it(world):
    msgs = world["outside"]
    assert msgs[:4] == [None] * 4
    assert all("not a position of this mesh" in m for m in msgs[4:])


# -- errors, in a one-rank gloo world in this process --------------------

@pytest.fixture
def one_rank():
    with spawn.single_rank(device="cpu"):
        yield


def _acc(**kw):
    return repro_torch.generate("gemm", bounds=dict(m=8, n=8, k=8),
                                device="cpu", validate=False, **kw)


def _sparse_acc():
    sp = repro_torch.Sparsity.random((8, 8), (4, 4), 0.5, seed=1)
    return repro_torch.generate("gemm", bounds=dict(m=8, n=8, k=8),
                                sparsity={"A": sp}, device="cpu",
                                validate=False)


@pytest.mark.parametrize("what", ("sparse_mode", "bsr_on_dense",
                                  "bsr_on_batched", "partition_unbound",
                                  "one_d_mesh", "three_d_mesh",
                                  "device_type", "compile_device"))
def test_mesh_errors_match_the_reference(one_rank, what):
    m11 = mesh_mod.make_mesh((1, 1), ("x", "y"), device="cpu")
    if what == "sparse_mode":
        with pytest.raises(ValueError, match="'auto', 'bsr' or 'dense'"):
            _acc().sharded(m11, sparse="csr")
    elif what == "bsr_on_dense":
        with pytest.raises(ValueError, match="no structured"):
            _acc().sharded(m11, sparse="bsr")
    elif what == "bsr_on_batched":
        sp = repro_torch.Sparsity((2, 2), ((0, 0),))
        acc = repro_torch.generate("batched_gemv",
                                   bounds=dict(m=4, k=4, n=4),
                                   sparsity={"B": sp}, device="cpu",
                                   validate=False)
        with pytest.raises(ValueError, match="no structured"):
            acc.sharded(m11, sparse="bsr")
    elif what == "partition_unbound":
        with pytest.raises(ValueError, match="mesh-bound"):
            _acc().partition
    elif what in ("one_d_mesh", "three_d_mesh"):
        shape = (1,) if what == "one_d_mesh" else (1, 1, 1)
        axes = ("x", "y", "z")[:len(shape)]
        m = mesh_mod.make_mesh(shape, axes, device="cpu")
        with pytest.raises(ValueError, match="needs a 2-D mesh"):
            _acc().sharded(m).partition
    elif what == "device_type":
        acc = repro_torch.generate("gemm", bounds=dict(m=8, n=8, k=8),
                                   device="cuda", validate=False)
        with pytest.raises(ValueError, match="mesh's devices are 'cpu'"):
            acc.sharded(m11).partition
    else:
        acc = _acc()
        with pytest.raises(ValueError, match="kernel runs on 'cuda'"):
            comm_engine.compile_comm_plan(acc.plan.comm, acc.kernel.form,
                                          m11, device="cuda")


def test_sharded_takes_a_device_mesh():
    with pytest.raises(TypeError, match="DeviceMesh"):
        _acc().sharded((2, 2))
    with pytest.raises(TypeError, match="DeviceMesh"):
        _acc(mesh=(2, 2))


def test_one_rank_mesh_in_process_is_exact(one_rank):
    m = mesh_mod.make_host_mesh(device="cpu")
    assert tuple(m.mesh_dim_names) == ("data", "model")
    acc = _sparse_acc().sharded(m)
    alg = acc.algebra
    ops = alg.random_operands(seed=4)
    np.testing.assert_array_equal(acc(ops).numpy(), alg.reference(ops))
    assert acc.validate(seed=2) == 0.0
    assert "mesh:   {'data': 1, 'model': 1}" in acc.describe()


def test_make_host_mesh_without_a_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_mod.make_host_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_mod.make_production_mesh()


def test_make_mesh_refuses_what_it_cannot_honour(one_rank):
    with pytest.raises(ValueError, match="NCCL moves CUDA tensors only"):
        mesh_mod.make_host_mesh(device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        mesh_mod.make_host_mesh(2, 2, device="cpu")
    with pytest.raises(RuntimeError, match="already exists"):
        with spawn.single_rank(device="cpu"):
            pass


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="no default process group"):
        mesh_mod.make_host_mesh(device="cpu")


# -- the rank launcher ---------------------------------------------------

def test_run_ranks_returns_rank_zero_result():
    assert spawn.run_ranks(operator.add, 2, device="cpu",
                           args=(2, 3)) == 5


def test_run_ranks_raises_with_the_failing_traceback():
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        spawn.run_ranks(operator.truediv, 2, device="cpu", args=(1, 0))


def test_run_ranks_fails_a_hung_rank():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish"):
        spawn.run_ranks(time.sleep, 1, device="cpu", args=(60,),
                        timeout=4)
    assert time.monotonic() - t0 < 40


def test_run_ranks_refuses_nccl_without_cards():
    with pytest.raises(ValueError):
        spawn.run_ranks(operator.add, 2, device="cpu", backend="nccl",
                        args=(1, 2))
