"""The port's block-sparse front door against the reference.

The same numpy operands go through the reference (the BSR Pallas kernel
in interpret mode, ``repro.compile.lower(..., interpret=True)``) and the
port on the CPU (the BSR wrapper's plain version).  Tolerance: exact —
every case uses integer-valued fp32 operands in [-4, 4] whose sums stay
far below 2^24; the one epilogue case (bias+gelu after a BSR output) is
held to rtol 1e-5 / atol 1e-5 (fp32 transcendental rounding).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
from repro import compile as rcompile  # noqa: E402
from repro.core import algebra as ralgebra  # noqa: E402
from repro.kernels import bsr_gemm as rbsr  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.compile import pipeline  # noqa: E402
from repro_torch.core.algebra import Sparsity, get_algebra  # noqa: E402
from repro_torch.kernels import bsr_gemm, ops  # noqa: E402

DENSITIES = (0.25, 0.5, 1.0)


def _pair(name, bounds, **patterns):
    """(reference algebra, port algebra) with the same patterns."""
    ralg = ralgebra.get_algebra(name, **bounds).with_sparsity(**{
        t: ralgebra.Sparsity(sp.block, sp.coords)
        for t, sp in patterns.items()})
    palg = get_algebra(name, **bounds).with_sparsity(**patterns)
    return ralg, palg


def _f32(ops_):
    return {k: np.asarray(v, np.float32) for k, v in ops_.items()}


def _run_both(ralg, palg, operands):
    rk = rcompile.lower(ralg, interpret=True, tuned=False, validate=False)
    pk = pipeline.lower(palg, device="cpu", validate=False)
    want = np.asarray(rk(_f32(operands)))
    got = pk(operands).numpy()
    return rk, pk, got, want


# ---------------------------------------------------------------------------
# every structured mapping, exact against the reference BSR kernel
# ---------------------------------------------------------------------------

MAPPINGS = {
    "gemm_A": ("gemm", dict(m=16, n=12, k=16), "A",
               ((16, 16), (4, 4))),
    "gemm_B": ("gemm", dict(m=12, n=16, k=16), "B",
               ((16, 16), (4, 8))),
    "conv2d_B": ("conv2d", dict(k=8, c=4, y=6, x=5, p=3, q=3), "B",
                 ((8, 4, 3, 3), (4, 2, 3, 3))),
    "mttkrp_A": ("mttkrp", dict(i=8, j=10, k=4, l=4), "A",
                 ((8, 4, 4), (4, 2, 4))),
}


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("case", sorted(MAPPINGS))
def test_structured_mapping_matches_reference(case, density):
    name, bounds, tensor, (shape, block) = MAPPINGS[case]
    sp = Sparsity.random(shape, block, density, seed=3)
    ralg, palg = _pair(name, bounds, **{tensor: sp})
    operands = ralg.random_sparse_inputs(seed=7)
    rk, pk, got, want = _run_both(ralg, palg, operands)
    assert pk.sparse_mode == rk.sparse_mode == "bsr"
    rs, ps = rk.sparse, pk.sparse
    assert (ps.side, ps.tensor, ps.block, ps.coords, ps.grid) == (
        rs.side, rs.tensor, rs.block, rs.coords, rs.grid)
    assert pk.form.executed_macs == rk.form.executed_macs
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.astype(np.int64),
                                  palg.reference(operands))


def test_density_one_equals_dense_path():
    # the plain BSR path at density 1.0 against the port's dense
    # output-stationary call: the same fp32 sums, bit for bit
    sp = Sparsity.random((32, 32), (8, 8), 1.0)
    palg = get_algebra("gemm", m=32, n=24, k=32).with_sparsity(A=sp)
    dense = get_algebra("gemm", m=32, n=24, k=32)
    rng = np.random.default_rng(0)
    operands = {"A": rng.standard_normal((32, 32)).astype(np.float32),
                "B": rng.standard_normal((24, 32)).astype(np.float32)}
    got = pipeline.lower(palg, device="cpu")(operands)
    want = pipeline.lower(dense, device="cpu")(operands)
    assert torch.equal(got, want)


def test_empty_block_rows_are_zero():
    sp = Sparsity((4, 4), ((0, 0), (1, 2), (3, 1)))
    ralg, palg = _pair("gemm", dict(m=16, n=16, k=16), A=sp)
    operands = ralg.random_sparse_inputs(seed=1)
    _, _, got, want = _run_both(ralg, palg, operands)
    assert (got[8:12] == 0).all()
    np.testing.assert_array_equal(got, want)


def test_empty_pattern_yields_zeros():
    ralg, palg = _pair("gemm", dict(m=16, n=16, k=16),
                       A=Sparsity((4, 4), ()))
    _, pk, got, want = _run_both(ralg, palg,
                                 ralg.random_sparse_inputs(seed=2))
    assert pk.sparse_mode == "bsr"
    assert got.shape == (16, 16) and (got == 0).all()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# masked-dense fallback and the lowest-density tie-break
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["conv2d_partial_window", "batched_gemv",
                                  "depthwise"])
def test_masked_fallback_matches_reference(case):
    if case == "conv2d_partial_window":
        sp = Sparsity.random((8, 4, 3, 3), (4, 2, 1, 1), 0.5, seed=1)
        ralg, palg = _pair("conv2d", dict(k=8, c=4, y=6, x=6, p=3, q=3),
                           B=sp)
    elif case == "batched_gemv":
        sp = Sparsity.random((4, 8), (2, 4), 0.5, seed=1)
        ralg, palg = _pair("batched_gemv", dict(m=4, k=8, n=8), B=sp)
    else:
        sp = Sparsity.random((8, 2, 2), (4, 2, 2), 0.5, seed=0)
        ralg, palg = _pair("depthwise_conv", dict(k=8, y=5, x=5, p=2, q=2),
                           B=sp)
    operands = ralg.random_sparse_inputs(seed=5)
    rk, pk, got, want = _run_both(ralg, palg, operands)
    assert pk.sparse_mode == rk.sparse_mode == "masked"
    assert pk.form.masked_sparse == rk.form.masked_sparse
    np.testing.assert_array_equal(got, want)
    assert pk.validate() == 0.0


@pytest.mark.parametrize("densities,winner", [((0.25, 0.75), "A"),
                                              ((0.75, 0.25), "B"),
                                              ((0.5, 0.5), "A")])
def test_lowest_density_wins_structured_slot(densities, winner):
    spA = Sparsity.random((16, 16), (4, 4), densities[0], seed=1)
    spB = Sparsity.random((16, 16), (4, 4), densities[1], seed=2)
    ralg, palg = _pair("gemm", dict(m=16, n=16, k=16), A=spA, B=spB)
    operands = ralg.random_sparse_inputs(seed=6)
    rk, pk, got, want = _run_both(ralg, palg, operands)
    assert pk.sparse.tensor == rk.sparse.tensor == winner
    assert pk.form.masked_sparse == rk.form.masked_sparse
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,bounds,tensor,shape,block", [
    ("batched_gemv", dict(m=8, n=12, k=16), "B", (8, 16), (2, 16)),
    ("batched_gemv", dict(m=8, n=12, k=16), "A", (8, 16, 12), (2, 16, 12)),
    ("depthwise_conv", dict(k=8, y=5, x=4, p=2, q=2), "B", (8, 2, 2),
     (2, 2, 2)),
])
def test_batch_keep_compaction_matches_reference(name, bounds, tensor,
                                                 shape, block):
    sp = Sparsity.random(shape, block, 0.5, seed=4)
    ralg, palg = _pair(name, bounds, **{tensor: sp})
    operands = ralg.random_sparse_inputs(seed=8)
    rk, pk, got, want = _run_both(ralg, palg, operands)
    assert pk.form.batch_keep == rk.form.batch_keep is not None
    assert pk.form.batch_full == rk.form.batch_full
    assert pk.form.batch == rk.form.batch
    assert pk.form.executed_macs == rk.form.executed_macs
    assert pk.cost_report().executed_macs == rk.cost_report().executed_macs
    np.testing.assert_array_equal(got, want)
    acc = repro_torch.generate(palg, device="cpu")
    assert f"batch_slices={len(rk.form.batch_keep)}" in acc.describe()


# ---------------------------------------------------------------------------
# pattern enforcement and the epilogue after a BSR output
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["bsr", "masked"])
@pytest.mark.parametrize("bad", [np.inf, np.nan])
def test_out_of_pattern_nonfinite_drops_out(case, bad):
    if case == "bsr":
        sp = Sparsity.random((16, 16), (4, 4), 0.5, seed=3)
        ralg, palg = _pair("gemm", dict(m=16, n=16, k=16), A=sp)
        name, shape = "A", (16, 16)
    else:
        sp = Sparsity.random((4, 8), (2, 4), 0.5, seed=3)
        ralg, palg = _pair("batched_gemv", dict(m=4, k=8, n=8), B=sp)
        name, shape = "B", (4, 8)
    dense = dataclasses.replace(ralg, sparsity=())
    operands = {k: np.asarray(v, np.float64)
                for k, v in dense.random_operands(seed=9).items()}
    mask = sp.element_mask(shape)
    operands[name][~mask] = bad
    pk = pipeline.lower(palg, device="cpu", validate=False)
    assert pk.sparse_mode == case
    got = pk(operands).numpy()
    assert np.isfinite(got).all()
    masked = dict(operands)
    masked[name] = np.where(mask, operands[name], 0.0)
    np.testing.assert_array_equal(got.astype(np.int64),
                                  palg.reference(masked))
    rk = rcompile.lower(ralg, interpret=True, tuned=False, validate=False)
    np.testing.assert_array_equal(got, np.asarray(rk(_f32(operands))))


def test_epilogue_after_bsr_output_matches_reference():
    sp = Sparsity.random((16, 16), (4, 4), 0.5, seed=2)
    ralg, palg = _pair("gemm", dict(m=16, n=12, k=16), A=sp)
    spec = ("bias", "gelu")
    rk = rcompile.lower(ralg, interpret=True, tuned=False, epilogue=spec,
                        bias_tensor="bias", validate=False)
    pk = pipeline.lower(palg, device="cpu", epilogue=spec,
                        bias_tensor="bias")
    assert pk.sparse_mode == rk.sparse_mode == "bsr" and pk.validated
    operands = dict(ralg.random_sparse_inputs(seed=3))
    operands["bias"] = np.linspace(-3, 3, 12)
    want = np.asarray(rk(_f32(operands)))
    got = pk(operands).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the wrapper's plain version against the reference kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,block,bn,density", [
    ((16, 16, 12), (4, 4), 8, 0.5),
    ((32, 24, 40), (8, 8), 16, 0.25),
    ((24, 32, 20), (8, 16), 128, 1.0),
    ((16, 16, 16), (4, 4), 4, 0.1),
])
def test_plain_bsr_matches_reference_interpret(shape, block, bn, density,
                                               dtype):
    m, k, n = shape
    sp = Sparsity.random((m, k), block, density, seed=11)
    rng = np.random.default_rng(1)
    a = rng.integers(-4, 5, size=(m, k)).astype(np.float32)
    a *= sp.element_mask((m, k))
    b = rng.integers(-4, 5, size=(k, n)).astype(np.float32)
    want = np.asarray(rbsr.bsr_matmul(
        jnp.asarray(a, dtype), jnp.asarray(b, dtype), coords=sp.coords,
        bm=block[0], bk=block[1], bn=bn, interpret=True).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    bsr_gemm.reset_launches()
    got = bsr_gemm.bsr_matmul(torch.as_tensor(a).to(tdt),
                              torch.as_tensor(b).to(tdt), coords=sp.coords,
                              bm=block[0], bk=block[1], bn=bn)
    assert got.dtype == tdt and bsr_gemm.launches["bsr"] == 0
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_rhs_side_by_transposition():
    sp = Sparsity.random((16, 12), (4, 4), 0.5, seed=5)
    rng = np.random.default_rng(2)
    dense = rng.integers(-4, 5, size=(8, 16)).astype(np.float32)
    sparse = rng.integers(-4, 5, size=(16, 12)).astype(np.float32)
    sparse *= sp.element_mask((16, 12))
    got = ops.bsr_matmul(torch.as_tensor(sparse), torch.as_tensor(dense),
                         coords=sp.coords, block=(4, 4), side="rhs")
    np.testing.assert_array_equal(got.numpy(), dense @ sparse)
    with pytest.raises(ValueError, match="side"):
        ops.bsr_matmul(torch.as_tensor(sparse), torch.as_tensor(dense),
                       coords=sp.coords, block=(4, 4), side="up")


def test_out_of_pattern_data_never_enters_the_plain_version():
    sp = Sparsity((4, 4), ((0, 1), (2, 0)))
    a = torch.full((12, 8), float("nan"))
    a[0:4, 4:8] = 1.0
    a[8:12, 0:4] = 2.0
    b = torch.ones(8, 5)
    got = bsr_gemm.bsr_matmul(a, b, coords=sp.coords, bm=4, bk=4, bn=5)
    want = torch.zeros(12, 5)
    want[0:4], want[8:12] = 4.0, 8.0
    assert torch.equal(got, want)


def test_csr_arrays_describe_the_pattern():
    coords = bsr_gemm.sort_coords([(2, 1), (0, 3), (0, 0), (2, 0)])
    row_ptr, col_idx = bsr_gemm.csr_arrays(coords, 4, "cpu")
    assert row_ptr.dtype == col_idx.dtype == torch.int32
    assert row_ptr.tolist() == [0, 2, 2, 4, 4]
    assert col_idx.tolist() == [0, 3, 0, 1]
    # the rhs side hands the kernel the transposed pattern
    rp, ci = ops.bsr_csr(coords, (4, 8), (12, 32), "rhs", "cpu")
    assert rp.tolist() == [0, 2, 3, 3, 4] and ci.tolist() == [0, 2, 2, 0]


def test_gather_scatter_roundtrip_matches_reference():
    sp = Sparsity.random((16, 16), (4, 4), 0.5, seed=8)
    a = np.random.default_rng(0).standard_normal((16, 16)).astype(
        np.float32) * sp.element_mask((16, 16))
    data = bsr_gemm.gather_blocks(torch.as_tensor(a), sp.coords, 4, 4)
    rdata = np.asarray(rbsr.gather_blocks(jnp.asarray(a), sp.coords, 4, 4))
    np.testing.assert_array_equal(data.numpy(), rdata)
    back = bsr_gemm.scatter_blocks(data, sp.coords, 16, 16)
    np.testing.assert_array_equal(back.numpy(), a)
    assert bsr_gemm.transpose_coords(sp.coords) == \
        rbsr.transpose_coords(sp.coords)


# ---------------------------------------------------------------------------
# the front door
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("density", DENSITIES)
def test_generate_sparse_front_door(density):
    sp = Sparsity.random((16, 16), (4, 4), density, seed=2)
    racc = repro.generate("gemm", bounds=dict(m=16, n=16, k=16),
                          sparsity={"A": ralgebra.Sparsity(sp.block,
                                                           sp.coords)},
                          interpret=True, tune=False)
    pacc = repro_torch.generate("gemm", bounds=dict(m=16, n=16, k=16),
                                sparsity={"A": sp}, device="cpu")
    assert pacc.kernel.sparse_mode == "bsr" and pacc.kernel.validated
    assert pacc.validate() == 0.0
    rep = pacc.cost_report()
    assert rep.work_density == pytest.approx(density)
    assert rep.cycles == racc.cost_report().cycles
    text = pacc.describe()
    assert "sparse: mode=bsr" in text
    want = racc.describe().splitlines()
    assert [ln for ln in text.splitlines() if "sparse:" in ln] == \
        [ln for ln in want if "sparse:" in ln]
    ops_ = racc.algebra.random_sparse_inputs(seed=4)
    np.testing.assert_array_equal(pacc(ops_).numpy(),
                                  np.asarray(racc(_f32(ops_))))


def test_generate_sparse_search_matches_reference():
    sp = Sparsity.random((16, 16), (4, 4), 0.5, seed=2)
    ralg, palg = _pair("gemm", dict(m=16, n=16, k=16), A=sp)
    racc = repro.generate(ralg, search=2, interpret=True)
    pacc = repro_torch.generate(palg, search=2, device="cpu")
    assert pacc.kernel.validated
    assert [df.signature for _, df in pacc.candidates] == \
        [df.signature for _, df in racc.candidates]


def test_sparse_and_dense_cache_separately():
    pipeline.cache_clear()
    sp = Sparsity.random((16, 16), (4, 4), 0.5)
    k1 = pipeline.lower(get_algebra("gemm", m=16, n=16, k=16), device="cpu")
    k2 = pipeline.lower(get_algebra("gemm", m=16, n=16, k=16)
                        .with_sparsity(A=sp), device="cpu")
    assert k1 is not k2 and k2.sparse_mode == "bsr"
    assert pipeline.cache_info()["misses"] == 2
    pipeline.cache_clear()


def test_convert_carries_sparse_accelerator():
    sp = Sparsity.random((16, 16), (4, 4), 0.25, seed=6)
    ralg, _ = _pair("gemm", dict(m=16, n=16, k=16), B=sp)
    racc = repro.generate(ralg, "weight_stationary", interpret=True)
    pacc = convert.from_reference(racc, device="cpu", validate=True)
    assert pacc.kernel.sparse_mode == racc.kernel.sparse_mode == "bsr"
    assert pacc.kernel.sparse.coords == racc.kernel.sparse.coords
    assert pacc.kernel.blocks == racc.kernel.blocks
    ops_ = racc.algebra.random_sparse_inputs(seed=2)
    np.testing.assert_array_equal(
        pacc(convert.operands_to(ops_, device="cpu")).numpy(),
        np.asarray(racc(_f32(ops_))))
