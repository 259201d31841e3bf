"""The port's copies of the jax-free core make the reference's decisions.

For every registry algebra x named STT x two bound sets, the port's
``repro_torch.core`` must agree with ``repro.core`` on the dataflow, the
kernel plan, the blocks, the stationary operand, the cost model's cycles
and the design-space ranking; its lowering must prepare the same
matrices from the same numpy operands.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.compile import lowering as ref_lowering  # noqa: E402
from repro.core import algebra as ref_algebra  # noqa: E402
from repro.core import costmodel as ref_costmodel  # noqa: E402
from repro.core import dse as ref_dse  # noqa: E402
from repro.core import plan as ref_plan  # noqa: E402
from repro.core import stt as ref_stt  # noqa: E402
from repro.core import tiling as ref_tiling  # noqa: E402
from repro.kernels import ref as ref_oracles  # noqa: E402

from repro_torch.compile import lowering  # noqa: E402
from repro_torch.core import (algebra, costmodel, dse, hopper,  # noqa: E402
                              plan, stt, tiling)
from repro_torch.kernels import ref as oracles  # noqa: E402

ALGEBRAS = sorted(ref_algebra.PAPER_ALGEBRAS)
STTS = ("identity", "output_stationary", "weight_stationary",
        "input_stationary")
#: a second, odd-sized bound set per algebra (the first is the default)
ODD_BOUNDS = {
    "gemm": dict(m=40, n=24, k=72),
    "batched_gemv": dict(m=6, n=40, k=20),
    "conv2d": dict(k=12, c=5, y=9, x=7, p=3, q=2),
    "depthwise_conv": dict(k=10, y=7, x=9, p=2, q=3),
    "mttkrp": dict(i=28, j=20, k=6, l=10),
    "ttmc": dict(i=12, j=10, k=6, l=8, m=5),
}


def _pair(name, bounds):
    return (ref_algebra.get_algebra(name, **bounds),
            algebra.get_algebra(name, **bounds))


def _stationary(resident, form):
    return "A" if resident in form.lhs_tensors else "B"


@pytest.mark.parametrize("name", ALGEBRAS)
@pytest.mark.parametrize("kind", STTS)
def test_core_decisions_match_reference(name, kind):
    for bounds in ({}, ODD_BOUNDS[name]):
        ralg, palg = _pair(name, bounds)
        rdf = ref_stt.apply_stt(ralg, ralg.loops[:3],
                                ref_stt.stt_from_name(kind))
        pdf = stt.apply_stt(palg, palg.loops[:3], stt.stt_from_name(kind))
        assert (pdf.selected, pdf.T, pdf.signature, pdf.name) == (
            rdf.selected, rdf.T, rdf.signature, rdf.name)
        rkp, pkp = ref_plan.kernel_plan_for(rdf), plan.kernel_plan_for(pdf)
        assert (pkp.template, pkp.resident_tensor, pkp.streamed) == (
            rkp.template, rkp.resident_tensor, rkp.streamed)
        rform, pform = ref_lowering.lower_form(ralg), lowering.lower_form(palg)
        assert (pform.m, pform.n, pform.k, pform.batch) == (
            rform.m, rform.n, rform.k, rform.batch)
        assert pform.executed_macs == rform.executed_macs == \
            palg.total_macs()
        assert tiling.form_blocks(palg, pdf, pform) == \
            ref_tiling.form_blocks(ralg, rdf, rform)
        assert _stationary(pkp.resident_tensor, pform) == \
            _stationary(rkp.resident_tensor, rform)
        rrep = ref_costmodel.PaperCycleModel().evaluate(ralg, rdf)
        prep = costmodel.PaperCycleModel().evaluate(palg, pdf)
        assert (prep.cycles, prep.executed_macs, prep.power_mw,
                prep.area_units) == (rrep.cycles, rrep.executed_macs,
                                     rrep.power_mw, rrep.area_units)
        rcomm = ref_plan.plan_for(rdf).comm
        pcomm = plan.plan_for(pdf).comm
        assert [(t.tensor, t.kind, t.mesh_axes) for t in pcomm.tensors] == \
            [(t.tensor, t.kind, t.mesh_axes) for t in rcomm.tensors]
        rsol = ref_plan.solve_partition(rcomm, rform, shape=(2, 2))
        psol = plan.solve_partition(pcomm, pform, shape=(2, 2))
        assert psol.describe() == rsol.describe()


def _selections(alg):
    # the full sweep is minutes for the 5- and 6-loop algebras; their
    # ranking is checked over the first loop selections
    sels = dse.loop_selections(alg)
    return None if len(alg.loops) <= 3 else sels[:2]


def _ranking(mod, alg, sels):
    return [(r.cycles, r.area_units, r.power_mw, df.selected, df.T)
            for r, df in mod.search(alg, top_k=3, selections=sels)]


@pytest.mark.parametrize("name", ALGEBRAS)
def test_dse_search_order_matches_reference(name):
    for bounds in ({}, ODD_BOUNDS[name]):
        ralg, palg = _pair(name, bounds)
        sels = _selections(palg)
        assert _ranking(dse, palg, sels) == _ranking(ref_dse, ralg, sels)


def test_search_graph_waits_for_graph_slice():
    # the graph slice has arrived: the port's search_graph plans a graph
    # to the reference's decisions
    from repro.graph import AlgebraGraph as RGraph, GraphNode as RNode
    from repro_torch.graph import AlgebraGraph, GraphNode

    def chain(G, N, alg):
        return G(nodes=(
            N(name="g1", inputs=("x", "W1"), output="h_raw",
              algebra=alg("gemm", m=16, n=24, k=8)),
            N(name="act", inputs=("h_raw",), output="h", op="relu"),
            N(name="g2", inputs=("h", "W2"), output="y",
              algebra=alg("gemm", m=16, n=8, k=24))),
            inputs=("x", "W1", "W2"), output="y")

    rplan = ref_dse.search_graph(chain(RGraph, RNode,
                                       ref_algebra.get_algebra), search=2)
    pplan = dse.search_graph(chain(AlgebraGraph, GraphNode,
                                   algebra.get_algebra), search=2)
    assert pplan.describe() == rplan.describe()


@pytest.mark.parametrize("name", ALGEBRAS)
def test_lowering_prepares_same_matrices(name):
    ralg, palg = _pair(name, ODD_BOUNDS[name])
    ops = ralg.random_operands(seed=7)
    rform, pform = ref_lowering.lower_form(ralg), lowering.lower_form(palg)
    rl, rr = rform.prepare({k: v.astype(np.float32) for k, v in ops.items()})
    pl, pr = pform.prepare({k: torch.as_tensor(v, dtype=torch.float32)
                            for k, v in ops.items()})
    np.testing.assert_array_equal(pl.numpy(), np.asarray(rl))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(rr))
    out = np.arange(int(np.prod(np.asarray(rl).shape[:-1]))
                    * np.asarray(rr).shape[-1], dtype=np.float32)
    shape = np.asarray(rl).shape[:-1] + (np.asarray(rr).shape[-1],)
    out = out.reshape(shape)
    np.testing.assert_array_equal(
        pform.finish(torch.as_tensor(out)).numpy(),
        np.asarray(rform.finish(out)))


def test_lowering_batch_compaction_matches_reference():
    # sparse batched form: the kept slices and their round trip
    bounds = dict(m=8, n=8, k=8)
    ralg, palg = _pair("batched_gemv", bounds)
    rsp = ref_algebra.Sparsity((2, 8), ((0, 0), (2, 0)))
    psp = algebra.Sparsity((2, 8), ((0, 0), (2, 0)))
    ralg, palg = ralg.with_sparsity(B=rsp), palg.with_sparsity(B=psp)
    rform, pform = ref_lowering.lower_form(ralg), lowering.lower_form(palg)
    assert pform.batch_keep == rform.batch_keep == (0, 1, 4, 5)
    assert pform.batch_full == rform.batch_full
    ops = ralg.random_operands(seed=1)
    rl, rr = rform.prepare({k: v.astype(np.float32) for k, v in ops.items()})
    pl, pr = pform.prepare({k: torch.as_tensor(v, dtype=torch.float32)
                            for k, v in ops.items()})
    np.testing.assert_array_equal(pl.numpy(), np.asarray(rl))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(rr))
    o = np.ones((4, 1, 8), np.float32)
    np.testing.assert_array_equal(pform.finish(torch.as_tensor(o)).numpy(),
                                  np.asarray(rform.finish(o)))


def test_sparse_mapping_matches_reference():
    bounds = dict(m=16, n=16, k=16)
    ralg, palg = _pair("gemm", bounds)
    ra = ref_algebra.Sparsity.random((16, 16), (4, 4), 0.5, seed=3)
    rb = ref_algebra.Sparsity.random((16, 16), (4, 4), 0.25, seed=4)
    pa = algebra.Sparsity(ra.block, ra.coords)
    pb = algebra.Sparsity(rb.block, rb.coords)
    rform = ref_lowering.lower_form(ralg.with_sparsity(A=ra, B=rb))
    pform = lowering.lower_form(palg.with_sparsity(A=pa, B=pb))
    assert (pform.sparse.side, pform.sparse.tensor, pform.sparse.coords,
            pform.masked_sparse) == (rform.sparse.side, rform.sparse.tensor,
                                     rform.sparse.coords,
                                     rform.masked_sparse)


def test_array_config_strip_budget_is_reference_budget():
    assert tiling.ArrayConfig().strip_budget_bytes == \
        ref_tiling.ArrayConfig().vmem_budget_bytes == 16 * 1024 * 1024
    assert not hasattr(tiling.ArrayConfig(), "vmem_budget_bytes")


def test_hopper_spec_and_roofline():
    h = hopper.H100
    assert (h.sms, h.l2_bytes, h.hbm_bw) == (132, 50e6, 3.35e12)
    assert h.peak_flops("float32") == 67e12
    assert h.peak_flops("bfloat16") == 989e12
    # 4096^3 fp32 gemm: 137 GFLOP on CUDA cores -> operations bound
    r = hopper.gemm_roofline("gemm", 1, 4096, 4096, 4096,
                             a_batched=False, b_batched=False)
    assert r.flops == 2 * 4096 ** 3
    assert r.bytes == 3 * 4096 * 4096 * 4
    assert r.bound_by == "operations"
    assert r.bound_s == pytest.approx(2 * 4096 ** 3 / 67e12)
    # batch-64 matvec: bytes bound, the broadcast lhs counted per slice
    g = hopper.gemm_roofline("gemv", 64, 1, 4096, 4096)
    assert g.bound_by == "bytes"
    assert g.bytes == (64 * 4096 + 64 * 4096 * 4096 + 64 * 4096) * 4


@pytest.mark.parametrize("name", ["batched_gemv", "depthwise_conv"])
def test_blockdiag_oracles_match_reference(name):
    rng = np.random.default_rng(5)
    if name == "batched_gemv":
        a = rng.integers(-4, 5, size=(5, 7, 6)).astype(np.float32)
        b = rng.integers(-4, 5, size=(5, 7)).astype(np.float32)
        want = ref_oracles.batched_gemv_blockdiag_ref(a, b)
        got = oracles.batched_gemv_blockdiag_ref(torch.as_tensor(a),
                                                 torch.as_tensor(b))
    else:
        a = rng.integers(-4, 5, size=(4, 7, 8)).astype(np.float32)
        b = rng.integers(-4, 5, size=(4, 3, 2)).astype(np.float32)
        want = ref_oracles.depthwise_blockdiag_ref(a, b, y=5, x=7)
        got = oracles.depthwise_blockdiag_ref(torch.as_tensor(a),
                                              torch.as_tensor(b), y=5, x=7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rows = rng.integers(-4, 5, size=(3, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        oracles.block_diag_rows(torch.as_tensor(rows)).numpy(),
        np.asarray(ref_oracles.block_diag_rows(rows)))


def test_simulate_and_reference_copies_agree():
    alg = algebra.get_algebra("gemm", m=4, n=3, k=5)
    out, cycles, extent = stt.simulate(alg, alg.loops[:3],
                                       stt.stt_from_name("output_stationary"))
    ralg = ref_algebra.get_algebra("gemm", m=4, n=3, k=5)
    rout, rcycles, rextent = ref_stt.simulate(
        ralg, ralg.loops[:3], ref_stt.stt_from_name("output_stationary"))
    np.testing.assert_array_equal(out, rout)
    assert (cycles, extent) == (rcycles, rextent)
