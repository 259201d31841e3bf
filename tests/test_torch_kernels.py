"""The port's GEMM templates against the reference's Pallas templates.

On the CPU each template wrapper runs its plain PyTorch version; these
tests hold it to the reference kernel in Pallas ``interpret=True`` on the
same numpy operands.  Tolerances: integer-valued fp32 operands are
compared exactly; bf16 results are compared in fp32 to 2e-2 of the
largest output magnitude (the reference's own bf16 tolerance,
``compile/pipeline.py:590``); transcendental epilogues on real-valued
fp32 data to rtol 1e-5 and an atol of 1e-5 of the largest output (XLA
and PyTorch sum in other orders and round ``tanh``/``exp`` apart by an
ulp or so).  The kernel-vs-plain cases on the card are in
``test_torch_gpu.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import epilogue as ref_ep  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import stt_gemm as ref_gemm  # noqa: E402

from repro_torch.kernels import epilogue as ep  # noqa: E402
from repro_torch.kernels import ops, stt_gemm  # noqa: E402

DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (None, jnp.bfloat16, torch.bfloat16)}

#: (lhs shape, rhs shape): rank 2, rank 3, lhs broadcast, rhs broadcast
SHAPES = {
    "rank2": ((32, 64), (64, 48)),
    "rank3": ((2, 16, 64), (2, 64, 32)),
    "bcast_lhs": ((16, 64), (3, 64, 32)),
    "bcast_rhs": ((3, 32, 64), (64, 16)),
}


def _operands(shapes, dtype, seed=0, integer=True):
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        if integer and dtype == "float32":
            x = rng.integers(-4, 5, size=shape).astype(np.float32)
        else:
            x = rng.standard_normal(shape).astype(np.float32)
        out.append(x)
    jx = [jnp.asarray(x).astype(DTYPES[dtype][1]) for x in out]
    tx = [torch.as_tensor(x).to(DTYPES[dtype][2]) for x in out]
    return jx, tx


def _assert_match(got: torch.Tensor, want, dtype, exact=True):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.to(torch.float32).numpy()
    assert got.shape == want.shape
    if dtype == "float32" and exact:
        np.testing.assert_array_equal(got, want)
    elif dtype == "float32":
        # real-valued sums differ in order: scale atol with the output
        atol = 1e-5 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
    else:
        bound = 2e-2 * max(1.0, float(np.abs(want).max()))
        assert float(np.abs(got - want).max()) <= bound


# ---------------------------------------------------------------------------
# output-stationary
# ---------------------------------------------------------------------------

OS_KNOBS = [("scratch", "mnk"), ("scratch", "nmk"), ("inplace", "mnk"),
            ("inplace", "nmk"), ("inplace", "kmn"), ("inplace", "knm")]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("accum,order", OS_KNOBS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_output_stationary_matches_pallas(shape, accum, order, dtype):
    (ja, jb), (ta, tb) = _operands(SHAPES[shape], dtype)
    kw = dict(bm=16, bn=16, bk=16, grid_order=order, accum=accum)
    want = ref_gemm.matmul_output_stationary(ja, jb, interpret=True, **kw)
    got = stt_gemm.matmul_output_stationary(ta, tb, **kw)
    assert got.dtype == ta.dtype
    _assert_match(got, want, dtype)


EPILOGUES = [("scale:0.25",), ("bias",), ("relu",), ("gelu",), ("silu",),
             ("tanh",), ("exp",), ("softmax",), ("bias", "gelu"),
             ("scale:0.125", "softmax")]


@pytest.mark.parametrize("spec", EPILOGUES, ids="+".join)
def test_output_stationary_epilogues_match_pallas(spec):
    (ja, jb), (ta, tb) = _operands(((32, 64), (64, 48)), "float32",
                                   integer=False)
    bias = np.random.default_rng(3).standard_normal(48).astype(np.float32)
    kw = dict(bm=16, bn=48, bk=32, epilogue=spec)
    jbias = jnp.asarray(bias) if "bias" in spec else None
    tbias = torch.as_tensor(bias) if "bias" in spec else None
    want = ref_gemm.matmul_output_stationary(ja, jb, interpret=True,
                                             bias=jbias, **kw)
    got = stt_gemm.matmul_output_stationary(ta, tb, bias=tbias, **kw)
    _assert_match(got, want, "float32", exact=False)


def test_output_stationary_inplace_rounds_each_bk_step():
    # bf16 in-place sums round every k-step of bk: a different bk changes
    # the numbers, exactly as in the reference
    (ja, jb), (ta, tb) = _operands(((16, 256), (256, 16)), "bfloat16",
                                   seed=4)
    for bk in (16, 64, 256):
        kw = dict(bm=16, bn=16, bk=bk, accum="inplace")
        want = np.asarray(ref_gemm.matmul_output_stationary(
            ja, jb, interpret=True, **kw).astype(jnp.float32))
        got = stt_gemm.matmul_output_stationary(ta, tb, **kw)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2,
                                   atol=1e-2)
    fine = stt_gemm.matmul_output_stationary(ta, tb, bm=16, bn=16, bk=16,
                                             accum="inplace")
    coarse = stt_gemm.matmul_output_stationary(ta, tb, bm=16, bn=16,
                                               bk=256, accum="inplace")
    assert not torch.equal(fine, coarse)


# ---------------------------------------------------------------------------
# operand-stationary
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("stationary", ["A", "B"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_operand_stationary_matches_pallas(shape, stationary, dtype):
    (ja, jb), (ta, tb) = _operands(SHAPES[shape], dtype, seed=1)
    kw = dict(bm=16, bn=16, bk=32, stationary=stationary)
    want = ref_gemm.matmul_operand_stationary(ja, jb, interpret=True, **kw)
    got = stt_gemm.matmul_operand_stationary(ta, tb, **kw)
    _assert_match(got, want, dtype)


@pytest.mark.parametrize("spec", [("bias", "relu"), ("softmax",),
                                  ("scale:0.5", "silu")], ids="+".join)
def test_operand_stationary_epilogues_match_pallas(spec):
    (ja, jb), (ta, tb) = _operands(((2, 32, 64), (64, 32)), "float32",
                                   seed=2, integer=False)
    bias = np.linspace(-1, 1, 32).astype(np.float32)
    kw = dict(bm=16, bn=32, bk=16, epilogue=spec)
    jbias = jnp.asarray(bias) if "bias" in spec else None
    tbias = torch.as_tensor(bias) if "bias" in spec else None
    want = ref_gemm.matmul_operand_stationary(ja, jb, interpret=True,
                                              bias=jbias, **kw)
    got = stt_gemm.matmul_operand_stationary(ta, tb, bias=tbias, **kw)
    _assert_match(got, want, "float32", exact=False)


def test_operand_stationary_strip_budget_raises_like_reference():
    (ja, jb), (ta, tb) = _operands(((64, 16), (16, 32)), "float32")
    with pytest.raises(ValueError, match="strip accumulator"):
        ref_gemm.matmul_operand_stationary(ja, jb, bm=16, bn=32, bk=16,
                                           vmem_budget=1024, interpret=True)
    with pytest.raises(ValueError, match="strip accumulator"):
        stt_gemm.matmul_operand_stationary(ta, tb, bm=16, bn=32, bk=16,
                                           strip_budget=1024)
    assert stt_gemm.operand_stationary_strip_bytes(64, 32) == \
        ref_gemm.operand_stationary_strip_bytes(64, 32)


def test_operand_stationary_A_refuses_epilogue_like_reference():
    (ja, jb), (ta, tb) = _operands(((32, 16), (16, 32)), "float32")
    with pytest.raises(ValueError, match="input-stationary"):
        ref_gemm.matmul_operand_stationary(ja, jb, stationary="A",
                                           epilogue=("relu",),
                                           interpret=True)
    with pytest.raises(ValueError, match="input-stationary"):
        stt_gemm.matmul_operand_stationary(ta, tb, stationary="A",
                                           epilogue=("relu",))


# ---------------------------------------------------------------------------
# reduction-tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("order", ["mn", "nm"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_reduction_tree_matches_pallas(shape, order, dtype):
    (ja, jb), (ta, tb) = _operands(SHAPES[shape], dtype, seed=5)
    kw = dict(bm=16, bn=16, grid_order=order)
    want = ref_gemm.matmul_reduction_tree(ja, jb, interpret=True, **kw)
    got = stt_gemm.matmul_reduction_tree(ta, tb, **kw)
    _assert_match(got, want, dtype)


@pytest.mark.parametrize("spec", [("bias", "softmax"), ("scale:0.5", "tanh"),
                                  ("exp",)], ids="+".join)
def test_reduction_tree_epilogues_match_pallas(spec):
    (ja, jb), (ta, tb) = _operands(((32, 64), (64, 16)), "float32", seed=6,
                                   integer=False)
    bias = np.linspace(-2, 2, 16).astype(np.float32)
    kw = dict(bm=16, bn=16, epilogue=spec)
    jbias = jnp.asarray(bias) if "bias" in spec else None
    tbias = torch.as_tensor(bias) if "bias" in spec else None
    want = ref_gemm.matmul_reduction_tree(ja, jb, interpret=True,
                                          bias=jbias, **kw)
    got = stt_gemm.matmul_reduction_tree(ta, tb, bias=tbias, **kw)
    _assert_match(got, want, "float32", exact=False)


# ---------------------------------------------------------------------------
# argument checks: the same errors as the reference
# ---------------------------------------------------------------------------

BAD_CALLS = {
    "k_outer_scratch": ("matmul_output_stationary",
                        dict(grid_order="kmn", accum="scratch"),
                        "single scratch accumulator"),
    "bad_os_order": ("matmul_output_stationary", dict(grid_order="xyz"),
                     "grid_order must be one of"),
    "bad_accum": ("matmul_output_stationary", dict(accum="fast"),
                  "accum must be one of"),
    "bad_rt_order": ("matmul_reduction_tree", dict(grid_order="kmn"),
                     "grid_order must be one of"),
    "softmax_partial_row": ("matmul_output_stationary",
                            dict(epilogue=("softmax",)),
                            "spanning the full"),
    "bias_missing": ("matmul_reduction_tree", dict(epilogue=("bias",)),
                     "needs a bias operand"),
    "indivisible": ("matmul_output_stationary", dict(bk=24),
                    "not divisible by blocks"),
}


@pytest.mark.parametrize("case", list(BAD_CALLS))
def test_argument_checks_match_reference(case):
    fn, kw, msg = BAD_CALLS[case]
    (ja, jb), (ta, tb) = _operands(((32, 64), (64, 32)), "float32")
    kw = dict(dict(bm=16, bn=16), **kw)
    if fn == "matmul_output_stationary":
        kw.setdefault("bk", 16)
    with pytest.raises(ValueError, match=msg):
        getattr(ref_gemm, fn)(ja, jb, interpret=True, **kw)
    with pytest.raises(ValueError, match=msg):
        getattr(stt_gemm, fn)(ta, tb, **kw)


def test_constants_match_reference():
    assert stt_gemm.OS_GRID_ORDERS == ref_gemm.OS_GRID_ORDERS
    assert stt_gemm.ACCUM_MODES == ref_gemm.ACCUM_MODES
    assert stt_gemm.RT_GRID_ORDERS == ref_gemm.RT_GRID_ORDERS
    assert set(stt_gemm.TEMPLATES) == set(ref_gemm.TEMPLATES)
    assert stt_gemm.TEMPLATES["streaming"] is stt_gemm.matmul_reduction_tree
    assert stt_gemm.DEFAULT_STRIP_BUDGET == ref_gemm.DEFAULT_VMEM_BUDGET


# ---------------------------------------------------------------------------
# ops.stt_matmul: padding, fallback, reroute, softmax raise
# ---------------------------------------------------------------------------

def _spy(monkeypatch, module, calls):
    for name in ("matmul_output_stationary", "matmul_operand_stationary",
                 "matmul_reduction_tree"):
        orig = getattr(module, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            calls.append(_name)
            return _orig(*a, **kw)
        monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("template", ["output_stationary",
                                      "operand_stationary",
                                      "reduction_tree", "streaming"])
@pytest.mark.parametrize("stationary", ["A", "B"])
def test_stt_matmul_pads_and_matches_reference(template, stationary):
    # ragged shapes: m, n, k not multiples of the blocks
    (ja, jb), (ta, tb) = _operands(((20, 50), (50, 30)), "float32", seed=8)
    kw = dict(template=template, stationary=stationary, bm=16, bn=16,
              bk=16)
    want = ref_ops.stt_matmul(ja, jb, interpret=True, **kw)
    got = ops.stt_matmul(ta, tb, device="cpu", **kw)
    _assert_match(got, want, "float32")


@pytest.mark.parametrize("stationary", ["A", "B"])
def test_strip_budget_fallback_matches_reference(monkeypatch, stationary):
    ref_calls, calls = [], []
    _spy(monkeypatch, ref_gemm, ref_calls)
    _spy(monkeypatch, stt_gemm, calls)
    (ja, jb), (ta, tb) = _operands(((48, 32), (32, 40)), "float32", seed=9)
    kw = dict(template="operand_stationary", stationary=stationary, bm=16,
              bn=8, bk=16)
    want = ref_ops.stt_matmul(ja, jb, interpret=True, vmem_budget=512, **kw)
    got = ops.stt_matmul(ta, tb, device="cpu", strip_budget=512, **kw)
    _assert_match(got, want, "float32")
    assert ref_calls[0] == calls[0] == "matmul_output_stationary"


def test_input_stationary_epilogue_reroutes_like_reference(monkeypatch):
    ref_calls, calls = [], []
    _spy(monkeypatch, ref_gemm, ref_calls)
    _spy(monkeypatch, stt_gemm, calls)
    (ja, jb), (ta, tb) = _operands(((32, 48), (48, 24)), "float32",
                                   seed=10)
    kw = dict(template="operand_stationary", stationary="A", bm=16, bn=8,
              bk=16, epilogue=("relu",))
    want = ref_ops.stt_matmul(ja, jb, interpret=True, **kw)
    got = ops.stt_matmul(ta, tb, device="cpu", **kw)
    _assert_match(got, want, "float32")
    assert ref_calls[0] == calls[0] == "matmul_output_stationary"


def test_softmax_needs_full_row_like_reference():
    (ja, jb), (ta, tb) = _operands(((16, 32), (32, 40)), "float32")
    kw = dict(bm=16, bn=16, bk=16, epilogue=("softmax",))
    with pytest.raises(ValueError, match="full row"):
        ref_ops.stt_matmul(ja, jb, interpret=True, **kw)
    with pytest.raises(ValueError, match="full row"):
        ops.stt_matmul(ta, tb, device="cpu", **kw)


def test_resolve_accum_and_rt_order_match_reference():
    for accum in ("auto", "scratch", "inplace"):
        assert ops.resolve_accum(accum, None) == \
            ref_ops.resolve_accum(accum, None)
    for order in ("default", "mnk", "nmk", "kmn", "knm", "mn", "nm"):
        assert ops._rt_order(order) == ref_ops._rt_order(order)
    with pytest.raises(ValueError):
        ops.resolve_accum("fast", None)


def test_matmul_from_plan_matches_reference():
    from repro.core import algebra as ref_alg_mod
    from repro.core import plan as ref_plan
    from repro.core import stt as ref_stt
    from repro_torch.core import algebra, plan, stt
    ralg = ref_alg_mod.get_algebra("gemm", m=32, n=32, k=32)
    palg = algebra.get_algebra("gemm", m=32, n=32, k=32)
    T = ref_stt.stt_from_name("input_stationary")
    rkp = ref_plan.kernel_plan_for(ref_stt.apply_stt(ralg, ralg.loops, T))
    pkp = plan.kernel_plan_for(stt.apply_stt(palg, palg.loops, T))
    (ja, jb), (ta, tb) = _operands(((32, 32), (32, 32)), "float32")
    want = ref_ops.matmul_from_plan(rkp, ja, jb, bm=16, bn=16, bk=16,
                                    interpret=True)
    got = ops.matmul_from_plan(pkp, ta, tb, bm=16, bn=16, bk=16,
                               device="cpu")
    _assert_match(got, want, "float32")


# ---------------------------------------------------------------------------
# epilogue grammar
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["scale:1.5", "bias", "relu", "gelu", "silu",
                                "tanh", "exp", "softmax"])
def test_apply_epilogue_matches_reference(op):
    x = np.random.default_rng(11).standard_normal((6, 10)).astype(np.float32)
    bias = np.linspace(-1, 1, 10).astype(np.float32)
    want = np.asarray(ref_ep.apply_epilogue(jnp.asarray(x), (op,),
                                            bias=jnp.asarray(bias)))
    got = ep.apply_epilogue(torch.as_tensor(x), (op,),
                            bias=torch.as_tensor(bias)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        ep.apply_epilogue_np(x, (op,), bias=bias),
        ref_ep.apply_epilogue_np(x, (op,), bias=bias))


@pytest.mark.parametrize("spec", [("nope",), ("scale:x",), ("relu:2",),
                                  ("bias", "bias")])
def test_validate_spec_rejects_like_reference(spec):
    with pytest.raises(ValueError):
        ref_ep.validate_spec(spec)
    with pytest.raises(ValueError):
        ep.validate_spec(spec)


def test_epilogue_encoding():
    codes, params = ep.encode(("scale:0.5", "bias", "gelu", "softmax"))
    assert codes == (0, 1, 3, 7)
    assert params == (0.5, 0.0, 0.0, 0.0)
    with pytest.raises(ValueError, match="more than"):
        ep.encode(("relu",) * (ep.MAX_OPS + 1))


def test_wrappers_count_no_launch_on_cpu():
    stt_gemm.reset_launches()
    (_, _), (ta, tb) = _operands(((16, 16), (16, 16)), "float32")
    stt_gemm.matmul_output_stationary(ta, tb, bm=16, bn=16, bk=16)
    stt_gemm.matmul_operand_stationary(ta, tb, bm=16, bn=16, bk=16)
    stt_gemm.matmul_reduction_tree(ta, tb, bm=16, bn=16)
    assert all(v == 0 for v in stt_gemm.launches.values())
