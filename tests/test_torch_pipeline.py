"""The port's slice as a whole against the reference front door.

``repro_torch.generate(name, stt, device="cpu")`` must give exactly what
``repro.generate(name, stt, backend="xla")`` gives on the same
integer-valued numpy operands, for every registry algebra and named STT;
``convert`` must carry a reference accelerator's plan across unchanged;
and the compile cache, validation, epilogues, search and the serving
engine must behave as the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402
from repro.compile import pipeline as ref_pipeline  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.compile import pipeline  # noqa: E402
from repro_torch.core.algebra import Sparsity, get_algebra  # noqa: E402
from repro_torch.serve import AcceleratorEngine  # noqa: E402

STTS = ("identity", "output_stationary", "weight_stationary",
        "input_stationary")
BOUNDS = {
    "gemm": dict(m=16, n=24, k=20),
    "batched_gemv": dict(m=5, n=24, k=40),
    "conv2d": dict(k=8, c=3, y=5, x=4, p=3, q=3),
    "depthwise_conv": dict(k=9, y=6, x=5, p=3, q=2),
    "mttkrp": dict(i=20, j=18, k=5, l=4),
    "ttmc": dict(i=10, j=4, k=6, l=5, m=3),
}


def _ref_out(acc, ops):
    return np.asarray(acc({k: v.astype(np.float32) for k, v in ops.items()}))


@pytest.mark.parametrize("name", sorted(BOUNDS))
@pytest.mark.parametrize("kind", STTS)
def test_generate_matches_reference(name, kind):
    racc = repro.generate(name, kind, bounds=BOUNDS[name], backend="xla",
                          validate=False)
    pacc = repro_torch.generate(name, kind, bounds=BOUNDS[name],
                                device="cpu")
    assert pacc.kernel.validated          # auto-validated at lower time
    assert (pacc.template, pacc.kernel.blocks, pacc.kernel.stationary) == (
        racc.template, racc.kernel.blocks, racc.kernel.stationary)
    assert pacc.dataflow.name == racc.dataflow.name
    assert pacc.cost_report().cycles == racc.cost_report().cycles
    ops = racc.algebra.random_operands(seed=11)
    got = pacc(ops)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), _ref_out(racc, ops))
    assert pacc.validate(seed=2) == 0.0


@pytest.mark.parametrize("name", sorted(BOUNDS))
def test_convert_round_trip_keeps_plan(name):
    racc = repro.generate(name, "weight_stationary", bounds=BOUNDS[name],
                          backend="xla", validate=False)
    pacc = convert.from_reference(racc, device="cpu")
    rk, pk = racc.kernel, pacc.kernel
    assert (pk.blocks, pk.stationary, pk.grid_order, pk.accum,
            pk.epilogue, pk.template) == (
        rk.blocks, rk.stationary, rk.grid_order, rk.accum, rk.epilogue,
        rk.template)
    assert pk.algebra.bounds == rk.algebra.bounds
    assert pk.dataflow.signature == rk.dataflow.signature
    ops = racc.algebra.random_operands(seed=5)
    np.testing.assert_array_equal(
        pacc(convert.operands_to(ops, device="cpu")).numpy(),
        _ref_out(racc, ops))


@pytest.mark.parametrize("knobs", [
    dict(blocks=(8, 8, 8), grid_order="nmk", accum="scratch"),
    dict(blocks=(8, 16, 8), grid_order="kmn", accum="inplace"),
    dict(blocks=(16, 8, 16), grid_order="knm", accum="inplace"),
])
def test_explicit_knobs_carry_across(knobs):
    ralg = repro.core.get_algebra("gemm", m=32, n=24, k=48)
    rdf = repro.core.apply_stt(ralg, ralg.loops,
                               repro.core.stt_from_name("identity"))
    rk = ref_pipeline.lower(ralg, rdf, backend="pallas", interpret=True,
                            validate=False, tuned=False, **knobs)
    pk = convert.from_reference(rk, device="cpu", validate=True)
    assert (pk.blocks, pk.grid_order, pk.accum) == (
        knobs["blocks"], knobs["grid_order"], knobs["accum"])
    assert pk.source == "explicit"
    ops = ralg.random_operands(seed=3)
    np.testing.assert_array_equal(pk(ops).numpy(), _ref_out(rk, ops))


@pytest.mark.parametrize("spec,bias", [(("bias", "gelu"), "bias"),
                                       (("scale:0.05", "softmax"), None),
                                       (("relu",), None)])
@pytest.mark.parametrize("kind", ["output_stationary", "weight_stationary"])
def test_epilogue_lowering_matches_reference(spec, bias, kind):
    ralg = repro.core.get_algebra("gemm", m=32, n=24, k=40)
    rdf = repro.core.apply_stt(ralg, ralg.loops,
                               repro.core.stt_from_name(kind))
    rk = ref_pipeline.lower(ralg, rdf, backend="xla", epilogue=spec,
                            bias_tensor=bias, validate=False, tuned=False)
    pk = convert.from_reference(rk, device="cpu")
    assert pk.blocks == rk.blocks       # softmax widened bn to n in both
    assert pk.validate() <= 1e-3
    ops = dict(ralg.random_operands(seed=4))
    if bias:
        ops["bias"] = np.linspace(-3, 3, 24)
    want = np.asarray(rk({k: np.asarray(v, np.float32)
                          for k, v in ops.items()}))
    np.testing.assert_allclose(pk(ops).numpy(), want, rtol=1e-5, atol=1e-5)


def test_rowwise_epilogue_illegal_on_batched_form_like_reference():
    ralg = repro.core.get_algebra("batched_gemv", m=4, n=8, k=8)
    palg = get_algebra("batched_gemv", m=4, n=8, k=8)
    with pytest.raises(ValueError, match="does not end with it"):
        ref_pipeline.lower(ralg, backend="xla", epilogue=("softmax",),
                           tuned=False)
    with pytest.raises(ValueError, match="does not end with it"):
        pipeline.lower(palg, device="cpu", epilogue=("softmax",))


def test_compile_cache_hits_and_eviction():
    pipeline.cache_clear()
    alg = get_algebra("gemm", m=16, n=16, k=16)
    k1 = pipeline.lower(alg, device="cpu")
    k2 = pipeline.lower(alg, device="cpu")
    assert k1 is k2
    info = pipeline.cache_info()
    assert (info["hits"], info["misses"], info["size"]) == (1, 1, 1)
    # dtype and device are part of the key
    k3 = pipeline.lower(alg, device="cpu", dtype=torch.bfloat16)
    assert k3 is not k1 and k3.dtype == torch.bfloat16
    pipeline.cache_resize(2)
    for n in (24, 32):
        pipeline.lower(get_algebra("gemm", m=16, n=n, k=16), device="cpu")
    info = pipeline.cache_info()
    assert info["size"] == 2 and info["evictions"] == 2
    assert pipeline.lower(alg, device="cpu") is not k1     # evicted
    with pytest.raises(ValueError):
        pipeline.cache_resize(0)
    pipeline.cache_resize(pipeline.DEFAULT_CACHE_CAPACITY)
    pipeline.cache_clear()


def test_cached_unvalidated_kernel_validates_on_request():
    pipeline.cache_clear()
    alg = get_algebra("conv2d", k=4, c=2, y=3, x=3, p=2, q=2)
    k = pipeline.lower(alg, device="cpu", validate=False)
    assert not k.validated
    assert pipeline.lower(alg, device="cpu") is k and k.validated
    pipeline.cache_clear()


def test_bf16_generate_within_tolerance_of_reference():
    b = BOUNDS["gemm"]
    import jax.numpy as jnp
    racc = repro.generate("gemm", "output_stationary", bounds=b,
                          backend="xla", dtype=jnp.bfloat16, validate=False)
    pacc = repro_torch.generate("gemm", "output_stationary", bounds=b,
                                dtype=torch.bfloat16, device="cpu",
                                validate=False)
    rng = np.random.default_rng(0)
    ops = {"A": rng.standard_normal((16, 20)).astype(np.float32),
           "B": rng.standard_normal((24, 20)).astype(np.float32)}
    want = np.asarray(racc(ops).astype(jnp.float32))
    got = pacc(ops).float().numpy()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_search_picks_reference_winner():
    b = dict(m=8, n=8, k=8)
    racc = repro.generate("gemm", search=3, bounds=b, backend="xla")
    pacc = repro_torch.generate("gemm", search=3, bounds=b, device="cpu")
    assert [df.signature for _, df in pacc.candidates] == \
        [df.signature for _, df in racc.candidates]
    assert pacc.dataflow.T == racc.dataflow.T
    with pytest.raises(ValueError, match="either dataflow"):
        repro_torch.generate("gemm", "identity", search=2, device="cpu")


def test_masked_sparse_runs_dense_like_reference():
    b = dict(m=8, n=12, k=16)
    sp = repro.Sparsity((2, 16), ((0, 0), (2, 0)))
    racc = repro.generate("batched_gemv", "output_stationary", bounds=b,
                          sparsity={"B": sp}, backend="xla")
    pacc = repro_torch.generate(
        "batched_gemv", "output_stationary", bounds=b, device="cpu",
        sparsity={"B": Sparsity(sp.block, sp.coords)})
    assert pacc.kernel.sparse_mode == racc.kernel.sparse_mode == "masked"
    ops = dict(racc.algebra.random_operands(seed=2))
    # out-of-pattern inf must drop out, not turn the sums into nan
    ops["B"] = np.where(sp.element_mask((8, 16)), ops["B"], np.inf)
    got = pacc(ops).numpy()
    want = np.asarray(racc({k: v.astype(np.float32)
                            for k, v in ops.items()}))
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all()


def test_structured_sparse_waits_for_sparse_slice():
    # the sparse slice has arrived: a structured operand lowers to the
    # BSR kernel and matches the reference's BSR path exactly
    sp = Sparsity((4, 4), ((0, 0), (1, 1)))
    acc = repro_torch.generate("gemm", bounds=dict(m=8, n=8, k=8),
                               sparsity={"A": sp}, device="cpu")
    assert acc.kernel.sparse_mode == "bsr" and acc.kernel.validated
    racc = repro.generate("gemm", bounds=dict(m=8, n=8, k=8),
                          sparsity={"A": repro.Sparsity(sp.block,
                                                        sp.coords)},
                          interpret=True)
    ops = racc.algebra.random_sparse_inputs(seed=1)
    np.testing.assert_array_equal(acc(ops).numpy(), _ref_out(racc, ops))


def _chain_graph():
    from repro_torch.graph import AlgebraGraph, GraphNode
    g = lambda: get_algebra("gemm", m=8, n=8, k=8)  # noqa: E731
    return AlgebraGraph(
        nodes=(GraphNode(name="g1", inputs=("x", "W1"), output="h_raw",
                         algebra=g()),
               GraphNode(name="act", inputs=("h_raw",), output="h",
                         op="gelu"),
               GraphNode(name="g2", inputs=("h", "W2"), output="y",
                         algebra=g())),
        inputs=("x", "W1", "W2"), output="y")


@pytest.mark.parametrize("call", ["tune", "mesh", "tuned", "graph",
                                  "sharded", "lower_group"])
def test_later_slices_raise_not_implemented(call):
    # the graph and tuning slices have arrived: graph inputs,
    # lower_group, generate(tune=...) and lower(tuned=True) now run; the
    # mesh still raises, naming its slice
    if call == "tune":
        from repro_torch.tune import TuneResult
        acc = repro_torch.generate("gemm", bounds=dict(m=16, n=16, k=16),
                                   tune=True, device="cpu")
        assert isinstance(acc.tune_result, TuneResult)
        assert acc.kernel.source == "tuned" and acc.tune_result.trials
        assert acc.validate() == 0.0
        return
    if call == "tuned":
        from repro_torch.tune import cache as tune_cache
        alg = get_algebra("gemm", m=16, n=16, k=16)
        df = pipeline.default_dataflow(alg)
        key = pipeline._cache_key(alg, df, pipeline.ArrayConfig(),
                                  torch.float32, torch.device("cpu"))
        tune_cache.store_variant(tune_cache.key_of(key), blocks=(8, 16, 4),
                                 grid_order="nmk", accum="inplace",
                                 measured_s=1e-3)
        k = pipeline.lower(alg, df, device="cpu", tuned=True)
        assert (k.source, k.blocks, k.grid_order, k.accum, k.measured_s) \
            == ("tuned", (8, 16, 4), "nmk", "inplace", 1e-3)
        assert k.validated
        assert pipeline.lower(alg, df, device="cpu",
                              tuned=False).source == "analytical"
        return
    if call == "graph":
        from repro_torch.graph import GraphAccelerator
        g = _chain_graph()
        acc = repro_torch.generate(g, device="cpu")
        assert isinstance(acc, GraphAccelerator)
        assert list(acc.group_kernels) == ["mg:g1+g2"]
        assert acc.validate() <= 1e-3 + 1e-5 * np.abs(
            g.reference(g.random_operands(0))).max()
        with pytest.raises(TypeError, match="AlgebraGraph"):
            repro_torch.generate(object(), device="cpu")
        return
    if call == "lower_group":
        from repro_torch.graph import plan_graph
        plan = plan_graph(_chain_graph())
        gk = pipeline.lower_group(plan, plan.groups[0], device="cpu")
        assert gk.kind == "chain" and gk.validated
        return
    with pytest.raises(NotImplementedError):
        if call == "mesh":
            repro_torch.generate("gemm", mesh=(2, 2), device="cpu")
        else:
            acc = repro_torch.generate("gemm", bounds=dict(m=8, n=8, k=8),
                                       device="cpu")
            acc.sharded((2, 2))


def test_describe_and_partition():
    racc = repro.generate("conv2d", "weight_stationary",
                          bounds=BOUNDS["conv2d"], backend="xla")
    pacc = repro_torch.generate("conv2d", "weight_stationary",
                                bounds=BOUNDS["conv2d"], device="cpu")
    text = pacc.describe()
    assert "template=operand_stationary" in text and "device=cpu" in text
    assert pacc.kernel.partition_for((2, 2)).describe() == \
        racc.kernel.partition_for((2, 2)).describe()


def test_accelerator_engine_serves_and_reuses():
    engine = AcceleratorEngine(device="cpu")
    alg = get_algebra("gemm", m=8, n=12, k=16)
    ops = alg.random_operands(seed=9)
    want = alg.reference(ops)
    for _ in range(2):
        got = engine.submit("gemm", ops, bounds=dict(m=8, n=12, k=16))
        np.testing.assert_array_equal(got.numpy(), want)
    ca = get_algebra("conv2d", k=4, c=2, y=3, x=3, p=2, q=2)
    cops = ca.random_operands(seed=1)
    got = engine.submit("conv2d", cops, dataflow="weight_stationary",
                        bounds=dict(k=4, c=2, y=3, x=3, p=2, q=2))
    np.testing.assert_array_equal(got.numpy(), ca.reference(cops))
    st = engine.stats()
    assert st["requests"] == 3 and st["algebras"] == ["conv2d", "gemm"]
    assert len(engine._accs) == 2
    assert "Accelerator(gemm" in engine.describe(
        "gemm", bounds=dict(m=8, n=12, k=16))
    with pytest.raises(NotImplementedError, match="mesh slice"):
        AcceleratorEngine(mesh=(2, 2), device="cpu")
