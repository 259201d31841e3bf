"""The port's whole-graph path against the reference.

Planning: the port's ``plan_graph(...).describe()`` must equal the
reference's character for character (the same decisions, reasons and
priced bytes), for the graphs of ``tests/test_graph.py`` and the
full-width h2o-danube-1.8b layer plans (16 MiB at l = 64, 512 MiB at
l = 512; only planning time).  Both planners raise the same
``RuntimeError`` where the tile-agreement fixpoint gives up.

Execution on the CPU (the wrappers' plain versions), on the same numpy
operands as the reference's ``backend="xla"`` path: exact on
integer-valued, epilogue-free graphs (every fp32 sum stays below 2^24);
otherwise within ``1e-5 x max|ref|`` (fp32 transcendental rounding and
sum order differ between XLA and PyTorch).  The plain
``chain_reference``/``dag_reference`` are held to the reference's
interpret-mode megakernels within the same tolerance; bit equality with
them is not a gate (ROADMAP Queue 3's reference caveat).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as rget_config  # noqa: E402
from repro.core import dse as rdse  # noqa: E402
from repro.core import algebra as ralgebra  # noqa: E402
from repro.core.tiling import ArrayConfig as RConfig  # noqa: E402
from repro.graph import AlgebraGraph as RGraph  # noqa: E402
from repro.graph import GraphNode as RNode  # noqa: E402
from repro.graph import executor as rexecutor  # noqa: E402
from repro.graph import from_model as rfrom_model  # noqa: E402
from repro.graph import plan_graph as rplan_graph  # noqa: E402
from repro.kernels import fused_chain as rfused  # noqa: E402
from repro.models import chains as rchains  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.compile import pipeline  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import dse  # noqa: E402
from repro_torch.core.tiling import ArrayConfig  # noqa: E402
from repro_torch.graph import AlgebraGraph, GraphAccelerator  # noqa: E402
from repro_torch.graph import GraphNode, plan_graph  # noqa: E402
from repro_torch.graph import executor, from_model  # noqa: E402
from repro_torch.kernels import fused_chain  # noqa: E402
from repro_torch.models import chains  # noqa: E402


# ---------------------------------------------------------------------------
# graph constructors: each makes the same graph in both packages
# ---------------------------------------------------------------------------

def _make(pkg, build):
    """``build(N, G, alg)`` with the package's node/graph/algebra types."""
    if pkg == "ref":
        return build(RNode, RGraph, lambda name, **b:
                     ralgebra.get_algebra(name, **b))
    from repro_torch.core.algebra import get_algebra
    return build(GraphNode, AlgebraGraph, get_algebra)


def single_node(N, G, alg):
    return G(nodes=(N(name="mm", inputs=("A", "B"), output="C",
                      algebra=alg("gemm", m=16, n=16, k=16)),),
             inputs=("A", "B"), output="C")


def chain(N, G, alg, act="gelu", m=16, n1=16, k=16, n2=16):
    return G(nodes=(
        N(name="g1", inputs=("x", "W1"), output="h_raw",
          algebra=alg("gemm", m=m, n=n1, k=k)),
        N(name="act", inputs=("h_raw",), output="h", op=act),
        N(name="g2", inputs=("h", "W2"), output="y",
          algebra=alg("gemm", m=m, n=n2, k=n1))),
        inputs=("x", "W1", "W2"), output="y")


def plain_chain(N, G, alg):
    return G(nodes=(
        N(name="g1", inputs=("x", "W1"), output="h",
          algebra=alg("gemm", m=24, n=32, k=16)),
        N(name="g2", inputs=("h", "W2"), output="y",
          algebra=alg("gemm", m=24, n=8, k=32))),
        inputs=("x", "W1", "W2"), output="y")


def b_side(N, G, alg):
    return G(nodes=(
        N(name="g1", inputs=("x", "W1"), output="h",
          algebra=alg("gemm", m=16, n=16, k=16)),
        N(name="g2", inputs=("y2", "h"), output="z",
          algebra=alg("gemm", m=16, n=16, k=16))),
        inputs=("x", "W1", "y2"), output="z")


def dtype_change(N, G, alg):
    return G(nodes=(
        N(name="g1", inputs=("x", "W1"), output="h",
          algebra=alg("gemm", m=16, n=16, k=16)),
        N(name="g2", inputs=("h", "W2"), output="y",
          algebra=alg("gemm", m=16, n=16, k=16), dtype="bfloat16")),
        inputs=("x", "W1", "W2"), output="y")


def fanout(N, G, alg):
    g = lambda: alg("gemm", m=16, n=16, k=16)  # noqa: E731
    return G(nodes=(
        N(name="g1", inputs=("x", "W1"), output="h_raw", algebra=g()),
        N(name="act", inputs=("h_raw",), output="h", op="relu"),
        N(name="g2", inputs=("h", "W2"), output="y1", algebra=g()),
        N(name="g3", inputs=("h_raw", "W3"), output="y2", algebra=g()),
        N(name="last", inputs=("y1", "y2"), output="z", algebra=g())),
        inputs=("x", "W1", "W2", "W3"), output="z")


def diamond(N, G, alg):
    g = lambda: alg("gemm", m=16, n=16, k=16)  # noqa: E731
    return G(nodes=(
        N(name="p", inputs=("x", "W"), output="c", algebra=g()),
        N(name="q1", inputs=("c", "W1"), output="o1", algebra=g()),
        N(name="q2", inputs=("c", "W2"), output="o2", algebra=g()),
        N(name="r", inputs=("o1", "o2"), output="z", algebra=g())),
        inputs=("x", "W", "W1", "W2"), output="z")


def tap_diamond(N, G, alg, m=16):
    return G(nodes=(
        N(name="p", inputs=("x", "w0"), output="t",
          algebra=alg("gemm", m=m, n=16, k=16)),
        N(name="c1", inputs=("t", "w1"), output="y1",
          algebra=alg("gemm", m=m, n=16, k=16)),
        N(name="fin", inputs=("y1", "t"), output="out", op="add")),
        inputs=("x", "w0", "w1"), output="out")


def tap_mesh(N, G, alg):
    g = lambda: alg("gemm", m=16, n=16, k=16)  # noqa: E731
    return G(nodes=(
        N(name="p", inputs=("x", "w0"), output="t", algebra=g()),
        N(name="c1", inputs=("t", "w1"), output="y1", algebra=g()),
        N(name="c2", inputs=("u", "t"), output="y2", algebra=g()),
        N(name="fin", inputs=("y1", "y2"), output="out", op="add")),
        inputs=("x", "w0", "w1", "u"), output="out")


def batched_producer(N, G, alg):
    return G(nodes=(
        N(name="bv", inputs=("A3", "v"), output="t",
          algebra=alg("batched_gemv", m=16, k=8, n=16)),
        N(name="c1", inputs=("t", "w"), output="y",
          algebra=alg("gemm", m=16, n=16, k=16))),
        inputs=("A3", "v", "w"), output="y")


def residual_chain(N, G, alg):
    """A folded external residual stream on a merged gemm pair."""
    return G(nodes=(
        N(name="g1", inputs=("x", "W1"), output="h",
          algebra=alg("gemm", m=16, n=16, k=16)),
        N(name="g2", inputs=("h", "W2"), output="y",
          algebra=alg("gemm", m=16, n=16, k=16)),
        N(name="res", inputs=("y", "skip"), output="out", op="add")),
        inputs=("x", "W1", "W2", "skip"), output="out")


def _pkg_graph(pkg, name):
    if name == "attention_mlp":
        mod = rchains if pkg == "ref" else chains
        return mod.attention_mlp_graph(lq=32, lkv=32, d=32, dv=32, f=64)
    if name == "mlp":
        mod = rchains if pkg == "ref" else chains
        return mod.mlp_graph(l=24, d=16, f=40)
    if name == "layer":
        mod = rfrom_model if pkg == "ref" else from_model
        return mod.transformer_layer_graph(l=32, d=32, dv=32, f=64)
    if name == "chain_nondiv":
        return _make(pkg, lambda N, G, a: chain(N, G, a, m=24, n1=32,
                                                k=16, n2=16))
    if name == "tap_diamond_24":
        return _make(pkg, lambda N, G, a: tap_diamond(N, G, a, m=24))
    return _make(pkg, GRAPHS[name])


GRAPHS = {
    "single_node": single_node, "chain": chain, "plain_chain": plain_chain,
    "b_side": b_side, "dtype_change": dtype_change, "fanout": fanout,
    "diamond": diamond, "tap_diamond": tap_diamond, "tap_mesh": tap_mesh,
    "batched_producer": batched_producer, "residual_chain": residual_chain,
}
ALL = sorted(GRAPHS) + ["attention_mlp", "mlp", "layer", "chain_nondiv",
                        "tap_diamond_24"]


def _ref_xla(rg, ops, dtype=jnp.float32, merge=True):
    acc = rexecutor.build(rg, backend="xla", dtype=dtype, merge=merge,
                          validate=False)
    return np.asarray(acc(ops).astype(jnp.float32), np.float64)


# ---------------------------------------------------------------------------
# the planner: describe() equal character for character
# ---------------------------------------------------------------------------

PLAN_CASES = [(name, {}) for name in ALL] + [
    ("chain", dict(search=2)),
    ("diamond", dict(search=2)),
    ("chain", dict(dtype="bfloat16")),
    ("tap_mesh", dict(mesh=(1, 2))),
    ("diamond", dict(mesh=(2, 2))),
    ("chain", dict(budget=2048)),
    ("chain", dict(budget=256)),
    ("attention_mlp", dict(budget=64 << 10)),
]


@pytest.mark.parametrize("name,kw", PLAN_CASES,
                         ids=[f"{n}-{'-'.join(map(str, k.values()))}"
                              for n, k in PLAN_CASES])
def test_plan_describe_matches_reference(name, kw):
    kw = dict(kw)
    budget = kw.pop("budget", None)
    rkw, pkw = dict(kw), dict(kw)
    if budget is not None:
        rkw["cfg"] = RConfig(vmem_budget_bytes=budget)
        pkw["cfg"] = ArrayConfig(strip_budget_bytes=budget)
    rplan = rplan_graph(_pkg_graph("ref", name), **rkw)
    pplan = plan_graph(_pkg_graph("port", name), **pkw)
    assert pplan.describe() == rplan.describe()
    assert [(g.name, g.kind, g.eligible, g.reason, g.dag, g.ext_inputs,
             g.taps, g.bm) for g in pplan.groups] == \
        [(g.name, g.kind, g.eligible, g.reason,
          tuple(fused_chain.DagStage(**vars(s)) for s in g.dag),
          g.ext_inputs, g.taps, g.bm) for g in rplan.groups]
    if budget is not None:
        assert any("VMEM" in g.reason for g in pplan.groups)


@pytest.mark.parametrize("l,budget", [(64, 16 << 20), (512, 512 << 20)])
def test_danube_full_width_plans_match_reference(l, budget):
    rg = rfrom_model.layer_graph_from_config(rget_config("h2o-danube-1.8b"),
                                             l=l)
    pg = from_model.layer_graph_from_config(get_config("h2o-danube-1.8b"),
                                            l=l)
    rplan = rplan_graph(rg, cfg=RConfig(vmem_budget_bytes=budget))
    pplan = plan_graph(pg, cfg=ArrayConfig(strip_budget_bytes=budget))
    assert pplan.describe() == rplan.describe()
    (grp,) = pplan.groups
    if l == 64:
        assert not grp.eligible
        assert grp.reason == ("DAG intermediate scratch 5062656B exceeds "
                              "the VMEM residency limit 2097152B")
    else:
        assert grp.eligible and grp.kind == "dag" and len(grp.dag) == 8
        assert grp.scratch_bytes == 41418752
        assert pplan.cost_report().hbm_bytes == 293628928
        assert grp.taps == (("oproj", "r1"),)


def test_danube_mlp_plans_a_chain_group():
    rg = rchains.mlp_graph(l=512, d=2560, f=6912)
    pg = chains.mlp_graph(l=512, d=2560, f=6912)
    rplan = rplan_graph(rg, cfg=RConfig(vmem_budget_bytes=512 << 20))
    pplan = plan_graph(pg, cfg=ArrayConfig(strip_budget_bytes=512 << 20))
    assert pplan.describe() == rplan.describe()
    (grp,) = pplan.groups
    assert grp.eligible and grp.kind == "chain" and grp.bm == 512
    assert grp.scratch_bytes == 14155776


@pytest.mark.parametrize("l", [128, 512])
def test_non_converging_tile_agreement_raises_in_both(l):
    # a reference caveat the port keeps: at danube widths under the
    # default 16 MiB budget the gcd-narrowing fixpoint gives up
    rg = rfrom_model.layer_graph_from_config(rget_config("h2o-danube-1.8b"),
                                             l=l)
    pg = from_model.layer_graph_from_config(get_config("h2o-danube-1.8b"),
                                            l=l)
    with pytest.raises(RuntimeError) as rerr:
        rplan_graph(rg)
    with pytest.raises(RuntimeError) as perr:
        plan_graph(pg)
    assert str(perr.value) == str(rerr.value) == \
        "tile agreement did not converge"


def test_search_graph_matches_reference():
    rg, pg = _pkg_graph("ref", "chain"), _pkg_graph("port", "chain")
    rp, pp = rdse.search_graph(rg, search=2), dse.search_graph(pg, search=2)
    assert pp.describe() == rp.describe()
    assert repro_torch.search_graph is dse.search_graph


def test_cost_report_matches_reference():
    rg, pg = _pkg_graph("ref", "layer"), _pkg_graph("port", "layer")
    rr, pr = rplan_graph(rg).cost_report(), plan_graph(pg).cost_report()
    assert (pr.hbm_bytes, pr.hbm_bytes_unfused, pr.cycles,
            pr.fused_edges, pr.materialized_edges, pr.tapped_edges,
            pr.tap_hbm_bytes) == (
        rr.hbm_bytes, rr.hbm_bytes_unfused, rr.cycles, rr.fused_edges,
        rr.materialized_edges, rr.tapped_edges, rr.tap_hbm_bytes)


# ---------------------------------------------------------------------------
# execution against the reference's xla path
# ---------------------------------------------------------------------------

#: integer-valued and epilogue-free: the fp32 sums are exact in both
EXACT = ("single_node", "plain_chain", "b_side", "diamond", "tap_diamond",
         "tap_diamond_24", "tap_mesh", "batched_producer", "residual_chain")


@pytest.mark.parametrize("merge", [True, False], ids=["merged", "seq"])
@pytest.mark.parametrize("name", ALL)
def test_executor_matches_reference(name, merge):
    rg, pg = _pkg_graph("ref", name), _pkg_graph("port", name)
    ops = rg.random_operands(3)
    want = _ref_xla(rg, ops)
    acc = executor.build(pg, merge=merge, device="cpu", validate=False)
    got = acc(ops).double().numpy()
    assert got.shape == want.shape
    if name in EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # merged groups lowered exactly where the reference lowers them
    racc = rexecutor.build(rg, backend="xla", merge=merge, validate=False)
    assert sorted(acc.group_kernels) == sorted(racc.group_kernels)


@pytest.mark.parametrize("name", ["chain", "tap_diamond", "layer",
                                  "attention_mlp"])
def test_merged_equals_sequential_dispatch(name):
    pg = _pkg_graph("port", name)
    ops = pg.random_operands(0)
    merged = executor.build(pg, device="cpu", validate=False)
    assert merged.group_kernels
    seq = executor.build(pg, device="cpu", merge=False, validate=False)
    assert torch.equal(merged(ops), seq(ops))
    if name in ("chain", "tap_diamond"):    # the loop-nest oracle is slow
        assert merged.validate() <= 1e-3 + 1e-5 * np.abs(
            pg.reference(ops)).max()


@pytest.mark.parametrize("name", ["chain", "tap_diamond"])
def test_bf16_graph_within_tolerance(name):
    rg, pg = _pkg_graph("ref", name), _pkg_graph("port", name)
    ops = rg.random_operands(2)
    want = _ref_xla(rg, ops, dtype=jnp.bfloat16)
    acc = executor.build(pg, dtype=torch.bfloat16, device="cpu",
                         validate=False)
    got = acc(ops).double().numpy()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    seq = executor.build(pg, dtype=torch.bfloat16, device="cpu",
                         merge=False, validate=False)
    assert torch.equal(acc(ops), seq(ops))


def test_diamond_producer_runs_once(monkeypatch):
    pg = _pkg_graph("port", "diamond")
    acc = executor.build(pg, device="cpu", merge=False)
    calls = []
    orig = pipeline.CompiledKernel.__call__

    def counting(self, operands):
        calls.append(self.algebra.name)
        return orig(self, operands)

    monkeypatch.setattr(pipeline.CompiledKernel, "__call__", counting)
    acc(pg.random_operands(0))
    assert len(calls) == 4


def test_merged_group_is_one_dispatch(monkeypatch):
    pg = _pkg_graph("port", "diamond")
    acc = repro_torch.generate(pg, device="cpu")
    assert isinstance(acc, GraphAccelerator)
    assert list(acc.group_kernels) == ["mg:p+q1+q2+r"]
    calls, group_calls = [], []
    monkeypatch.setattr(pipeline.CompiledKernel, "__call__",
                        lambda self, ops: calls.append(1))
    gorig = pipeline.CompiledGroupKernel.__call__

    def gcounting(self, lhs, rhss=(), biases=()):
        group_calls.append(self.group)
        return gorig(self, lhs, rhss, biases)

    monkeypatch.setattr(pipeline.CompiledGroupKernel, "__call__", gcounting)
    fused_chain.reset_launches()
    got = acc(pg.random_operands(0))
    assert calls == [] and len(group_calls) == 1
    # the CPU runs the plain version: no kernel launch is counted
    assert fused_chain.launches == {"fused_chain": 0, "fused_dag": 0}
    np.testing.assert_array_equal(got.numpy(),
                                  pg.reference(pg.random_operands(0)))


def test_single_node_graph_shares_the_standalone_kernel():
    pg = _pkg_graph("port", "single_node")
    acc_g = repro_torch.generate(pg, device="cpu")
    acc_a = repro_torch.generate(pg.nodes[0].algebra, device="cpu")
    assert acc_g.kernels["mm"] is acc_a.kernel
    ops = pg.random_operands(0)
    assert torch.equal(acc_g(ops), acc_a({"A": ops["A"], "B": ops["B"]}))


def test_layer_oracle_matches_reference_forward():
    rg = _pkg_graph("ref", "layer")
    ops = rg.random_operands(0)
    want = np.asarray(rfrom_model.layer_oracle(ops), np.float64)
    got = from_model.layer_oracle(
        {k: torch.as_tensor(v) for k, v in ops.items()}).double().numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    acc = executor.build(_pkg_graph("port", "layer"), device="cpu")
    out = acc(ops).double().numpy()
    assert np.abs(out - got).max() <= 1e-5 * np.abs(got).max()


def test_chain_oracles_match_reference():
    rg = _pkg_graph("ref", "attention_mlp")
    ops = rg.random_operands(1)
    want = np.asarray(rchains.attention_mlp_oracle(ops), np.float64)
    got = chains.attention_mlp_oracle(
        {k: torch.as_tensor(v) for k, v in ops.items()}).double().numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    racc = rexecutor.build(rg, backend="xla", validate=False)
    pacc = executor.build(_pkg_graph("port", "attention_mlp"), device="cpu")
    assert list(pacc.group_kernels) == list(racc.group_kernels) == \
        ["mg:scores+attend+mlp_up+mlp_down"]
    out = pacc(ops).double().numpy()
    assert np.abs(out - want).max() <= 1e-5 * np.abs(want).max()


# ---------------------------------------------------------------------------
# the plain megakernel versions against the reference's interpret mode
# ---------------------------------------------------------------------------

def _chain_stages(module):
    return (module.ChainStage(16, 24, ("bias", "gelu"), True),
            module.ChainStage(24, 20, ("scale:0.1", "softmax")),
            module.ChainStage(20, 12))


@pytest.mark.parametrize("bm", [None, 7, 16])
@pytest.mark.parametrize("interleave", ["chain", "stage"])
def test_chain_reference_matches_reference_kernel(bm, interleave):
    rng = np.random.default_rng(4)
    lhs = rng.integers(-3, 4, size=(30, 16)).astype(np.float32)
    rhss = [rng.integers(-3, 4, size=(st.k, st.n)).astype(np.float32)
            for st in _chain_stages(fused_chain)]
    bias = rng.integers(-3, 4, size=(24,)).astype(np.float32)
    want = np.asarray(rfused.fused_chain_matmul(
        jnp.asarray(lhs), [jnp.asarray(r) for r in rhss],
        [jnp.asarray(bias)], stages=_chain_stages(rfused), bm=bm,
        interleave=interleave, interpret=True), np.float64)
    got = fused_chain.fused_chain_matmul(
        torch.as_tensor(lhs), [torch.as_tensor(r) for r in rhss],
        [torch.as_tensor(bias)], stages=_chain_stages(fused_chain), bm=bm,
        interleave=interleave).double().numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("name", ["layer", "tap_diamond", "batched_producer",
                                  "b_side", "diamond"])
def test_dag_reference_matches_reference_kernel(name):
    rplan = rplan_graph(_pkg_graph("ref", name))
    pplan = plan_graph(_pkg_graph("port", name))
    rgrp = next(g for g in rplan.groups if g.eligible)
    pgrp = next(g for g in pplan.groups if g.eligible)
    assert rgrp.kind == pgrp.kind == "dag"
    rng = np.random.default_rng(5)
    exts = [rng.integers(-3, 4, size=rplan.graph.edge_shape(e)).astype(
        np.float32) for e, _ in rgrp.ext_inputs]

    def prep(e, role):
        if role == "rhs":
            return e.T
        if role == "bias":
            return e.reshape(1, -1)
        return e

    prepped = [prep(e, role) for e, (_, role) in zip(exts, rgrp.ext_inputs)]
    want = rfused.fused_dag([jnp.asarray(e) for e in prepped],
                            stages=rgrp.dag, interpret=True)
    got = fused_chain.fused_dag([torch.as_tensor(np.ascontiguousarray(e))
                                 for e in prepped], stages=pgrp.dag)
    assert len(got) == len(want) == 1 + len(pgrp.taps)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        assert np.abs(g.double().numpy() - w).max() <= \
            1e-5 * max(1.0, np.abs(w).max())


def test_estimators_match_reference_value_for_value():
    st_p, st_r = _chain_stages(fused_chain), _chain_stages(rfused)
    for m, bm, item in ((30, 7, 4), (512, 512, 2), (64, 16, 4)):
        assert fused_chain.chain_scratch_bytes(st_p, bm, item) == \
            rfused.chain_scratch_bytes(st_r, bm, item)
        assert fused_chain.stage_scratch_bytes(st_p, m, item) == \
            rfused.stage_scratch_bytes(st_r, m, item)
        for il in ("chain", "stage"):
            assert fused_chain.chain_vmem_bytes(st_p, m, 16, bm, item, il) \
                == rfused.chain_vmem_bytes(st_r, m, 16, bm, item, il)
    rgrp = rplan_graph(_pkg_graph("ref", "layer")).groups[0]
    pgrp = plan_graph(_pkg_graph("port", "layer")).groups[0]
    for item in (2, 4):
        assert fused_chain.dag_scratch_bytes(pgrp.dag, item) == \
            rfused.dag_scratch_bytes(rgrp.dag, item)
    assert fused_chain.FUSED_INTERLEAVES == rfused.FUSED_INTERLEAVES
    assert fused_chain.DAG_INTERLEAVE == rfused.DAG_INTERLEAVE


@pytest.mark.parametrize("bad,match", [
    (lambda m: [m.ChainStage(8, 4), m.ChainStage(5, 4)], "chain n -> k"),
    (lambda m: [m.ChainStage(8, 4, ("bias",), False)], "needs bias"),
    (lambda m: [], "at least one stage"),
])
def test_validate_chain_rejects_like_reference(bad, match):
    with pytest.raises(ValueError, match=match):
        rfused.validate_chain(bad(rfused), 8)
    with pytest.raises(ValueError, match=match):
        fused_chain.validate_chain(bad(fused_chain), 8)


@pytest.mark.parametrize("bad,match", [
    (lambda m: [m.DagStage(4, 4, 4, lhs=("scr", 0))], "earlier stage"),
    (lambda m: [m.DagStage(4, 4, 4, kind="conv")], "unknown kind"),
    (lambda m: [m.DagStage(4, 4, 4, tap=0)], "cannot also be a tap"),
    (lambda m: [m.DagStage(4, 4, 4, tap=1), m.DagStage(4, 4, 4)],
     "no gaps"),
    (lambda m: [m.DagStage(4, 4, 4), m.DagStage(4, 8, 4, lhs=("scr", 0))],
     "needs"),
])
def test_validate_dag_rejects_like_reference(bad, match):
    with pytest.raises(ValueError, match=match):
        rfused.validate_dag(bad(rfused))
    with pytest.raises(ValueError, match=match):
        fused_chain.validate_dag(bad(fused_chain))


# ---------------------------------------------------------------------------
# group lowering, cache keys, describe()
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bm", [7, 16])
@pytest.mark.parametrize("interleave", ["chain", "stage"])
def test_lower_group_overrides(bm, interleave):
    pg = _pkg_graph("port", "chain_nondiv")
    plan = plan_graph(pg)
    grp = next(g for g in plan.groups if g.eligible)
    gk = pipeline.lower_group(plan, grp, device="cpu", bm=bm,
                              interleave=interleave)
    assert (gk.bm, gk.interleave, gk.source) == (bm, interleave, "explicit")
    assert gk.validated
    ops = pg.random_operands(0)
    got = gk(ops["x"], [ops["W1"], ops["W2"]], []).double().numpy()
    want = np.asarray(pg.reference(ops), np.float64)
    assert np.abs(got - want).max() <= 1e-3 + 1e-5 * np.abs(want).max()
    assert pipeline.lower_group(plan, grp, device="cpu", bm=bm,
                                interleave=interleave) is gk
    with pytest.raises(ValueError, match="interleave"):
        pipeline.lower_group(plan, grp, device="cpu", interleave="dag")


def test_group_cache_key_separates_epilogues_like_reference():
    def keys(pkg, plan_fn, key_fn):
        p1 = plan_fn(_make(pkg, chain))
        p2 = plan_fn(_make(pkg, lambda N, G, a: chain(N, G, a, act="relu")))
        return key_fn(p1, p1.groups[0]), key_fn(p2, p2.groups[0])

    pk1, pk2 = keys("port", plan_graph,
                    lambda p, g: pipeline._group_cache_key(p, g, "cpu"))
    from repro.compile import pipeline as rpipeline
    rk1, rk2 = keys("ref", rplan_graph,
                    lambda p, g: rpipeline._group_cache_key(p, g, True,
                                                            "pallas"))
    assert (pk1 != pk2) and (rk1 != rk2)


def test_describe_surfaces_reasons():
    pg = _pkg_graph("port", "chain")
    cfg = ArrayConfig(strip_budget_bytes=256)
    plan = plan_graph(pg, cfg=cfg)
    grp = plan.groups[0]
    assert not grp.eligible and "VMEM" in grp.reason
    acc = executor.build(pg, plan=plan, cfg=cfg, device="cpu")
    assert not acc.group_kernels
    assert f"sequential {grp.name}: {grp.reason}" in acc.describe()
    acc.validate()
    off = executor.build(pg, merge=False, device="cpu")
    assert "merging disabled (merge=False)" in off.describe()
    on = executor.build(pg, device="cpu")
    assert f"merged {grp.name}" in on.describe()


def test_bias_namespace_collision_rejected():
    from repro_torch.core.algebra import get_algebra
    g = AlgebraGraph(nodes=(GraphNode(name="mm", inputs=("bias:x", "B"),
                                      output="C",
                                      algebra=get_algebra("gemm", m=4, n=4,
                                                          k=4)),),
                     inputs=("bias:x", "B"), output="C")
    with pytest.raises(ValueError, match="bias:"):
        executor.build(g, device="cpu")
    assert executor.bias_operand_key("b1") == \
        rexecutor.bias_operand_key("b1")


@pytest.mark.parametrize("call", ["tune", "mesh", "tuned", "generate_tune",
                                  "generate_mesh"])
def test_graph_deferrals_raise_naming_their_slice(call):
    pg = _pkg_graph("port", "chain")
    slice_ = "tuning" if "tune" in call else "mesh"
    with pytest.raises(NotImplementedError, match=f"{slice_} slice"):
        if call == "tune":
            executor.build(pg, device="cpu", tune=4)
        elif call == "mesh":
            executor.build(pg, device="cpu", mesh=(2, 2))
        elif call == "tuned":
            plan = plan_graph(pg)
            pipeline.lower_group(plan, plan.groups[0], device="cpu",
                                 tuned=True)
        elif call == "generate_tune":
            repro_torch.generate(pg, device="cpu", tune=True)
        else:
            repro_torch.generate(pg, device="cpu", mesh=(1, 2))


def test_generate_graph_rejects_algebra_options():
    pg = _pkg_graph("port", "chain")
    with pytest.raises(ValueError, match="do not apply"):
        repro_torch.generate(pg, "identity", device="cpu")
    with pytest.raises(ValueError, match="must be an int"):
        repro_torch.generate(pg, search=[], device="cpu")


def test_layer_graph_from_config():
    cfg = get_config("granite-8b").reduced()
    g = from_model.layer_graph_from_config(cfg, l=16)
    assert g.edge_shape("x") == (16, cfg.d_model)
    assert g.edge_shape("h_raw") == (16, cfg.d_ff)
    with pytest.raises(ValueError, match="dense"):
        from_model.layer_graph_from_config(
            get_config("mamba2-370m").reduced())


def test_ir_validation_matches_reference():
    from repro_torch.core.algebra import get_algebra
    with pytest.raises(ValueError, match="cycle"):
        AlgebraGraph(nodes=(GraphNode(name="a", inputs=("y",), output="x",
                                      op="relu"),
                            GraphNode(name="b", inputs=("x",), output="y",
                                      op="relu")),
                     inputs=(), output="y")
    with pytest.raises(ValueError, match="shape mismatch"):
        AlgebraGraph(nodes=(
            GraphNode(name="g1", inputs=("x", "W"), output="h",
                      algebra=get_algebra("gemm", m=16, n=32, k=16)),
            GraphNode(name="g2", inputs=("h", "V"), output="y",
                      algebra=get_algebra("gemm", m=16, n=16, k=16))),
            inputs=("x", "W", "V"), output="y")
    with pytest.raises(ValueError, match="input edge"):
        GraphNode(name="b", inputs=("x",), output="y", op="bias")
    pg, rg = _pkg_graph("port", "layer"), _pkg_graph("ref", "layer")
    assert pg.describe() == rg.describe()
    assert pg.topo_nodes == tuple(
        GraphNode(name=n.name, inputs=n.inputs, output=n.output,
                  algebra=None if n.algebra is None
                  else get_algebra(n.algebra.name, **dict(zip(
                      n.algebra.loops, n.algebra.bounds))),
                  op=n.op, dtype=n.dtype) for n in rg.topo_nodes)
    pg, rg = _pkg_graph("port", "fanout"), _pkg_graph("ref", "fanout")
    ops = rg.random_operands(4)
    np.testing.assert_array_equal(pg.reference(ops), rg.reference(ops))


# ---------------------------------------------------------------------------
# convert: a reference graph case across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("merge", [True, False])
def test_convert_carries_graph_accelerator(merge):
    rg = _pkg_graph("ref", "layer")
    racc = rexecutor.build(rg, backend="xla", merge=merge, validate=False)
    pacc = convert.from_reference(racc, device="cpu")
    assert isinstance(pacc, GraphAccelerator)
    assert pacc.plan.describe() == racc.plan.describe()
    assert sorted(pacc.group_kernels) == sorted(racc.group_kernels)
    assert convert.from_reference(rg).describe() == rg.describe()
    ops = rg.random_operands(6)
    got = pacc(convert.operands_to(ops, device="cpu")).double().numpy()
    want = np.asarray(racc(ops), np.float64)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
