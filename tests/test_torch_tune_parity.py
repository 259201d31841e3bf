"""The port's tuner against the reference's, on the same inputs.

* The candidate generators (``block_candidates``, ``_knob_grid``,
  ``group_bm_candidates``) are equal for every registry algebra under
  each named STT and for the groups of the reduced h2o-danube-1.8b chain
  and layer graphs.
* With ``measure`` replaced in both packages by one deterministic table
  of times keyed by what is timed — a kernel's (dataflow, variant), a
  merged kernel's (bm, interleave), the sequential baseline — ``tune``,
  ``tune_group`` and ``rank_measured`` make the same decisions: the same
  trial lists, ok flags, winners and verdicts.  The port runs its plain
  versions (``device="cpu"``), the reference its interpret-mode kernels.
* The port's cache is a file of its own and never reads the reference's.

The reference draws a DAG group's operands once per (edge, role) slot,
so where one edge plays two roles (the danube layer reads ``x`` as lhs,
rhs and residual) its merged trial is gated against a baseline that saw
another ``x``, and always fails.  The port draws once per edge.  The DAG
parity cases therefore run both packages with a random generator keyed
by operand shape (the slots of one edge get one value in both), and
``test_dag_operands_one_draw_per_edge`` shows the difference itself.
"""
import json
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.compile import pipeline as rpipeline  # noqa: E402
from repro.configs.registry import get_config as rget_config  # noqa: E402
from repro.core import algebra as ralgebra  # noqa: E402
from repro.core import dse as rdse  # noqa: E402
from repro.core import stt as rstt  # noqa: E402
from repro.graph import from_model as rfrom_model  # noqa: E402
from repro.graph import plan_graph as rplan_graph  # noqa: E402
from repro.models import chains as rchains  # noqa: E402
from repro.tune import cache as rcache  # noqa: E402
from repro.tune import tuner as rtuner  # noqa: E402

from repro_torch.compile import pipeline  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import dse, stt  # noqa: E402
from repro_torch.core.algebra import (PAPER_ALGEBRAS, batched_gemv,  # noqa
                                      gemm, get_algebra)
from repro_torch.graph import from_model, plan_graph  # noqa: E402
from repro_torch.models import chains  # noqa: E402
from repro_torch.tune import cache, tuner  # noqa: E402
from repro_torch.tune.measure import Measurement  # noqa: E402

STTS = ("identity", "output_stationary", "weight_stationary",
        "input_stationary")
#: small bounds for every registry algebra
BOUNDS = {
    "gemm": dict(m=16, n=24, k=20),
    "batched_gemv": dict(m=5, n=24, k=40),
    "conv2d": dict(k=8, c=3, y=5, x=4, p=3, q=3),
    "depthwise_conv": dict(k=9, y=6, x=5, p=3, q=2),
    "mttkrp": dict(i=20, j=18, k=5, l=4),
    "ttmc": dict(i=10, j=4, k=6, l=5, m=3),
}


@pytest.mark.parametrize("name", sorted(PAPER_ALGEBRAS))
@pytest.mark.parametrize("kind", STTS)
def test_block_candidates_match_reference(name, kind):
    alg = get_algebra(name, **BOUNDS[name])
    ralg = ralgebra.get_algebra(name, **BOUNDS[name])
    df = stt.apply_stt(alg, alg.loops[:3], stt.stt_from_name(kind))
    rdf = rstt.apply_stt(ralg, ralg.loops[:3], rstt.stt_from_name(kind))
    k = pipeline.lower(alg, df, device="cpu", validate=False, tuned=False)
    rk = rpipeline.lower(ralg, rdf, interpret=True, validate=False,
                         tuned=False)
    dims = (k.form.m, k.form.n, k.form.k)
    assert (k.blocks, dims, k.template) == (
        rk.blocks, (rk.form.m, rk.form.n, rk.form.k), rk.template)
    assert tuner.block_candidates(k.blocks, dims) == \
        rtuner.block_candidates(rk.blocks, dims)


@pytest.mark.parametrize("template", ["output_stationary",
                                      "operand_stationary",
                                      "reduction_tree", "streaming"])
def test_knob_grid_matches_reference(template):
    assert tuner._knob_grid(template) == rtuner._knob_grid(template)


def _group_pairs():
    cfg, rcfg = (get_config("h2o-danube-1.8b").reduced(),
                 rget_config("h2o-danube-1.8b").reduced())
    return {
        "mlp": (chains.mlp_graph(l=24, d=16, f=40),
                rchains.mlp_graph(l=24, d=16, f=40)),
        "chain": (chains.mlp_graph(l=64, d=cfg.d_model, f=cfg.d_ff),
                  rchains.mlp_graph(l=64, d=rcfg.d_model, f=rcfg.d_ff)),
        "layer": (from_model.layer_graph_from_config(cfg, l=64),
                  rfrom_model.layer_graph_from_config(rcfg, l=64)),
    }


@pytest.mark.parametrize("which", ["mlp", "chain", "layer"])
def test_group_bm_candidates_match_reference(which):
    g, rg = _group_pairs()[which]
    plan, rplan = plan_graph(g), rplan_graph(rg)
    assert [x.name for x in plan.groups] == [x.name for x in rplan.groups]
    assert plan.groups
    for grp, rgrp in zip(plan.groups, rplan.groups):
        assert tuner.group_bm_candidates(grp) == \
            rtuner.group_bm_candidates(rgrp)
        if grp.kind == "chain":
            np.testing.assert_array_equal(
                tuner._group_operands(grp, 3)[0],
                rtuner._group_operands(rgrp, 3)[0])


# ---------------------------------------------------------------------------
# Parity with the reference: decisions under one injected timing table
# ---------------------------------------------------------------------------

#: the sequential baseline's injected median, per verdict case
SEQUENTIAL_S = {"merged": 1.0, "sequential": 1e-6}


def _fake_measure(sequential_s):
    """A deterministic ``measure`` for both packages: the time is a hash
    of what the callable is — a kernel's (dataflow, variant), a merged
    kernel's (bm, interleave), or the sequential baseline."""
    def fake(fn, *args, warmup=1, repeats=5, **kwargs):
        if hasattr(fn, "dataflow"):
            key = ("kernel", fn.dataflow.name, tuple(fn.dataflow.selected),
                   tuple(int(b) for b in fn.blocks), fn.grid_order,
                   fn.accum)
        elif hasattr(fn, "interleave"):
            key = ("group", int(fn.bm), fn.interleave)
        else:
            return Measurement(times_s=(sequential_s,), warmup_s=0.0)
        t = 1e-3 * (1 + zlib.crc32(repr(key).encode()) % 997 / 997)
        return Measurement(times_s=(t,), warmup_s=0.0)
    return fake


@pytest.fixture
def same_clock(monkeypatch):
    def install(sequential_s=1.0):
        fake = _fake_measure(sequential_s)
        monkeypatch.setattr(tuner, "measure", fake)
        monkeypatch.setattr(rtuner, "measure", fake)
    return install


def _trial_rows(trials):
    return [(t.dataflow_name, tuple(int(b) for b in t.variant.blocks),
             t.variant.grid_order, t.variant.accum, t.ok) for t in trials]


@pytest.mark.parametrize("name, bounds, search", [
    ("gemm", dict(m=16, n=24, k=20), 3),
    ("conv2d", dict(k=8, c=3, y=5, x=4, p=3, q=3), 4),
])
def test_tune_decisions_match_reference(same_clock, name, bounds, search):
    same_clock()
    alg = get_algebra(name, **bounds)
    ralg = ralgebra.get_algebra(name, **bounds)
    res = tuner.tune(alg, search=search, device="cpu", validate=False)
    rres = rtuner.tune(ralg, search=search, interpret=True, validate=False)
    assert _trial_rows(res.trials) == _trial_rows(rres.trials)
    assert len(res.trials) > 1
    v, rv = res.variant, rres.variant
    assert (res.dataflow.name, v.blocks, v.grid_order, v.accum) == (
        rres.dataflow.name, rv.blocks, rv.grid_order, rv.accum)
    assert res.tuned_s == rres.tuned_s
    assert res.untuned_s == rres.untuned_s


@pytest.mark.parametrize("verdict", ["merged", "sequential"])
def test_tune_group_chain_decisions_match_reference(same_clock, verdict):
    same_clock(SEQUENTIAL_S[verdict])
    g, rg = _group_pairs()["mlp"]
    plan, rplan = plan_graph(g), rplan_graph(rg)
    grp = next(x for x in plan.groups if x.eligible)
    rgrp = next(x for x in rplan.groups if x.eligible)
    res = tuner.tune_group(plan, grp, device="cpu")
    rres = rtuner.tune_group(rplan, rgrp, interpret=True)
    assert [(t.variant.bm, t.variant.interleave, t.ok) for t in res.trials] \
        == [(t.variant.bm, t.variant.interleave, t.ok) for t in rres.trials]
    assert all(t.ok for t in res.trials)
    assert (res.merged, res.variant and res.variant.bm,
            res.variant and res.variant.interleave) == (
        rres.merged, rres.variant and rres.variant.bm,
        rres.variant and rres.variant.interleave)
    assert res.merged == (verdict == "merged")
    assert (res.merged_s, res.sequential_s) == (rres.merged_s,
                                                rres.sequential_s)


def _shape_keyed_rng(seed=None):
    """A stand-in for ``np.random.default_rng`` whose draws depend only
    on the requested shape: every slot of one edge gets one value."""
    class Rng:
        def integers(self, low, high, size=None):
            bits = np.random.PCG64(zlib.crc32(repr(tuple(size)).encode()))
            return np.random.Generator(bits).integers(low, high, size=size)
    return Rng()


@pytest.mark.parametrize("verdict", ["merged", "sequential"])
def test_tune_group_dag_decisions_match_reference(same_clock, monkeypatch,
                                                  verdict):
    same_clock(SEQUENTIAL_S[verdict])
    monkeypatch.setattr(np.random, "default_rng", _shape_keyed_rng)
    g, rg = _group_pairs()["layer"]
    plan, rplan = plan_graph(g), rplan_graph(rg)
    (grp,), (rgrp,) = plan.groups, rplan.groups
    assert grp.kind == rgrp.kind == "dag" and grp.eligible
    res = tuner.tune_group(plan, grp, device="cpu")
    rres = rtuner.tune_group(rplan, rgrp, interpret=True)
    assert [(t.variant, t.ok) for t in res.trials] == [
        (tuner.GroupVariant(t.variant.bm, t.variant.interleave), t.ok)
        for t in rres.trials]
    assert res.trials[0].ok
    assert (res.merged, res.merged_s, res.sequential_s) == (
        rres.merged, rres.merged_s, rres.sequential_s)
    assert res.merged == (verdict == "merged")


def test_dag_operands_one_draw_per_edge(same_clock):
    # the reference's own operand draw fails its merged trial where an
    # edge plays two roles; the port's draws one value per edge
    same_clock()
    g, rg = _group_pairs()["layer"]
    plan, rplan = plan_graph(g), rplan_graph(rg)
    (grp,), (rgrp,) = plan.groups, rplan.groups
    roles = [e for e, _ in grp.ext_inputs]
    assert roles.count("x") == 3
    exts = tuner._dag_operands(plan, grp, 0)
    xs = [a for (e, _), a in zip(grp.ext_inputs, exts) if e == "x"]
    assert all(a is xs[0] for a in xs)
    rres = rtuner.tune_group(rplan, rgrp, interpret=True)
    assert not rres.trials[0].ok and "rel err" in rres.trials[0].error
    res = tuner.tune_group(plan, grp, device="cpu")
    assert res.trials[0].ok and res.merged


def test_rank_measured_matches_reference(same_clock):
    same_clock()
    alg, ralg = batched_gemv(4, 16, 16), ralgebra.batched_gemv(4, 16, 16)
    pairs, rpairs = dse.search(alg, top_k=4), rdse.search(ralg, top_k=4)
    got = tuner.rank_measured(alg, pairs, device="cpu")
    want = rtuner.rank_measured(ralg, rpairs, interpret=True)
    assert [(df.name, df.selected, t) for _, df, t in got] == \
        [(df.name, df.selected, t) for _, df, t in want]
    assert [pairs.index(next(p for p in pairs if p[1] is df))
            for _, df, _ in got] == [
        rpairs.index(next(p for p in rpairs if p[1] is df))
        for _, df, _ in want]


def test_port_never_reads_reference_cache(same_clock):
    same_clock()
    alg, ralg = gemm(16, 16, 16), ralgebra.gemm(16, 16, 16)
    rres = rtuner.tune(ralg, search=1, interpret=True, validate=False)
    assert not rres.cache_hit and rcache.cache_path().exists()
    assert not cache.cache_path().exists()
    # a corrupt reference file is not the port's concern
    rcache.cache_path().write_text("{ not json")
    corrupt = cache.cache_info()["corrupt"]
    res = tuner.tune(alg, search=1, device="cpu", validate=False)
    assert not res.cache_hit and res.trials
    assert cache.cache_path().exists()
    assert cache.cache_path() != rcache.cache_path()
    assert cache.cache_info()["corrupt"] == corrupt
    assert json.loads(cache.cache_path().read_text())["choices"]
