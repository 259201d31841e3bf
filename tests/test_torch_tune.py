"""The port's measured autotuning (``repro_torch.tune``) on the CPU.

Counterparts of ``tests/test_tune.py`` — harness, cache robustness,
tuner, merged-group verdicts, calibration, knobs, bench schema — run
with ``device="cpu"``, where every kernel is its plain version;
``calibrate.fit`` and ``report.validate_bench`` are held to the
reference's on the same records and documents.  The tuner's decisions
against the reference's are in ``tests/test_torch_tune_parity.py``.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.tune import cache as rcache  # noqa: E402
from repro.tune import calibrate as rcalibrate  # noqa: E402
from repro.tune import report as rreport  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.compile import pipeline  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import dse  # noqa: E402
from repro_torch.core.algebra import batched_gemv, gemm  # noqa: E402
from repro_torch.core.costmodel import PaperCycleModel  # noqa: E402
from repro_torch.core.tiling import ArrayConfig  # noqa: E402
from repro_torch.graph import executor, from_model, plan_graph  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import chains  # noqa: E402
from repro_torch.tune import cache, calibrate, report, tuner  # noqa: E402
from repro_torch.tune.measure import Measurement, measure  # noqa: E402

#: fast CPU tuning knobs shared by the end-to-end tests
FAST = dict(device="cpu", repeats=2, warmup=1, validate=False)


def small_gemm():
    return gemm(16, 16, 16)


# ---------------------------------------------------------------------------
# Shared measurement harness
# ---------------------------------------------------------------------------

class TestMeasure:
    def test_counts_and_blocks(self):
        calls = []

        def fn(x):
            calls.append(x)
            return {"out": (torch.ones(1), [torch.zeros(2)])}

        m = measure(fn, 7, warmup=2, repeats=5)
        assert len(calls) == 7          # 2 warmup + 5 timed
        assert len(m.times_s) == 5
        assert m.warmup_s >= 0.0
        assert all(t >= 0.0 for t in m.times_s)

    def test_statistics(self):
        m = Measurement(times_s=(3.0, 1.0, 2.0), warmup_s=0.1)
        assert m.median_s == 2.0
        assert m.best_s == 1.0
        assert m.mean_s == pytest.approx(2.0)
        m2 = Measurement(times_s=(1.0, 2.0, 3.0, 4.0), warmup_s=0.0)
        assert m2.median_s == 2.5
        assert m2.cycles(320.0) == pytest.approx(2.5 * 320e6)

    def test_repeats_validation(self):
        with pytest.raises(ValueError):
            measure(lambda: None, repeats=0)


# ---------------------------------------------------------------------------
# On-disk tuning cache
# ---------------------------------------------------------------------------

class TestTuneCache:
    def test_roundtrip_and_persistence(self):
        key = cache.key_of(("some", "compile", "key", 1))
        assert cache.lookup_variant(key) is None
        cache.store_variant(key, blocks=(8, 16, 32), grid_order="kmn",
                            accum="inplace", measured_s=0.5, untuned_s=1.0)
        entry = cache.lookup_variant(key)
        assert entry["blocks"] == [8, 16, 32]
        assert entry["grid_order"] == "kmn"
        assert entry["measured_s"] == 0.5
        # survives a memo reset (simulates a fresh process)
        cache.cache_clear(counters_only=True)
        assert cache.lookup_variant(key)["blocks"] == [8, 16, 32]

    def test_key_stability(self):
        import hashlib
        tup = ("alg", ("m", "n"), 3.5)
        assert cache.key_of(tup) == hashlib.sha256(
            repr(tup).encode()).hexdigest()
        assert cache.key_of(tup) == cache.key_of(("alg", ("m", "n"), 3.5))
        assert cache.key_of(tup) != cache.key_of(("alg", ("m", "n"), 3.6))
        assert cache.key_of(tup) == rcache.key_of(tup)

    def test_corrupt_file_warns_and_falls_back(self):
        key = cache.key_of(("k",))
        cache.store_variant(key, blocks=(1, 1, 1), grid_order="default",
                            accum="auto")
        cache.cache_path().write_text("{ not json !!!")
        cache.cache_clear(counters_only=True)
        with pytest.warns(RuntimeWarning, match="unreadable"):
            assert cache.lookup_variant(key) is None
        assert cache.cache_info()["corrupt"] >= 1
        # the lower() consult path degrades to analytical, not an error
        k = pipeline.lower(small_gemm(), device="cpu", validate=False)
        assert k.source == "analytical"

    def test_version_mismatch_drops_entries(self):
        key = cache.key_of(("k2",))
        cache.store_variant(key, blocks=(2, 2, 2), grid_order="default",
                            accum="auto")
        doc = json.loads(cache.cache_path().read_text())
        doc["version"] = 999
        cache.cache_path().write_text(json.dumps(doc))
        cache.cache_clear(counters_only=True)
        assert cache.lookup_variant(key) is None
        assert cache.cache_info()["invalid"] >= 1

    def test_invalid_entry_rejected(self):
        key = cache.key_of(("k3",))
        cache.store_variant(key, blocks=(2, 2, 2), grid_order="default",
                            accum="auto")
        doc = json.loads(cache.cache_path().read_text())
        doc["variants"][key]["blocks"] = [0, -1]     # malformed
        cache.cache_path().write_text(json.dumps(doc))
        cache.cache_clear(counters_only=True)
        assert cache.lookup_variant(key) is None
        assert cache.cache_info()["invalid"] >= 1

    def test_counters(self):
        cache.cache_clear()
        key = cache.key_of(("k4",))
        assert cache.lookup_variant(key) is None
        cache.store_variant(key, blocks=(4, 4, 4), grid_order="default",
                            accum="auto")
        assert cache.lookup_variant(key) is not None
        info = cache.cache_info()
        assert info["hits"] == 1 and info["misses"] == 1
        assert info["stores"] == 1 and info["variants"] == 1

    def test_choice_roundtrip(self):
        key = cache.shape_key_for(small_gemm(), ArrayConfig(), torch.float32,
                                  torch.device("cpu"))
        assert key != cache.shape_key_for(small_gemm(), ArrayConfig(),
                                          torch.bfloat16, "cpu")
        variant = cache.store_variant(
            cache.key_of(("base",)), blocks=(16, 16, 16),
            grid_order="default", accum="auto")
        cache.store_choice(key, selected=("m", "n", "k"),
                           T=[[1, 0, 0], [0, 1, 0], [0, 0, 1]],
                           variant=variant, dataflow_name="MNK-X")
        got = cache.lookup_choice(key)
        assert got["selected"] == ["m", "n", "k"]
        assert got["variant"]["blocks"] == [16, 16, 16]

    def test_port_cache_is_its_own_file(self, tmp_path, monkeypatch):
        root = tmp_path / "tc"
        monkeypatch.setenv("REPRO_TUNE_CACHE", str(root))
        assert cache.cache_path() == root / "torch" / "tune_cache.json"
        assert rcache.cache_path() == root / "tune_cache.json"
        assert calibrate.calibration_path().parent == root / "torch"
        monkeypatch.delenv("REPRO_TUNE_CACHE")
        assert cache.cache_dir().name == "repro-torch-tune"
        assert cache.cache_dir() != rcache.cache_dir()


# ---------------------------------------------------------------------------
# Tuner end-to-end (plain versions on the CPU)
# ---------------------------------------------------------------------------

class TestTuner:
    def test_tuned_never_slower_and_cache_hit(self):
        alg = small_gemm()
        res = tuner.tune(alg, search=1, **FAST)
        assert not res.cache_hit
        assert res.trials, "tuner must run trials on a cache miss"
        assert res.tuned_s <= res.untuned_s      # untuned is trial #0
        assert res.speedup >= 1.0
        assert res.kernel.source == "tuned"
        assert res.kernel.measured_s == res.tuned_s
        assert res.kernel.device.type == "cpu"
        # second call: pure cache hit, no measurement
        res2 = tuner.tune(alg, search=1, **FAST)
        assert res2.cache_hit and res2.trials == ()
        assert res2.variant == res.variant
        assert res2.kernel.blocks == tuple(res.variant.blocks)

    def test_lower_consults_tuning_cache(self):
        alg = small_gemm()
        res = tuner.tune(alg, search=1, **FAST)
        pipeline.cache_clear()
        cache.cache_clear(counters_only=True)    # fresh memo, same file
        k = pipeline.lower(alg, res.dataflow, device="cpu", validate=False)
        assert k.source == "tuned"
        assert k.blocks == tuple(res.variant.blocks)
        assert k.grid_order == res.variant.grid_order
        assert k.accum == res.variant.accum
        assert k.measured_s == pytest.approx(res.tuned_s)
        # tuned=False bypasses the consult
        k2 = pipeline.lower(alg, res.dataflow, device="cpu",
                            validate=False, tuned=False)
        assert k2.source == "analytical"

    def test_tuned_kernel_matches_oracle(self):
        alg = small_gemm()
        res = tuner.tune(alg, search=1, **FAST)
        assert res.kernel.validate() <= 1e-3

    def test_pinned_dataflow(self):
        alg = small_gemm()
        df = pipeline.default_dataflow(alg)
        res = tuner.tune(alg, df, force=True, **FAST)
        assert res.dataflow.signature == df.signature
        assert all(t.dataflow_name == df.name for t in res.trials)

    def test_measured_cycles_in_report(self):
        alg = small_gemm()
        res = tuner.tune(alg, search=1, **FAST)
        rep = res.kernel.cost_report()
        assert rep.measured_cycles == pytest.approx(
            res.tuned_s * ArrayConfig().freq_mhz * 1e6)

    def test_rank_measured_is_permutation(self):
        alg = batched_gemv(4, 16, 16)
        pairs = dse.search(alg, top_k=3)
        ranked = tuner.rank_measured(alg, pairs, **{
            k: v for k, v in FAST.items() if k != "validate"})
        assert len(ranked) == len(pairs)
        assert {id(df) for _, df, _ in ranked} == {id(df) for _, df in pairs}
        medians = [t for _, _, t in ranked]
        assert medians == sorted(medians)

    def test_generate_tune_front_door(self):
        acc = repro_torch.generate("gemm", bounds=dict(m=16, n=16, k=16),
                                   tune=1, device="cpu", validate=False)
        assert acc.tune_result is not None
        assert not acc.tune_result.cache_hit
        text = acc.describe()
        assert "tuned:" in text and "cycles:" in text and "measured=" in text
        acc2 = repro_torch.generate("gemm", bounds=dict(m=16, n=16, k=16),
                                    tune=1, device="cpu", validate=False)
        assert acc2.tune_result.cache_hit
        assert "cache-hit" in acc2.describe()
        with pytest.raises(ValueError):
            repro_torch.generate("gemm", "output_stationary", tune=True,
                                 device="cpu")
        with pytest.raises(ValueError):
            repro_torch.generate("gemm", search=2, tune=True, device="cpu")

    def test_launch_errors_are_not_failed_trials(self, monkeypatch):
        # only a knob the templates reject (ValueError) is a failed
        # trial; anything else — a CUDA launch error on the card — ends
        # the tune call instead of quietly dropping the variant
        alg = small_gemm()
        real = ops.stt_matmul

        def boom(*args, **kwargs):
            if kwargs.get("grid_order") == "nmk":
                raise RuntimeError("stt_os_launch: CUDA error 700 at launch")
            return real(*args, **kwargs)

        with monkeypatch.context() as m:
            m.setattr(ops, "stt_matmul", boom)
            with pytest.raises(RuntimeError, match="CUDA error"):
                tuner.tune(alg, search=1, force=True, **FAST)
        res = tuner.tune(alg, pipeline.default_dataflow(alg), force=True,
                         **FAST)
        failed = [t for t in res.trials if not t.ok]
        assert failed and all(t.error.startswith("ValueError")
                              and t.variant.accum == "scratch"
                              and t.variant.grid_order in ("kmn", "knm")
                              for t in failed)

    def test_entry_points_never_drop_to_the_cpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tuner.tune(small_gemm(), search=1)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            repro_torch.generate("gemm", tune=True)


# ---------------------------------------------------------------------------
# Merged-group tuning (plain versions on the CPU)
# ---------------------------------------------------------------------------

class TestTuneGroup:
    def test_verdict_cached_and_honored_by_build(self):
        g = chains.mlp_graph(l=24, d=16, f=40)
        plan = plan_graph(g)
        grp = next(x for x in plan.groups if x.eligible)
        res = tuner.tune_group(plan, grp, device="cpu", repeats=1, warmup=0)
        assert not res.cache_hit and res.trials
        assert all(t.ok for t in res.trials)
        assert res.sequential_s > 0
        res2 = tuner.tune_group(plan, grp, device="cpu")
        assert res2.cache_hit and res2.merged == res.merged
        acc = executor.build(g, plan=plan, device="cpu", tune=8)
        assert acc.group_tuning[grp.name].cache_hit
        assert bool(acc.group_kernels) == res.merged
        acc.validate()

    def test_sequential_verdict_respected(self):
        g = chains.mlp_graph(l=24, d=16, f=40)
        plan = plan_graph(g)
        grp = next(x for x in plan.groups if x.eligible)
        digest = cache.key_of(pipeline._group_cache_key(plan, grp, "cpu"))
        cache.store_group(digest, merged=False, merged_s=2.0,
                          sequential_s=1.0)
        assert pipeline.lower_group(plan, grp, device="cpu") is None
        assert pipeline.lower_group(plan, grp, device="cpu",
                                    tuned=False) is not None
        acc = executor.build(g, plan=plan, device="cpu")
        assert not acc.group_kernels
        assert "tuned cache verdict" in acc.describe()
        acc.validate()

    def test_merged_verdict_supplies_knobs(self):
        g = chains.mlp_graph(l=24, d=16, f=40)
        plan = plan_graph(g)
        grp = next(x for x in plan.groups if x.eligible)
        digest = cache.key_of(pipeline._group_cache_key(plan, grp, "cpu"))
        cache.store_group(digest, merged=True, bm=24, interleave="stage",
                          merged_s=1.0, sequential_s=2.0)
        pipeline.cache_clear()          # a fresh process: nothing lowered
        gk = pipeline.lower_group(plan, grp, device="cpu")
        assert (gk.source, gk.bm, gk.interleave) == ("tuned", 24, "stage")
        assert (gk.measured_s, gk.sequential_s) == (1.0, 2.0)

    def test_dag_group_merges_on_one_draw_per_edge(self):
        g = from_model.layer_graph_from_config(
            get_config("h2o-danube-1.8b").reduced(), l=16)
        acc = executor.build(g, device="cpu", tune=8, validate=False)
        (res,) = acc.group_tuning.values()
        (trial,) = res.trials
        assert trial.ok, trial.error        # gated against one x
        assert trial.variant.interleave == "dag"
        assert ("tuner verdict" in acc.describe()) != res.merged
        ops_ = {e: torch.as_tensor(v, dtype=torch.float32) for e, v in
                g.random_operands(0).items()}
        seq = executor.build(g, device="cpu", merge=False, validate=False)
        want = seq(ops_)
        torch.testing.assert_close(acc(ops_), want, rtol=0,
                                   atol=1e-5 * want.abs().max().item())

    def test_ineligible_group_rejected(self):
        g = chains.mlp_graph(l=24, d=16, f=40)
        plan = plan_graph(g, cfg=ArrayConfig(strip_budget_bytes=64))
        grp = next(x for x in plan.groups if not x.eligible)
        with pytest.raises(ValueError, match="not merged-eligible"):
            tuner.tune_group(plan, grp, device="cpu")


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------

class TestCalibration:
    def test_fit_scales(self):
        cal = calibrate.fit([
            {"template": "os", "algebra": "a",
             "model_cycles": 100.0, "measured_cycles": 200.0},
            {"template": "os", "algebra": "b",
             "model_cycles": 100.0, "measured_cycles": 800.0},
        ])
        assert cal.scale_for("os", "a") == pytest.approx(2.0)
        assert cal.scale_for("os", "b") == pytest.approx(8.0)
        assert cal.scale_for("os", "zz") == pytest.approx(4.0)
        assert cal.scale_for("unknown") == 1.0

    def test_bad_records_skipped_and_scales_positive(self):
        cal = calibrate.fit([
            {"template": "t", "algebra": "a",
             "model_cycles": 0.0, "measured_cycles": 5.0},
            {"template": "t", "algebra": "a",
             "model_cycles": -3.0, "measured_cycles": 5.0},
            {"template": "t", "algebra": "a", "model_cycles": float("nan"),
             "measured_cycles": 5.0},
            {"template": "t"},                     # missing fields
        ])
        assert not cal
        assert cal.scale_for("t", "a") == 1.0
        ext = calibrate.fit([{"template": "t", "algebra": "a",
                              "model_cycles": 1e30,
                              "measured_cycles": 1e-30}])
        assert ext.scale_for("t", "a") > 0.0

    def test_calibrated_model_positive_and_flagged(self):
        alg = small_gemm()
        df = pipeline.default_dataflow(alg)
        cal = calibrate.Calibration(per_template={"output_stationary": 3.0})
        base = PaperCycleModel().evaluate(alg, df)
        rep = PaperCycleModel(calibration=cal).evaluate(alg, df)
        assert rep.calibrated and not base.calibrated
        assert rep.cycles == pytest.approx(3.0 * base.cycles)
        assert rep.cycles > 0
        assert rep.normalized_perf == pytest.approx(
            rep.macs / rep.peak_macs)

    def test_calibration_requires_scale_for(self):
        with pytest.raises(TypeError):
            PaperCycleModel(calibration=object())

    def test_uniform_calibration_preserves_ranking(self):
        alg = batched_gemv(4, 16, 16)
        plain = dse.search(alg, top_k=0)
        cal = calibrate.Calibration(per_template={
            t: 2.5 for t in ("output_stationary", "operand_stationary",
                             "reduction_tree", "streaming")})
        scaled = dse.search(alg, top_k=0, calibration=cal)
        key = lambda p: (p[1].selected, p[1].signature)  # noqa: E731
        assert [key(p) for p in scaled] == [key(p) for p in plain]
        assert all(p[0].calibrated for p in scaled)

    def test_calibrated_search_is_permutation(self):
        alg = batched_gemv(4, 16, 16)
        plain = dse.search(alg, top_k=0)
        cal = calibrate.fit([
            {"template": "output_stationary", "algebra": alg.name,
             "model_cycles": 1.0, "measured_cycles": 250.0},
            {"template": "reduction_tree", "algebra": alg.name,
             "model_cycles": 1.0, "measured_cycles": 40.0},
        ])
        scaled = dse.search(alg, top_k=0, calibration=cal)
        key = lambda p: (p[1].selected, p[1].signature)  # noqa: E731
        assert sorted(map(key, scaled)) == sorted(map(key, plain))

    def test_record_persists_and_reloads(self):
        calibrate.record("output_stationary", "gemm", 1000.0, 250000.0)
        cal = calibrate.load()
        assert (cal.scale_for("output_stationary", "gemm") ==
                pytest.approx(250.0))
        calibrate.record("output_stationary", "gemm", 1000.0, 500000.0)
        assert calibrate.load().scale_for(
            "output_stationary", "gemm") == pytest.approx(500.0)

    def test_tune_records_calibration_within_2x(self):
        alg = small_gemm()
        res = tuner.tune(alg, search=1, **FAST)
        cal = calibrate.load()
        scale = cal.scale_for(res.kernel.template, alg.name)
        predicted = res.kernel.cost_report().cycles * scale
        measured = res.tuned_s * ArrayConfig().freq_mhz * 1e6
        assert 0.5 <= predicted / measured <= 2.0
        (rec,) = calibrate.load_records()
        assert rec["meta"]["device"] == "cpu"
        assert rec["meta"]["dtype"] == "float32"

    def test_fit_matches_reference(self):
        rng = np.random.default_rng(3)
        records = [{"template": t, "algebra": a,
                    "model_cycles": float(rng.uniform(1, 1e4)),
                    "measured_cycles": float(rng.uniform(1, 1e7))}
                   for t in ("output_stationary", "reduction_tree")
                   for a in ("gemm", "conv2d", "ttmc")
                   for _ in range(2)]
        records.append({"template": "x", "algebra": "y",
                        "model_cycles": 0.0, "measured_cycles": 1.0})
        got, want = calibrate.fit(records), rcalibrate.fit(records)
        assert dict(got.per_template) == dict(want.per_template)
        assert dict(got.anchors) == dict(want.anchors)


# ---------------------------------------------------------------------------
# Kernel knobs (grid order / accumulation strategy)
# ---------------------------------------------------------------------------

class TestKnobs:
    @pytest.mark.parametrize("grid_order, accum", [
        ("default", "auto"), ("default", "inplace"),
        ("nmk", "auto"), ("nmk", "inplace"),
        # k-outer orders revisit the output block: inplace only
        ("kmn", "inplace"), ("knm", "inplace"),
    ])
    def test_os_variants_match(self, grid_order, accum):
        rng = np.random.default_rng(0)
        a = torch.as_tensor(rng.integers(-4, 5, (32, 24)), dtype=torch.float32)
        b = torch.as_tensor(rng.integers(-4, 5, (24, 16)), dtype=torch.float32)
        got = ops.stt_matmul(a, b, template="output_stationary",
                             bm=8, bn=8, bk=8, device="cpu",
                             grid_order=grid_order, accum=accum)
        torch.testing.assert_close(got, a @ b, rtol=1e-5, atol=0)

    def test_scratch_rejects_k_outer(self):
        a = torch.zeros((8, 8))
        with pytest.raises(ValueError, match="scratch"):
            ops.stt_matmul(a, a, template="output_stationary",
                           bm=4, bn=4, bk=4, device="cpu",
                           grid_order="kmn", accum="scratch")

    def test_rt_grid_orders_match(self):
        rng = np.random.default_rng(1)
        a = torch.as_tensor(rng.integers(-4, 5, (16, 16)), dtype=torch.float32)
        b = torch.as_tensor(rng.integers(-4, 5, (16, 16)), dtype=torch.float32)
        for order in ("default", "nm", "nmk"):
            got = ops.stt_matmul(a, b, template="reduction_tree",
                                 bm=8, bn=8, device="cpu", grid_order=order)
            torch.testing.assert_close(got, a @ b, rtol=1e-5, atol=0)

    def test_resolve_accum(self):
        assert ops.resolve_accum("auto", torch.float32) == "scratch"
        assert ops.resolve_accum("auto", torch.bfloat16) == "scratch"
        assert ops.resolve_accum("inplace", torch.float32) == "inplace"
        with pytest.raises(ValueError):
            ops.resolve_accum("bogus", torch.float32)

    def test_variant_key_distinguishes_knobs(self):
        alg = small_gemm()
        df = pipeline.default_dataflow(alg)
        k1 = pipeline.lower(alg, df, device="cpu", validate=False,
                            tuned=False)
        k2 = pipeline.lower(alg, df, device="cpu", validate=False,
                            grid_order="kmn", accum="inplace")
        assert k1 is not k2
        assert k1.grid_order == "default" and k2.grid_order == "kmn"
        k3 = pipeline.lower(alg, df, device="cpu", validate=False,
                            grid_order="kmn", accum="inplace")
        assert k3 is k2


# ---------------------------------------------------------------------------
# BENCH_tune.json schema
# ---------------------------------------------------------------------------

def _valid_doc(mod=report):
    cell = mod.cell_entry(
        cell="tune_gemm", algebra="gemm", dataflow="MNK-MMT",
        template="output_stationary",
        variant={"blocks": (64, 64, 64), "grid_order": "kmn",
                 "accum": "inplace"},
        model_cycles=1024.0, calibrated_cycles=170000.0,
        measured_cycles=171000.0, untuned_s=1e-3, tuned_s=5e-4,
        tune_cache_hit=False)
    return {
        "version": mod.BENCH_SCHEMA_VERSION,
        "smoke": True, "interpret": True, "cells": [cell],
        "calibration": {
            "per_template": {"output_stationary": 170.0},
            "anchors": [{"template": "output_stationary",
                         "algebra": "gemm", "scale": 170.0}],
        },
    }


MUTATIONS = [
    (lambda d: d.update(version=99), "version"),
    (lambda d: d.pop("smoke"), "smoke"),
    (lambda d: d.update(cells=[]), "cells"),
    (lambda d: d["cells"][0].pop("speedup"), "speedup"),
    (lambda d: d["cells"][0]["variant"].update(blocks=[0, 1]), "blocks"),
    (lambda d: d["calibration"]["per_template"].update(x=-1.0),
     "per_template"),
    (lambda d: d["calibration"]["anchors"].append({"bad": 1}), "anchors"),
]


class TestBenchSchema:
    def test_valid_doc_passes(self):
        assert report.validate_bench(_valid_doc()) == []

    @pytest.mark.parametrize("mutate, frag", MUTATIONS)
    def test_mutations_rejected(self, mutate, frag):
        doc = _valid_doc()
        mutate(doc)
        errors = report.validate_bench(doc)
        assert errors and any(frag in e for e in errors), errors

    def test_speedup_computed(self):
        cell = _valid_doc()["cells"][0]
        assert cell["speedup"] == pytest.approx(2.0)

    @pytest.mark.parametrize("i", range(len(MUTATIONS)))
    def test_validate_bench_matches_reference(self, i):
        mutate = MUTATIONS[i][0]
        doc, rdoc = _valid_doc(), _valid_doc(rreport)
        assert doc == rdoc
        mutate(doc)
        mutate(rdoc)
        assert report.validate_bench(doc) == rreport.validate_bench(rdoc)
