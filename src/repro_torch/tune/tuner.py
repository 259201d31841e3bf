"""The measurement-driven autotuner.

The port of the reference's ``tune/tuner.py``.  The analytical pipeline
ranks designs with ``PaperCycleModel`` and picks block sizes with the
shared tile chooser — first-principles models the card disagrees with.
``tune()`` closes the gap:

    1. take the top-``search`` candidates from the analytical ranking
       (``core.dse.search`` — blocks x template x dataflow x partition),
    2. expand each into kernel *variants* over the measured-tuning knobs
       (block sizes, contraction grid order, accumulation strategy) —
       the reference's grid, candidate for candidate, so both packages
       build the same trial lists,
    3. time every variant with the shared harness
       (``measure.measure``: warmup + median-of-k, synchronized),
       validating each against the untuned kernel's output,
    4. persist the winner in the on-disk tuning cache keyed exactly like
       the compile cache — so later ``lower()``/``generate()`` calls in
       *any* process pick it up without re-measuring, and
    5. feed the winner's measurement into the calibration fit
       (``calibrate.record``) so the cost model's predictions track the
       card.

The untuned analytical variant is always trial #0, so the tuned pick is
never slower than untuned *by construction*.

Operands are made once per call, on the tuner's device and in the
kernel's dtype, and every output is compared there: a trial times the
kernel, not a host-to-device copy.  A trial fails only on a knob the
templates reject (``ValueError``) or on an output outside the gate; a
CUDA launch error propagates, because after one the context is unusable
and no later trial could be trusted.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..compile import pipeline
from ..core import dse, linalg, stt as stt_mod
from ..core.algebra import TensorAlgebra
from ..core.stt import Dataflow
from ..core.tiling import ArrayConfig
from ..kernels import stt_gemm as _gemm
from ..kernels.ops import resolve_device
from . import cache as _cache
from . import calibrate as _calibrate
from .measure import DEFAULT_REPEATS, DEFAULT_WARMUP, Measurement, measure

#: trial-count ceiling (variants per tune() call, across all candidate
#: dataflows); the knob grid is pruned to fit
DEFAULT_MAX_TRIALS = 32

#: relative-error gates for validating a variant against the untuned
#: kernel's output (integer random operands make fp32 exact; bf16
#: in-place accumulation is allowed its rounding, and is rejected when
#: it exceeds the gate)
_REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 2e-2}


@dataclasses.dataclass(frozen=True)
class Variant:
    """One point in the kernel-knob space the tuner searches."""

    blocks: Tuple[int, int, int]
    grid_order: str = "default"
    accum: str = "auto"


@dataclasses.dataclass(frozen=True)
class Trial:
    """One measured (or rejected) variant of one candidate dataflow."""

    dataflow_name: str
    variant: Variant
    measurement: Optional[Measurement]   # None when the variant failed
    ok: bool
    error: str = ""

    @property
    def median_s(self) -> float:
        return self.measurement.median_s if self.measurement else float("inf")


@dataclasses.dataclass
class TuneResult:
    """What a ``tune()`` call produced.

    ``kernel`` is lowered with the winning variant (``source == "tuned"``);
    ``untuned_s`` is the analytical pick's measured median, ``tuned_s``
    the winner's, so ``speedup`` is a same-call apples-to-apples
    ratio.  ``cache_hit`` means the on-disk choice cache answered and no
    measurement ran (``trials`` is empty).
    """

    kernel: pipeline.CompiledKernel
    dataflow: Dataflow
    variant: Variant
    tuned_s: Optional[float]
    untuned_s: Optional[float]
    cache_hit: bool
    trials: Tuple[Trial, ...] = ()

    @property
    def speedup(self) -> Optional[float]:
        if self.tuned_s and self.untuned_s:
            return self.untuned_s / self.tuned_s
        return None


def _t_rows(T: linalg.Mat) -> List[List[int]]:
    return [[int(v) for v in row] for row in T]


def _clamp_blocks(blocks: Tuple[int, int, int], dims: Tuple[int, int, int]
                  ) -> Tuple[int, int, int]:
    return tuple(max(1, min(b, d)) for b, d in zip(blocks, dims))


def block_candidates(analytical: Tuple[int, int, int],
                     dims: Tuple[int, int, int]
                     ) -> List[Tuple[int, int, int]]:
    """Block-size candidates around the analytical pick: the pick itself
    (trial #0's variant), hardware-friendly clamps (128/256), the full
    problem capped at 512, and the pick doubled.  Deduped, analytical
    first."""
    cands = [
        analytical,
        _clamp_blocks((128, 128, 128), dims),
        _clamp_blocks((256, 256, 256), dims),
        _clamp_blocks((512, 512, 512), dims),
        _clamp_blocks(tuple(b * 2 for b in analytical), dims),
    ]
    out: List[Tuple[int, int, int]] = []
    for c in cands:
        c = _clamp_blocks(c, dims)
        if c not in out:
            out.append(c)
    return out


def _knob_grid(template: str) -> List[Tuple[str, str]]:
    """(grid_order, accum) combos valid for a template — the analytical
    default first, so trial #0 is exactly the untuned kernel."""
    if template == "output_stationary":
        combos = [("default", "auto")]
        combos += [(o, "scratch") for o in _gemm.OS_GRID_ORDERS
                   if o != "mnk"]          # "default" == mnk + scratch
        combos += [(o, "inplace") for o in _gemm.OS_GRID_ORDERS]
        return combos
    if template in ("reduction_tree", "streaming"):
        return [("default", "auto")] + [
            (o, "auto") for o in _gemm.RT_GRID_ORDERS if o != "mn"]
    # operand_stationary has a fixed streaming order; only blocks vary
    return [("default", "auto")]


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs error over the largest magnitude, computed in float64
    where the tensors lie (``want`` is float64 already)."""
    if tuple(got.shape) != tuple(want.shape):
        return float("inf")
    if want.numel() == 0:
        return 0.0
    scale = want.abs().max().item()
    err = (got.to(torch.float64) - want).abs().max().item()
    return err / (scale + 1e-30)


def _on_device(arrays: Dict[str, np.ndarray], dtype: torch.dtype,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """Operands made once for every trial: on ``device``, in ``dtype``."""
    return {k: torch.as_tensor(v, device=device).to(dtype)
            for k, v in arrays.items()}


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def _lower_kwargs(cfg, dtype, device) -> Dict:
    return dict(cfg=cfg, dtype=dtype, device=device)


def tune(alg: TensorAlgebra, dataflow: Optional[Dataflow] = None, *,
         search: int = 4,
         cfg: ArrayConfig = ArrayConfig(),
         dtype: torch.dtype = torch.float32,
         device=None,
         repeats: int = DEFAULT_REPEATS,
         warmup: int = DEFAULT_WARMUP,
         force: bool = False,
         validate: Optional[bool] = None,
         max_trials: int = DEFAULT_MAX_TRIALS,
         seed: int = 0) -> TuneResult:
    """Measure-and-pick: the best (dataflow, variant) for ``alg`` on
    ``device`` (the card by default), persisted for later processes.

    ``dataflow`` pins the schedule (only kernel variants are searched);
    otherwise the top-``search`` analytical candidates from
    ``dse.search`` each contribute variants.  ``force=True`` bypasses the
    on-disk choice cache and re-measures.  ``validate`` controls the
    *oracle* validation of the final kernel (default: auto, small
    problems only); every trial is always gated on matching the untuned
    kernel's output.
    """
    device = resolve_device(device)
    lkw = _lower_kwargs(cfg, dtype, device)
    shape_key = _cache.shape_key_for(alg, cfg, dtype, device)

    if not force:
        choice = _cache.lookup_choice(shape_key)
        if choice is not None:
            df = stt_mod.apply_stt(alg, tuple(choice["selected"]),
                                   linalg.mat(choice["T"]))
            if dataflow is None or df.signature == dataflow.signature:
                v = choice["variant"]
                # no explicit knobs: lower() consults the variant cache
                # itself, so the kernel comes back source == "tuned"
                kernel = pipeline.lower(alg, df, validate=validate, **lkw)
                variant = Variant(tuple(v["blocks"]), v["grid_order"],
                                  v["accum"])
                return TuneResult(
                    kernel=kernel, dataflow=df, variant=variant,
                    tuned_s=v.get("measured_s"),
                    untuned_s=v.get("untuned_s"),
                    cache_hit=True, trials=())

    if dataflow is not None:
        pairs = [(None, dataflow)]
    else:
        pairs = dse.search(alg, top_k=max(1, search), cfg=cfg)

    operands = _on_device(alg.random_operands(seed), dtype, device)
    tol = _REL_TOL.get(pipeline._dtype_name(dtype), 2e-2)

    # --- trial #0: the untuned analytical pick (top-1 candidate) --------
    untuned_df = pairs[0][1]
    untuned_kernel = pipeline.lower(alg, untuned_df, validate=validate,
                                    tuned=False, **lkw)
    ref_out = untuned_kernel(operands).to(torch.float64)
    untuned_meas = measure(untuned_kernel, operands,
                           warmup=warmup, repeats=repeats)
    trials: List[Trial] = [Trial(
        dataflow_name=untuned_df.name,
        variant=Variant(untuned_kernel.blocks, "default", "auto"),
        measurement=untuned_meas, ok=True)]
    best = (untuned_meas.median_s, untuned_df, trials[0].variant,
            untuned_kernel)

    # --- the variant sweep ---------------------------------------------
    for _, df in pairs:
        if len(trials) > max_trials:
            break
        base = pipeline.lower(alg, df, validate=False, tuned=False, **lkw)
        dims = (base.form.m, base.form.n, base.form.k)
        for blocks in block_candidates(base.blocks, dims):
            for grid_order, accum in _knob_grid(base.template):
                variant = Variant(blocks, grid_order, accum)
                if df is untuned_df and variant == trials[0].variant:
                    continue            # already measured as trial #0
                if len(trials) > max_trials:
                    break
                try:
                    k = pipeline.lower(alg, df, validate=False,
                                       blocks=blocks, grid_order=grid_order,
                                       accum=accum, **lkw)
                    err = _rel_err(k(operands), ref_out)
                except ValueError as e:   # a knob the templates reject
                    trials.append(Trial(df.name, variant, None, False,
                                        f"{type(e).__name__}: {e}"))
                    continue
                if err > tol:
                    trials.append(Trial(df.name, variant, None, False,
                                        f"rel err {err:.3e} > {tol}"))
                    continue
                meas = measure(k, operands, warmup=warmup, repeats=repeats)
                trials.append(Trial(df.name, variant, meas, True))
                if meas.median_s < best[0]:
                    best = (meas.median_s, df, variant, k)
    del operands, ref_out

    tuned_s, win_df, win_variant, win_kernel = best

    # --- calibration: anchor the cost model on the winner's measurement
    # (newest record per (template, algebra) supersedes older ones); the
    # unit is cycles of the model's clock, cfg.freq_mhz
    _calibrate.record(
        win_kernel.template, alg.name, win_kernel.cost_report().cycles,
        tuned_s * cfg.freq_mhz * 1e6,
        meta={"device": _device_name(device),
              "dtype": pipeline._dtype_name(dtype),
              "dataflow": win_df.name})

    # --- persist: variant under the compile key, choice per algebra ----
    base_key = pipeline._cache_key(alg, win_df, cfg, dtype, device)
    entry = _cache.store_variant(
        _cache.key_of(base_key), blocks=win_variant.blocks,
        grid_order=win_variant.grid_order, accum=win_variant.accum,
        measured_s=tuned_s, untuned_s=untuned_meas.median_s,
        meta={"algebra": alg.name, "dataflow": win_df.name,
              "template": win_kernel.template})
    _cache.store_choice(
        shape_key, selected=win_df.selected, T=_t_rows(win_df.T),
        variant=entry, dataflow_name=win_df.name)

    # label the winner with its measurement (the compile cache shares the
    # object, so later lower() hits in this process see it too)
    win_kernel.source = "tuned"
    win_kernel.measured_s = tuned_s
    if validate and not win_kernel.validated:
        # trials only gate on matching the untuned output; an explicit
        # validate=True also runs the winner against the python oracle
        win_kernel.validate()

    return TuneResult(
        kernel=win_kernel, dataflow=win_df, variant=win_variant,
        tuned_s=tuned_s, untuned_s=untuned_meas.median_s,
        cache_hit=False, trials=tuple(trials))


# ---------------------------------------------------------------------------
# Merged-group tuning — megakernel vs sequential dispatch
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GroupVariant:
    """One point in the merged-kernel knob space: the m-block ladder
    step and the stage interleave order (``kernels/fused_chain.py``)."""

    bm: int
    interleave: str = "chain"


@dataclasses.dataclass(frozen=True)
class GroupTrial:
    """One measured (or rejected) merged variant of one fused group."""

    variant: GroupVariant
    measurement: Optional[Measurement]   # None when the variant failed
    ok: bool
    error: str = ""

    @property
    def median_s(self) -> float:
        return self.measurement.median_s if self.measurement else float("inf")


@dataclasses.dataclass
class GroupTuneResult:
    """What a ``tune_group()`` call decided for one fused group.

    ``merged`` is the verdict: the best megakernel variant measured
    faster than sequential per-node dispatch.  ``kernel`` carries the
    winning :class:`~repro_torch.compile.pipeline.CompiledGroupKernel`
    when merged won, None when sequential did (the executor then keeps
    per-node dispatch).  The verdict persists in the on-disk tuning
    cache, so a later ``build()``/``generate()`` in any process honors
    it without re-measuring (``cache_hit``).
    """

    group: str
    kernel: Optional[pipeline.CompiledGroupKernel]
    merged: bool
    variant: Optional[GroupVariant]
    merged_s: Optional[float]
    sequential_s: Optional[float]
    cache_hit: bool
    trials: Tuple[GroupTrial, ...] = ()

    @property
    def speedup(self) -> Optional[float]:
        """Sequential over merged median — >1 means the megakernel won."""
        if self.merged_s and self.sequential_s:
            return self.sequential_s / self.merged_s
        return None


def group_bm_candidates(group) -> List[int]:
    """m-block ladder for a merged chain: the plan's agreed bm (trial
    #0), hardware-friendly 128/256 clamps, and the whole-m degenerate
    single-phase case.  Deduped, agreed-first."""
    m = group.m
    cands = [group.bm, min(128, m), min(256, m), m]
    out: List[int] = []
    for bm in cands:
        bm = max(1, min(int(bm), m))
        if bm not in out:
            out.append(bm)
    return out


def _group_operands(group, seed: int):
    """Random integer operands in the group's external layout (lhs
    ``(m, k0)``, per-stage weights in gemm storage ``(n, k)``, rank-1
    biases) — integers keep fp32 stage dots exact, same rationale as
    ``TensorAlgebra.random_operands``."""
    rng = np.random.default_rng(seed)
    lhs = rng.integers(-4, 5, size=(group.m, group.k0))
    rhss = [rng.integers(-4, 5, size=(st.n, st.k)) for st in group.chain]
    biases = [rng.integers(-4, 5, size=(st.n,))
              for st in group.chain if st.has_bias]
    return lhs, rhss, biases


def _dag_operands(plan, group, seed: int) -> List[np.ndarray]:
    """Random integer operands for a ``kind="dag"`` group, one per
    ``ext_inputs`` slot — and ONE draw per distinct edge, fed to every
    role the edge plays (the danube layer reads ``x`` as lhs, rhs and
    residual).  The sequential baseline keys its values by edge, so
    drawing per slot, as the reference does, hands the merged kernel
    other operands than the baseline it is gated against."""
    rng = np.random.default_rng(seed)
    drawn: Dict[str, np.ndarray] = {}
    for e, _ in group.ext_inputs:
        if e not in drawn:
            drawn[e] = rng.integers(-4, 5, size=plan.graph.edge_shape(e))
    return [drawn[e] for e, _ in group.ext_inputs]


def _member_kernels(plan, group, device):
    """The group's member nodes lowered exactly as
    ``graph.executor.build(..., merge=False)`` lowers them."""
    from ..graph.executor import bias_operand_key
    from ..kernels import epilogue as epilogue_mod
    stages = []
    for name in group.stages:
        p = plan.nodes[name]
        fused_ep = p.epilogue if p.epilogue_fused else ()
        bias_key = (bias_operand_key(p.bias_edge)
                    if (fused_ep and p.bias_edge is not None
                        and epilogue_mod.needs_bias(fused_ep)) else None)
        k = pipeline.lower(
            p.node.algebra, p.dataflow, cfg=plan.cfg,
            dtype=pipeline.torch_dtype(p.dtype), device=device,
            validate=False,
            blocks=p.blocks if p.blocks_constrained else None,
            epilogue=fused_ep, bias_tensor=bias_key,
            fused_group=plan.fused_group_for(name))
        stages.append((k, p))
    return stages


def _sequential_runner(plan, group, *, device):
    """The measured baseline: the group's member nodes, one template
    launch per stage, intermediates round-tripping as tensors — chained
    into one callable over the group's operands."""
    stages = _member_kernels(plan, group, device)

    def run(lhs, rhss, biases):
        x, bi = lhs, 0
        for i, (k, p) in enumerate(stages):
            a_name = p.node.algebra.inputs[0].name
            b_name = p.node.algebra.inputs[1].name
            ops = {a_name: x, b_name: rhss[i]}
            if k.bias_tensor is not None:
                ops[k.bias_tensor] = biases[bi]
                bi += 1
            x = k(ops)
        return x

    return run


def _sequential_dag_runner(plan, group, *, device):
    """Sequential baseline for a ``kind="dag"`` group: the members run
    one template launch each (as ``build(merge=False)`` would), values
    memoized by edge name, folded residuals added after the kernel in
    fp32; returns ``(result, *taps)`` to mirror the merged kernel's
    outputs."""
    stages = _member_kernels(plan, group, device)
    f32 = torch.float32

    def run(exts):
        values = {e: torch.as_tensor(v, device=device)
                  for (e, _), v in zip(group.ext_inputs, exts)}
        for k, p in stages:
            node = p.node
            ops = {t.name: values[e]
                   for t, e in zip(node.algebra.inputs, node.inputs)}
            if k.bias_tensor is not None:
                ops[k.bias_tensor] = values[p.bias_edge]
            out = k(ops)
            if p.residual_edge is not None:
                out = (out.to(f32) + values[p.residual_edge].to(f32)
                       ).to(k.dtype)
            values[p.result_edge] = out
        return (values[group.result_edge],
                *(values[e] for _, e in group.taps))

    return run


def tune_group(plan, group, *,
               device=None,
               repeats: int = DEFAULT_REPEATS,
               warmup: int = DEFAULT_WARMUP,
               force: bool = False,
               max_trials: int = DEFAULT_MAX_TRIALS,
               seed: int = 0) -> GroupTuneResult:
    """Measure merged-megakernel variants against sequential per-node
    dispatch for one fused group on ``device`` (the card by default),
    and persist whichever wins.

    Knobs: the m-block ladder (``group_bm_candidates``) crossed with the
    stage interleave orders (``fused_chain.FUSED_INTERLEAVES``), capped
    at ``max_trials``; a DAG group has one whole-tensor variant.  Every
    variant is gated on matching the sequential baseline's output before
    it may be timed.  ``force=True`` bypasses the on-disk group cache
    and re-measures.
    """
    if not group.eligible:
        raise ValueError(f"group {group.name} is not merged-eligible: "
                         f"{group.reason}")
    from ..kernels.fused_chain import DAG_INTERLEAVE, FUSED_INTERLEAVES
    device = resolve_device(device)
    digest = _cache.key_of(pipeline._group_cache_key(plan, group, device))

    if not force:
        entry = _cache.lookup_group(digest)
        if entry is not None:
            # no explicit knobs: lower_group re-consults the cache, so a
            # merged winner comes back source == "tuned" and a
            # sequential verdict comes back None
            kernel = pipeline.lower_group(plan, group, device=device)
            variant = (GroupVariant(entry["bm"], entry["interleave"])
                       if entry["merged"] else None)
            return GroupTuneResult(
                group=group.name, kernel=kernel, merged=entry["merged"],
                variant=variant, merged_s=entry.get("merged_s"),
                sequential_s=entry.get("sequential_s"),
                cache_hit=True, trials=())

    dtype = pipeline.torch_dtype(group.dtype)
    tol = _REL_TOL.get(pipeline._dtype_name(dtype), 2e-2)
    is_dag = getattr(group, "kind", "chain") == "dag"

    def dev(a):
        return torch.as_tensor(a, device=device).to(dtype)

    # --- the baseline merging must beat: sequential dispatch -----------
    if is_dag:
        exts = [dev(a) for a in _dag_operands(plan, group, seed)]
        args = (exts,)
        seq = _sequential_dag_runner(plan, group, device=device)
    else:
        lhs, rhss, biases = _group_operands(group, seed)
        args = (dev(lhs), [dev(r) for r in rhss],
                [torch.as_tensor(b, device=device).to(torch.float32)
                 for b in biases])
        seq = _sequential_runner(plan, group, device=device)
    ref = seq(*args)
    refs = [o.to(torch.float64) for o in (ref if is_dag else (ref,))]
    seq_meas = measure(seq, *args, warmup=warmup, repeats=repeats)

    # --- the merged-variant sweep --------------------------------------
    # the stage-major dag template has no block/interleave ladder: one
    # whole-tensor variant, measured against the same gate
    variants = ([GroupVariant(group.m, DAG_INTERLEAVE)] if is_dag else
                [GroupVariant(bm, il) for bm in group_bm_candidates(group)
                 for il in FUSED_INTERLEAVES][:max_trials])
    trials: List[GroupTrial] = []
    best: Optional[Tuple[float, GroupVariant,
                         pipeline.CompiledGroupKernel]] = None
    for variant in variants:
        try:
            k = pipeline.lower_group(
                plan, group, device=device, validate=False,
                bm=variant.bm, interleave=variant.interleave)
            got = k(*args)
        except ValueError as e:           # a knob the kernel rejects
            trials.append(GroupTrial(variant, None, False,
                                     f"{type(e).__name__}: {e}"))
            continue
        err = max(_rel_err(g_, r_) for g_, r_ in
                  zip(got if is_dag else (got,), refs))
        if err > tol:
            trials.append(GroupTrial(variant, None, False,
                                     f"rel err {err:.3e} > {tol}"))
            continue
        meas = measure(k, *args, warmup=warmup, repeats=repeats)
        trials.append(GroupTrial(variant, meas, True))
        if best is None or meas.median_s < best[0]:
            best = (meas.median_s, variant, k)
    del args, ref, refs

    meta = {"group": group.name, "stages": list(group.stages),
            "device": _device_name(device)}
    merged = best is not None and best[0] < seq_meas.median_s
    if merged:
        merged_s, win_variant, win_kernel = best
        win_kernel.source = "tuned"
        win_kernel.measured_s = merged_s
        win_kernel.sequential_s = seq_meas.median_s
        _cache.store_group(
            digest, merged=True, bm=win_variant.bm,
            interleave=win_variant.interleave, merged_s=merged_s,
            sequential_s=seq_meas.median_s, meta=meta)
        return GroupTuneResult(
            group=group.name, kernel=win_kernel, merged=True,
            variant=win_variant, merged_s=merged_s,
            sequential_s=seq_meas.median_s, cache_hit=False,
            trials=tuple(trials))

    _cache.store_group(
        digest, merged=False,
        merged_s=best[0] if best else None,
        sequential_s=seq_meas.median_s, meta=meta)
    return GroupTuneResult(
        group=group.name, kernel=None, merged=False, variant=None,
        merged_s=best[0] if best else None,
        sequential_s=seq_meas.median_s, cache_hit=False,
        trials=tuple(trials))


def rank_measured(alg: TensorAlgebra,
                  pairs: Sequence[Tuple[object, Dataflow]], *,
                  cfg: ArrayConfig = ArrayConfig(),
                  dtype: torch.dtype = torch.float32,
                  device=None,
                  repeats: int = DEFAULT_REPEATS,
                  warmup: int = DEFAULT_WARMUP,
                  seed: int = 0
                  ) -> List[Tuple[object, Dataflow, float]]:
    """Re-rank ``(report, dataflow)`` candidates by *measured* wall clock.

    Each candidate is lowered with its analytical variant and timed with
    the shared harness; the result is a permutation of the input pairs
    (nothing added, nothing dropped) extended with the measured median
    seconds — measurement reorders the analytical ranking, it never
    invents candidates."""
    device = resolve_device(device)
    operands = _on_device(alg.random_operands(seed), dtype, device)
    lkw = _lower_kwargs(cfg, dtype, device)
    timed = []
    for rep, df in pairs:
        kernel = pipeline.lower(alg, df, validate=False, tuned=False, **lkw)
        meas = measure(kernel, operands, warmup=warmup, repeats=repeats)
        timed.append((rep, df, meas.median_s))
    return sorted(timed, key=lambda t: t[2])
