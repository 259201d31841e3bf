"""Drive the PyTorch port's main path on one NVIDIA H100 and check it.

    python chip_smoke.py

Runs from the root of a checkout, on a machine with one CUDA card and
the CUDA toolkit (``nvcc`` for ``sm_90a``).  It imports the port
(``src/repro_torch``) and nothing of the JAX reference package.  Phases,
each of which fails the run (non-zero exit) when it fails:

1. no CUDA device -> exit 1 before anything else;
2. print the card (``nvidia-smi`` name, power limit) and build the CUDA
   kernels from ``src/repro_torch/csrc`` into the gitignored build dir
   (one ``nvcc`` per source, all started together);
3. the main path: ``repro_torch.generate(name, stt)`` ->
   ``Accelerator.__call__`` for every registry algebra x each named STT
   at full width (sizes in ``SIZES``), plus one bf16 gemm.  The kernels'
   launch counts are zeroed just before and read just after.  Each
   output is held against the plain PyTorch path on the same inputs:
   integer-valued fp32 operands in [-4, 4] keep every sum below 2^24 at
   these sizes, so the fp32 comparison is exact; the bf16 gemm is held
   to 2e-2 of the largest magnitude (the reference's bf16 tolerance);
4. the sparse front door: ``generate(name, sparsity=...)`` with a
   block-sparse operand (``SPARSE``: gemm 4096^3 with A sparse at
   density 0.25 and 1.0 and with B sparse, conv2d with sparse weights,
   mttkrp with A sparse), on the BSR kernel.  Each output equals the
   plain path exactly (integer operands); at density 1.0 the output is
   bit-identical to the dense output-stationary call on random-normal
   operands;
5. the whole-graph path at the full width of h2o-danube-1.8b
   (``generate(AlgebraGraph)`` -> ``GraphAccelerator``): (a) one layer at
   l = 512 under a 512 MiB budget, one merged DAG group on the fused-DAG
   kernel; (b) its MLP, one chain group on the fused-chain kernel; (c)
   the layer at l = 64 under the default budget, planned sequential onto
   the STT templates; (d) case (a) with ``merge=False``; and (a) in bf16.
   fp32 results are held to the plain path (and (a) to (d)) within
   1e-4 x max|out|: the sum order differs from cuBLAS and exp/tanh are
   other implementations; bf16 within 2e-2 x max|out|;
6. ``Accelerator.validate()`` (the loop-nest oracle) at small bounds for
   every algebra under the output- and weight-stationary STTs, which
   between them reach all three templates (``VALIDATE_STTS``);
7. fused epilogues (bias+gelu, softmax) on every template, against the
   numpy mirror (rtol 1e-5, atol 1e-5: fp32 vs fp64 transcendental
   rounding on exact integer sums);
8. an ``AcceleratorEngine`` answering mixed requests; repeat shapes on a
   second engine must hit the compile cache;
9. each kernel timed with CUDA events at a main-path shape beside its
   plain version, one PyTorch call computing the same function where
   there is one (``torch.matmul``; a yardstick the port never calls) and
   its roofline bound from ``core/hopper.py``; then every main-path,
   sparse and graph case timed end to end (host clock, 3 calls); the
   sparse and graph cases and one STT per dense algebra are traced
   once.

Prints the ``nvidia-smi`` line, one ``{"kernels": [...]}`` JSON line,
and, last, ``{"ok": true, "device": {...}}``.  Per-case times go to
``results/chip_smoke/chip_smoke_cases.json`` (gitignored), each with one
more call traced by ``torch.profiler``: the device time of the port's
kernels, of everything else on the device (layout copies, casts,
masks), and the device's busy share of the untraced call time.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / "results" / "chip_smoke"

SIZES = {
    "gemm": dict(m=4096, n=4096, k=4096),                 # projection
    "batched_gemv": dict(m=64, n=4096, k=4096),           # batch-64 decode
    "conv2d": dict(k=256, c=256, y=14, x=14, p=3, q=3),   # ResNet-50 conv4_x
    "depthwise_conv": dict(k=576, y=14, x=14, p=3, q=3),  # MobileNetV2 14x14
    "mttkrp": dict(i=1024, j=1024, k=64, l=64),
    "ttmc": dict(i=256, j=64, k=64, l=64, m=64),
}
SMALL = {
    "gemm": dict(m=32, n=48, k=40),
    "batched_gemv": dict(m=8, n=24, k=40),
    "conv2d": dict(k=16, c=4, y=6, x=7, p=3, q=3),
    "depthwise_conv": dict(k=12, y=6, x=5, p=3, q=3),
    "mttkrp": dict(i=20, j=24, k=6, l=5),
    "ttmc": dict(i=10, j=6, k=5, l=4, m=6),
}
STTS = ("identity", "output_stationary", "weight_stationary",
        "input_stationary")
#: the STTs validated against the pure-python loop-nest oracle (slow on
#: the host): output-stationary, operand-stationary and reduction-tree
#: templates all run under these two
VALIDATE_STTS = ("output_stationary", "weight_stationary")
KERNELS = {
    # template -> (replaced TPU kernel, main-path case timed)
    "output_stationary": ("src/repro/kernels/stt_gemm.py:193",
                          ("gemm", "output_stationary")),
    "operand_stationary": ("src/repro/kernels/stt_gemm.py:290",
                           ("gemm", "weight_stationary")),
    "reduction_tree": ("src/repro/kernels/stt_gemm.py:388",
                       ("batched_gemv", "weight_stationary")),
}
#: B-chunk depth of the square operand-stationary tile (StripL::KC in
#: csrc/stt_gemm.cu): the strip is read-modify-written once per chunk
WS_CHUNK_K = 128
#: sparse cases: (label, algebra, sparse tensor, its shape, block, density)
SPARSE = (
    ("gemm A d=0.25", "gemm", "A", (4096, 4096), (128, 128), 0.25),
    ("gemm A d=1.0", "gemm", "A", (4096, 4096), (128, 128), 1.0),
    ("gemm B d=0.25", "gemm", "B", (4096, 4096), (128, 128), 0.25),
    ("conv2d B d=0.25", "conv2d", "B", (256, 256, 3, 3), (64, 16, 3, 3),
     0.25),
    ("mttkrp A d=0.25", "mttkrp", "A", (1024, 64, 64), (128, 8, 64), 0.25),
)
#: the graph phase's model and merged-kernel budget
GRAPH_MODEL = "h2o-danube-1.8b"
GRAPH_BUDGET = 512 << 20
#: the port's kernels, by the names the profiler reports
OUR_KERNELS = ("os_kernel<", "ws_kernel<", "rt_kernel<", "bsr_kernel<",
               "stages_kernel<")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def profile_call(fn, call_ms: float):
    """One call under ``torch.profiler``: the device time of the template
    kernels and of everything else on the device, and their share of the
    unprofiled call time ``call_ms``.  The profiler's tracing of this
    card can come back without device events; those fields are then
    None (not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    ours = other = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if any(k in ev.key for k in OUR_KERNELS):
            ours += us / 1e3
        else:
            other += us / 1e3
    if ours == 0.0:
        return {"kernel_ms": None, "other_device_ms": None,
                "busy_share": None}
    return {"kernel_ms": ours, "other_device_ms": other,
            "busy_share": (ours + other) / call_ms}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    import repro_torch
    from repro_torch.compile import cache_info, lower
    from repro_torch.configs.registry import get_config
    from repro_torch.core import hopper, stt
    from repro_torch.core.algebra import Sparsity, get_algebra
    from repro_torch.core.tiling import ArrayConfig
    from repro_torch.graph import executor as graph_executor
    from repro_torch.graph import from_model
    from repro_torch.kernels import _build, bsr_gemm, fused_chain, ref, \
        stt_gemm
    from repro_torch.kernels.epilogue import apply_epilogue_np
    from repro_torch.models import chains
    from repro_torch.serve import AcceleratorEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)

    t_phase = [time.perf_counter()]
    phase_s = {}

    def phase(name):
        now = time.perf_counter()
        phase_s[name] = round(now - t_phase[0], 1)
        t_phase[0] = now

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(p.name for p in libs.values())})")
    for p in libs.values():
        log = p.with_name(p.name + ".log").read_text()
        (OUT_DIR / (p.stem + ".ptxas.log")).write_text(log)
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and not ln.strip().startswith(
                      "0 bytes stack frame, 0 bytes spill")]
        print(f"ptxas: {len(spills)} kernels with stack or spills")
    phase("build")
    gen = torch.Generator(device=dev).manual_seed(0)

    def int_operands(alg):
        return {t.name: torch.randint(-4, 5, alg.tensor_shape(t),
                                      generator=gen, device=dev,
                                      dtype=torch.float32)
                for t in alg.inputs}

    def plain_path(acc, ops):
        k = acc.kernel
        lhs, rhs = k.form.prepare(k.cast_operands(ops))
        return k.form.finish(ref.matmul_ref(lhs, rhs, out_dtype=k.dtype))

    def sync_time(fn, reps=1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) / reps * 1e3

    # -- 3. the main path -------------------------------------------------
    errs = {name: 0.0 for name in stt_gemm.launches}
    cases = []
    stt_gemm.reset_launches()
    for name, bounds in SIZES.items():
        alg = get_algebra(name, **bounds)
        ops = int_operands(alg)
        for s in STTS:
            before = dict(stt_gemm.launches)
            acc = repro_torch.generate(name, s, bounds=bounds,
                                       validate=False)
            out, ms = sync_time(lambda: acc(ops))
            ran = [t for t in before if stt_gemm.launches[t] > before[t]]
            cases.append(dict(algebra=name, stt=s, template=acc.template,
                              blocks=acc.kernel.blocks, kernels=ran,
                              shape=list(out.shape), first_call_ms=ms))
            want = plain_path(acc, ops)
            check(out.shape == want.shape and bool(torch.isfinite(out).all()),
                  f"{name} x {s}: shape {tuple(out.shape)} or non-finite")
            check(torch.equal(out, want),
                  f"{name} x {s}: kernel output differs from the plain "
                  f"path (max err {(out - want).abs().max().item()})")
            for t in ran:
                errs[t] = max(errs[t], (out - want).abs().max().item())
            del out, want
        del ops
    gemm = get_algebra("gemm", **SIZES["gemm"])
    ops16 = {t.name: torch.randn(gemm.tensor_shape(t), generator=gen,
                                 device=dev).to(torch.bfloat16)
             for t in gemm.inputs}
    acc16 = repro_torch.generate("gemm", "output_stationary",
                                 bounds=SIZES["gemm"], dtype=torch.bfloat16,
                                 validate=False)
    out16 = acc16(ops16).float()
    want16 = plain_path(acc16, ops16).float()
    err16 = (out16 - want16).abs().max().item()
    check(err16 <= 2e-2 * want16.abs().max().item(),
          f"bf16 gemm: max err {err16} beyond 2e-2 of the largest value")
    del ops16, out16, want16
    torch.cuda.synchronize()
    launches = dict(stt_gemm.launches)
    for t, count in launches.items():
        check(count > 0, f"the main path never launched {t}")
    print(f"main path: {len(cases)} fp32 cases exact, bf16 gemm max err "
          f"{err16:.3e}, launches {launches}")
    phase("main path")

    # -- 4. the sparse front door -----------------------------------------
    sparse_accs = {}
    bsr_gemm.reset_launches()
    for label, name, tensor, shape, block, density in SPARSE:
        sp = Sparsity.random(shape, block, density, seed=0)
        acc = repro_torch.generate(name, "output_stationary",
                                   bounds=SIZES[name],
                                   sparsity={tensor: sp}, validate=False)
        check(acc.kernel.sparse_mode == "bsr", f"{label}: not on the BSR "
              f"kernel ({acc.kernel.sparse_mode})")
        ops = int_operands(acc.algebra)
        before = bsr_gemm.launches["bsr"]
        out, ms = sync_time(lambda: acc(ops))
        check(bsr_gemm.launches["bsr"] == before + 1,
              f"{label}: the BSR kernel did not launch once")
        want = plain_path(acc, ops)
        check(out.shape == want.shape and torch.equal(out, want),
              f"{label}: BSR output differs from the plain path (max err "
              f"{(out - want).abs().max().item()})")
        if density == 1.0:
            dense = repro_torch.generate(name, "output_stationary",
                                         bounds=SIZES[name], validate=False)
            rn = {t.name: torch.randn(acc.algebra.tensor_shape(t),
                                      generator=gen, device=dev)
                  for t in acc.algebra.inputs}
            check(torch.equal(acc(rn), dense(rn)),
                  f"{label}: not bit-identical to the dense "
                  f"output-stationary kernel")
            del rn
        sparse_accs[label] = acc
        cases.append(dict(algebra=name, stt=label, template="bsr",
                          blocks=acc.kernel.blocks, kernels=["bsr"],
                          shape=list(out.shape), first_call_ms=ms))
        del ops, out, want
    torch.cuda.synchronize()
    launches["bsr"] = bsr_gemm.launches["bsr"]
    check(launches["bsr"] > 0, "the sparse phase never launched the BSR "
          "kernel")
    print(f"sparse: {len(SPARSE)} cases exact against the plain path, "
          f"density 1.0 bit-identical to output-stationary, launches "
          f"{launches['bsr']}")
    phase("sparse")

    # -- 5. the whole-graph path -------------------------------------------
    model = get_config(GRAPH_MODEL)
    big = ArrayConfig(strip_budget_bytes=GRAPH_BUDGET)
    layer512 = from_model.layer_graph_from_config(model, l=512)
    mlp512 = chains.mlp_graph(l=512, d=model.d_model, f=model.d_ff)
    layer64 = from_model.layer_graph_from_config(model, l=64)
    ggen = torch.Generator(device=dev).manual_seed(2)

    def graph_operands(g):
        """x ~ N(0, 1); weights ~ N(0, 1/fan_in) in (out, in) storage;
        biases ~ N(0, 0.01): activations stay O(1) through the layer.
        Made on the card from the seed."""
        ops = {}
        for e in g.inputs:
            shape = g.edge_shape(e)
            v = torch.randn(shape, generator=ggen, device=dev)
            if len(shape) == 1:
                v *= 0.1
            elif e != "x":
                v /= shape[-1] ** 0.5
            ops[e] = v
        return ops

    graph_ops = {"layer512": graph_operands(layer512),
                 "mlp512": graph_operands(mlp512)}
    # the same layer's weights at l = 64: the first 64 rows of x
    graph_ops["layer64"] = {**graph_ops["layer512"],
                            "x": graph_ops["layer512"]["x"][:64]}
    graph_runs = (
        # label, graph, operands, config, merge, dtype
        ("(a) layer l=512", layer512, "layer512", big, True, torch.float32),
        ("(b) mlp l=512", mlp512, "mlp512", big, True, torch.float32),
        ("(c) layer l=64", layer64, "layer64", ArrayConfig(), True,
         torch.float32),
        ("(d) layer l=512 merge=False", layer512, "layer512", big, False,
         torch.float32),
        ("(a) layer l=512 bf16", layer512, "layer512", big, True,
         torch.bfloat16),
    )
    graph_accs, graph_outs = {}, {}
    fused_chain.reset_launches()
    stt_gemm.reset_launches()
    for label, g, key, cfg, merge, dtype in graph_runs:
        ops = graph_ops[key]
        acc = graph_executor.build(g, cfg=cfg, dtype=dtype, merge=merge,
                                   validate=False)
        before = {**fused_chain.launches, **stt_gemm.launches}
        out, ms = sync_time(lambda: acc(ops))
        after = {**fused_chain.launches, **stt_gemm.launches}
        ran = {t: after[t] - before[t] for t in after
               if after[t] > before[t]}
        if key == "mlp512":
            want = chains.mlp_oracle(ops["x"], ops["W1"], ops["b1"],
                                     ops["W2"])
        else:
            want = from_model.layer_oracle(ops, dtype=str(dtype)[6:])
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        err = (out.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        check(out.shape == want.shape and bool(torch.isfinite(out).all()),
              f"graph {label}: shape {tuple(out.shape)} or non-finite")
        check(err <= tol * scale, f"graph {label}: max err {err} beyond "
              f"{tol} x {scale} of the plain path")
        merged = sorted(gk.kind for gk in acc.group_kernels.values())
        want_merged = {"(a)": ["dag"], "(b)": ["chain"], "(c)": [],
                       "(d)": []}[label[:3]]
        check(merged == want_merged, f"graph {label}: merged groups "
              f"{merged}, expected {want_merged}")
        lines = [ln for ln in acc.describe().splitlines()
                 if ln.startswith(("  group", "  merged", "  sequential"))]
        if label.startswith("(c)"):
            check(any("exceeds the VMEM residency limit" in ln
                      for ln in lines), "graph (c): no declined-group "
                  "reason in describe()")
        print(f"graph {label}: first call {ms:.3f} ms, max err "
              f"{err:.3e} (max|out| {scale:.3e}), launches {ran}")
        for ln in lines:
            print(f"  {ln.strip()}")
        graph_accs[label] = acc
        graph_outs[label] = out
        cases.append(dict(algebra=GRAPH_MODEL, stt=label,
                          template="graph", blocks=None,
                          kernels=sorted(ran), shape=list(out.shape),
                          first_call_ms=ms, max_err=err, max_out=scale))
    a, d = graph_outs["(a) layer l=512"], graph_outs[
        "(d) layer l=512 merge=False"]
    err_ad = (a - d).abs().max().item()
    check(err_ad <= 1e-4 * d.abs().max().item(),
          f"graph (a) merged vs (d) sequential: max err {err_ad}")
    torch.cuda.synchronize()
    launches.update(fused_chain.launches)
    for t in ("fused_chain", "fused_dag"):
        check(launches[t] > 0, f"the graph phase never launched {t}")
    print(f"graph: merged vs sequential max err {err_ad:.3e}; launches "
          f"{dict(fused_chain.launches)}, STT templates "
          f"{dict(stt_gemm.launches)}")
    phase("graph")

    # -- 6. loop-nest oracle at small bounds -------------------------------
    worst = 0.0
    for name, bounds in SMALL.items():
        for s in VALIDATE_STTS:
            acc = repro_torch.generate(name, s, bounds=bounds,
                                       validate=False)
            worst = max(worst, acc.validate())
    print(f"validate: {len(SMALL) * len(VALIDATE_STTS)} small "
          f"accelerators, max err {worst}")
    phase("validate")

    # -- 7. fused epilogues against the numpy mirror -----------------------
    rng = np.random.default_rng(1)
    egemm = get_algebra("gemm", m=512, n=384, k=256)
    a = rng.integers(-4, 5, size=(512, 256)).astype(np.float32)
    b = rng.integers(-4, 5, size=(384, 256)).astype(np.float32)
    bias = rng.integers(-4, 5, size=(384,)).astype(np.float32)
    raw = a.astype(np.float64) @ b.T.astype(np.float64)
    for s in ("output_stationary", "weight_stationary"):
        for spec in (("bias", "gelu"), ("scale:0.05", "softmax")):
            df = stt.apply_stt(egemm, egemm.loops, stt.stt_from_name(s))
            kw = dict(bias_tensor="bias") if "bias" in spec else {}
            ck = lower(egemm, df, epilogue=spec, validate=False, **kw)
            feed = {"A": a, "B": b, **({"bias": bias} if kw else {})}
            got = ck(feed).double().cpu().numpy()
            want = apply_epilogue_np(raw, spec, bias=bias if kw else None)
            check(np.allclose(got, want, rtol=1e-5, atol=1e-5),
                  f"epilogue {spec} on {ck.template}: max err "
                  f"{np.abs(got - want).max()}")
    gv = get_algebra("batched_gemv", m=16, n=256, k=512)
    gops = {t.name: rng.integers(-4, 5, size=gv.tensor_shape(t))
            for t in gv.inputs}
    spec = ("scale:0.01", "gelu")
    ck = lower(gv, stt.apply_stt(gv, gv.loops,
                                 stt.stt_from_name("weight_stationary")),
               epilogue=spec, validate=False)
    check(ck.template == "streaming", "batched_gemv WS is not streaming")
    got = ck(gops).double().cpu().numpy()
    want = apply_epilogue_np(
        np.einsum("mkn,mk->mn", gops["A"], gops["B"]), spec)
    check(np.allclose(got, want, rtol=1e-5, atol=1e-5),
          f"epilogue {spec} on streaming: max err "
          f"{np.abs(got - want).max()}")
    print("epilogues: bias+gelu and softmax on output/operand-stationary, "
          "scale+gelu on reduction-tree, all within 1e-5")

    # -- 8. serving -------------------------------------------------------
    # small enough for the python loop-nest oracle
    requests = [("gemm", dict(m=64, n=48, k=32), "output_stationary"),
                ("conv2d", dict(k=8, c=4, y=6, x=6, p=3, q=3),
                 "weight_stationary"),
                ("mttkrp", dict(i=16, j=12, k=4, l=4), "input_stationary"),
                ("gemm", dict(m=64, n=48, k=32), "output_stationary")]
    # one draw and one oracle result per distinct request shape, reused
    # by both rounds (the oracle is the slow part)
    feeds, drawn = [], {}
    for name, bounds, s in requests:
        key = (name, tuple(sorted(bounds.items())))
        if key not in drawn:
            alg = get_algebra(name, **bounds)
            ops = {t.name: rng.integers(-4, 5, size=alg.tensor_shape(t))
                   for t in alg.inputs}
            drawn[key] = (ops, alg.reference(ops))
        feeds.append((name, bounds, s, *drawn[key]))
    for round_ in range(2):
        engine = AcceleratorEngine()
        hits0 = cache_info()["hits"]
        for name, bounds, s, ops, want in feeds:
            got = engine.submit(name, ops, dataflow=s, bounds=bounds)
            check(np.array_equal(got.cpu().numpy(), want),
                  f"engine {name} x {s} differs from the oracle")
        st = engine.stats()
        check(st["requests"] == len(requests), "engine lost requests")
        if round_:
            check(cache_info()["hits"] - hits0 >= 3,
                  "repeat shapes on a new engine missed the compile cache")
    print(f"serve: {2 * len(requests)} requests, compile cache "
          f"{cache_info()}")
    phase("epilogues + serve")

    # -- 9. timing --------------------------------------------------------
    def event_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    kernels = []
    for template, (replaces, (name, s)) in KERNELS.items():
        bounds = SIZES[name]
        alg = get_algebra(name, **bounds)
        ops = int_operands(alg)
        acc = repro_torch.generate(name, s, bounds=bounds, validate=False)
        k = acc.kernel
        lhs, rhs = k.form.prepare(k.cast_operands(ops))
        bm, bn, bk = k.blocks
        a3 = lhs if lhs.dim() == 3 else lhs.unsqueeze(0)
        b3 = rhs if rhs.dim() == 3 else rhs.unsqueeze(0)
        nb, m, kk, n = max(a3.shape[0], b3.shape[0]), a3.shape[1], \
            a3.shape[2], b3.shape[2]
        if template == "output_stationary":
            def run():
                return stt_gemm.matmul_output_stationary(
                    lhs, rhs, bm=bm, bn=bn, bk=bk)

            def plain():
                return stt_gemm.output_stationary_plain(
                    a3, b3, bk=bk, accum="scratch", out_dtype=k.dtype)
        elif template == "operand_stationary":
            check(k.stationary == "B", "timed WS case is not stationary B")

            def run():
                return stt_gemm.matmul_operand_stationary(
                    lhs, rhs, bm=bm, bn=bn, bk=bk)

            def plain():
                return stt_gemm.operand_stationary_plain(
                    a3, b3, out_dtype=k.dtype)
        else:
            def run():
                return stt_gemm.matmul_reduction_tree(lhs, rhs, bm=bm, bn=bn)

            def plain():
                return stt_gemm.reduction_tree_plain(a3, b3,
                                                     out_dtype=k.dtype)
        reps = 5 if nb * m * n * kk > 2 ** 34 else 20
        ms = event_ms(run, reps)
        plain_ms = event_ms(plain, reps)
        library_ms = event_ms(lambda: torch.matmul(lhs, rhs), reps)
        got, want = run(), plain()
        errs[template] = max(errs[template],
                             (got.reshape(want.shape) - want).abs().max()
                             .item())
        roof = hopper.gemm_roofline(
            f"{name} x {s}", nb, m, n, kk, a_batched=a3.shape[0] > 1,
            b_batched=b3.shape[0] > 1)
        entry = {"name": f"stt_gemm.{template}", "route": "cuda",
                 "source": "src/repro_torch/csrc/stt_gemm.cu",
                 "replaces": replaces, "launches": launches[template],
                 "max_abs_err": errs[template], "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": roof.bound_s * 1e3,
                 "bound_by": roof.bound_by, "library_ms": library_ms,
                 "shape": f"{name} x {s}: nb={nb} m={m} n={n} k={kk}"}
        if template == "operand_stationary":
            chunks = -(-kk // WS_CHUNK_K)
            strip = 4.0 * nb * m * n * (2 * chunks - 1)
            entry["bound_with_strip_ms"] = max(
                roof.compute_s, (roof.bytes + strip) / roof.spec.hbm_bw) * 1e3
        kernels.append(entry)
        del ops, lhs, rhs, a3, b3, got, want

    # row 4: the BSR kernel at gemm 4096^3, A at density 0.25
    acc = sparse_accs["gemm A d=0.25"]
    k = acc.kernel
    ops = int_operands(acc.algebra)
    acc(ops)                                    # builds the CSR arrays
    lhs, rhs = k.form.prepare(k.cast_operands(ops))
    sp = k.sparse
    (bm, bk), bn = sp.block, k.blocks[1]
    m, kk, n = lhs.shape[0], lhs.shape[1], rhs.shape[1]

    def run():
        return bsr_gemm.bsr_matmul(lhs, rhs, coords=sp.coords, bm=bm,
                                   bk=bk, bn=bn, csr=k._csr)

    def plain():
        return bsr_gemm.bsr_matmul_plain(lhs, rhs, coords=sp.coords, bm=bm,
                                         bk=bk, out_dtype=k.dtype)
    got, want = run(), plain()
    err = (got - want).abs().max().item()
    check(err == 0.0, f"BSR kernel vs plain: max err {err}")
    nz = sp.nnz_blocks * bm * bk
    roof = hopper.RooflineTerms("bsr gemm A d=0.25", 2.0 * nz * n,
                                4.0 * (nz + kk * n + m * n))
    kernels.append({
        "name": "bsr_gemm.bsr_matmul", "route": "cuda",
        "source": "src/repro_torch/csrc/bsr_gemm.cu",
        "replaces": "src/repro/kernels/bsr_gemm.py:92",
        "launches": launches["bsr"], "max_abs_err": err,
        "ms": event_ms(run, 10), "plain_ms": event_ms(plain, 10),
        "bound_ms": roof.bound_s * 1e3, "bound_by": roof.bound_by,
        # the masked dense product: one PyTorch call, same function
        "library_ms": event_ms(lambda: torch.matmul(lhs, rhs), 10),
        "shape": f"gemm m={m} k={kk} n={n}, A {sp.nnz_blocks} of "
                 f"{sp.grid[0] * sp.grid[1]} ({bm}x{bk}) blocks"})
    del ops, lhs, rhs, got, want

    # row 5: the fused-chain kernel on (b), the danube MLP at l = 512
    acc = graph_accs["(b) mlp l=512"]
    (gk,) = acc.group_kernels.values()
    ops = graph_ops["mlp512"]
    lhs = ops["x"]
    rhs_kn = [ops["W1"].T, ops["W2"].T]
    biases = [ops["b1"]]

    def run():
        return fused_chain.fused_chain_matmul(
            lhs, rhs_kn, biases, stages=gk.chain, bm=gk.bm,
            interleave=gk.interleave)

    def plain():
        return fused_chain.chain_reference(lhs, *rhs_kn, *biases,
                                           stages=gk.chain)
    got, want = run(), plain()
    err = (got - want).abs().max().item()
    check(err <= 1e-4 * want.abs().max().item(),
          f"fused chain vs plain: max err {err}")
    flops = 2.0 * gk.m * sum(st.k * st.n for st in gk.chain)
    nbytes = 4.0 * (gk.m * gk.k0 + sum(st.k * st.n for st in gk.chain)
                    + sum(st.n for st in gk.chain if st.has_bias)
                    + gk.m * gk.chain[-1].n)
    roof = hopper.RooflineTerms("mlp l=512", flops, nbytes)
    kernels.append({
        "name": "fused_chain.fused_chain_matmul", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_chain.cu",
        "replaces": "src/repro/kernels/fused_chain.py:274",
        "launches": launches["fused_chain"], "max_abs_err": err,
        "ms": event_ms(run, 5), "plain_ms": event_ms(plain, 5),
        "bound_ms": roof.bound_s * 1e3, "bound_by": roof.bound_by,
        "library_ms": None,
        "shape": f"{GRAPH_MODEL} MLP chain, m={gk.m}: "
                 + " -> ".join(f"({st.k},{st.n})" for st in gk.chain)})
    del got, want

    # row 6: the fused-DAG kernel on (a), the danube layer at l = 512
    acc = graph_accs["(a) layer l=512"]
    (gk,) = acc.group_kernels.values()
    ops = graph_ops["layer512"]
    exts = [gk._dag_prep(ops[e], role, gk.dtype) for e, role in gk.ext_roles]

    def run():
        return fused_chain.fused_dag(exts, stages=gk.dag)

    def plain():
        return fused_chain.dag_reference(exts, stages=gk.dag)
    got, want = run(), plain()
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    check(err <= 1e-4 * max(w.abs().max().item() for w in want),
          f"fused DAG vs plain: max err {err}")
    flops = 2.0 * sum(st.m * st.k * st.n for st in gk.dag)
    # each graph input once, though x feeds three roles (lhs, rhs, res)
    nbytes = float(sum(e.numel() * e.element_size() for e in
                       {edge: ext for (edge, _), ext
                        in zip(gk.ext_roles, exts)}.values())
                   + sum(g.numel() * g.element_size() for g in got))
    roof = hopper.RooflineTerms("layer l=512", flops, nbytes)
    kernels.append({
        "name": "fused_chain.fused_dag", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_chain.cu",
        "replaces": "src/repro/kernels/fused_chain.py:526",
        "launches": launches["fused_dag"], "max_abs_err": err,
        "ms": event_ms(run, 5), "plain_ms": event_ms(plain, 5),
        "bound_ms": roof.bound_s * 1e3, "bound_by": roof.bound_by,
        "library_ms": None,
        "shape": f"{GRAPH_MODEL} layer, l=512: {len(gk.dag)} stages, "
                 f"{len(gk.ext_roles)} operands, {gk.n_tap} tap"})
    del exts, got, want

    for c in cases:
        name, s = c["algebra"], c["stt"]
        if c["template"] == "bsr":
            acc = sparse_accs[s]
            ops = int_operands(acc.algebra)
        elif c["template"] == "graph":
            acc = graph_accs[s]
            ops = graph_ops[{"(b)": "mlp512", "(c)": "layer64"}.get(
                s[:3], "layer512")]
        else:
            ops = int_operands(get_algebra(name, **SIZES[name]))
            acc = repro_torch.generate(name, s, bounds=SIZES[name],
                                       validate=False)
        c["call_ms"] = sync_time(lambda: acc(ops), reps=3)[1]
        if c["template"] in ("bsr", "graph") or s == "output_stationary":
            c.update(profile_call(lambda: acc(ops), c["call_ms"]))
        else:
            c.update(kernel_ms=None, other_device_ms=None, busy_share=None)
        del ops
    phase("timing")
    (OUT_DIR / "chip_smoke_cases.json").write_text(json.dumps(
        {"device": smi, "cases": cases, "kernels": kernels,
         "phase_s": phase_s}, indent=1))
    for c in cases:
        prof = ("not traced" if c["kernel_ms"] is None else
                f"kernel {c['kernel_ms']:.3f} ms, other device "
                f"{c['other_device_ms']:.3f} ms, busy {c['busy_share']:.2f}")
        blocks = "" if c["blocks"] is None else \
            f"blocks={tuple(c['blocks'])} "
        print(f"  {c['algebra']:15s} {c['stt']:28s} {c['template']:18s} "
              f"{blocks}call {c['call_ms']:.3f} ms ({prof})")

    print(f"phases (s): {phase_s}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
