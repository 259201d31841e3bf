"""Drive the PyTorch port's main path on one NVIDIA H100 and check it.

    python chip_smoke.py

Runs from the root of a checkout, on a machine with one CUDA card and
the CUDA toolkit (``nvcc`` for ``sm_90a``).  It imports the port
(``src/repro_torch``) and nothing of the JAX reference package.  Phases,
each of which fails the run (non-zero exit) when it fails:

1. no CUDA device -> exit 1 before anything else;
2. print the card (``nvidia-smi`` name, power limit) and build the CUDA
   kernels from ``src/repro_torch/csrc`` into the gitignored build dir;
3. the main path: ``repro_torch.generate(name, stt)`` ->
   ``Accelerator.__call__`` for every registry algebra x each named STT
   at full width (sizes in ``SIZES``), plus one bf16 gemm.  The kernels'
   launch counts are zeroed just before and read just after.  Each
   output is held against the plain PyTorch path on the same inputs:
   integer-valued fp32 operands in [-4, 4] keep every sum below 2^24 at
   these sizes, so the fp32 comparison is exact; the bf16 gemm is held
   to 2e-2 of the largest magnitude (the reference's bf16 tolerance);
4. ``Accelerator.validate()`` (the loop-nest oracle) at small bounds for
   all 24 (algebra, STT) pairs;
5. fused epilogues (bias+gelu, softmax) on every template, against the
   numpy mirror (rtol 1e-5, atol 1e-5: fp32 vs fp64 transcendental
   rounding on exact integer sums);
6. an ``AcceleratorEngine`` answering mixed requests; repeat shapes on a
   second engine must hit the compile cache;
7. each kernel timed with CUDA events at a main-path shape beside its
   plain version, ``torch.matmul`` (a yardstick the port never calls)
   and its roofline bound from ``core/hopper.py``; then every main-path
   case timed end to end (host clock, 3 calls) and traced once.

Prints the ``nvidia-smi`` line, one ``{"kernels": [...]}`` JSON line,
and, last, ``{"ok": true, "device": {...}}``.  Per-case times go to
``results/chip_smoke/chip_smoke_cases.json`` (gitignored), each with one
more call traced by ``torch.profiler``: the device time of the template
kernel, of everything else on the device (layout copies, casts), and the
device's busy share of the untraced call time.
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
        if any(k in ev.key for k in ("os_kernel<", "ws_kernel<",
                                     "rt_kernel<")):
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
    from repro_torch.core import hopper, stt
    from repro_torch.core.algebra import get_algebra
    from repro_torch.kernels import _build, ref, stt_gemm
    from repro_torch.kernels.epilogue import apply_epilogue_np
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

    # -- 4. loop-nest oracle at small bounds -------------------------------
    worst = 0.0
    for name, bounds in SMALL.items():
        for s in STTS:
            acc = repro_torch.generate(name, s, bounds=bounds,
                                       validate=False)
            worst = max(worst, acc.validate())
    print(f"validate: 24 small accelerators, max err {worst}")

    # -- 5. fused epilogues against the numpy mirror -----------------------
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

    # -- 6. serving -------------------------------------------------------
    # small enough for the python loop-nest oracle
    requests = [("gemm", dict(m=64, n=48, k=32), "output_stationary"),
                ("conv2d", dict(k=8, c=4, y=6, x=6, p=3, q=3),
                 "weight_stationary"),
                ("mttkrp", dict(i=16, j=12, k=4, l=4), "input_stationary"),
                ("gemm", dict(m=64, n=48, k=32), "output_stationary")]
    for round_ in range(2):
        engine = AcceleratorEngine()
        hits0 = cache_info()["hits"]
        for name, bounds, s in requests:
            alg = get_algebra(name, **bounds)
            ops = {t.name: rng.integers(-4, 5, size=alg.tensor_shape(t))
                   for t in alg.inputs}
            got = engine.submit(name, ops, dataflow=s, bounds=bounds)
            want = alg.reference(ops)
            check(np.array_equal(got.cpu().numpy(), want),
                  f"engine {name} x {s} differs from the oracle")
        st = engine.stats()
        check(st["requests"] == len(requests), "engine lost requests")
        if round_:
            check(cache_info()["hits"] - hits0 >= 3,
                  "repeat shapes on a new engine missed the compile cache")
    print(f"serve: {2 * len(requests)} requests, compile cache "
          f"{cache_info()}")

    # -- 7. timing --------------------------------------------------------
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

    for c in cases:
        name, s = c["algebra"], c["stt"]
        alg = get_algebra(name, **SIZES[name])
        ops = int_operands(alg)
        acc = repro_torch.generate(name, s, bounds=SIZES[name],
                                   validate=False)
        c["call_ms"] = sync_time(lambda: acc(ops), reps=3)[1]
        c.update(profile_call(lambda: acc(ops), c["call_ms"]))
        del ops
    (OUT_DIR / "chip_smoke_cases.json").write_text(json.dumps(
        {"device": smi, "cases": cases, "kernels": kernels}, indent=1))
    for c in cases:
        prof = ("device time not captured" if c["kernel_ms"] is None else
                f"kernel {c['kernel_ms']:.3f} ms, other device "
                f"{c['other_device_ms']:.3f} ms, busy {c['busy_share']:.2f}")
        print(f"  {c['algebra']:15s} {c['stt']:18s} {c['template']:18s} "
              f"blocks={tuple(c['blocks'])} call {c['call_ms']:.3f} ms "
              f"({prof})")

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
