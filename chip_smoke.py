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
   operands.  Each case's launch plan (tile, CTAs, the head of the work
   order) is printed;
5. the whole-graph path at the full width of h2o-danube-1.8b
   (``generate(AlgebraGraph)`` -> ``GraphAccelerator``): (a) one layer at
   l = 512 under a 512 MiB budget, one merged DAG group on the fused-DAG
   kernel; (b) its MLP, one chain group on the fused-chain kernel; (c)
   the layer at l = 64 under the default budget, planned sequential onto
   the STT templates; (d) case (a) with ``merge=False``; and (a) in bf16.
   fp32 results are held to the plain path (and (a) to (d)) within
   1e-4 x max|out|: the sum order differs from cuBLAS and exp/tanh are
   other implementations; bf16 within 2e-2 x max|out|;
6. measured autotuning (``repro_torch.tune``) at full width, on a fresh
   tuning cache in a temporary directory (every other phase reads an
   empty one): (a) ``generate("gemm", bounds=4096^3, tune=4)`` — every
   trial with its dataflow, template, knobs, ok flag and median, the
   untuned and tuned medians, the winner beside the analytical top-1,
   and how many distinct launch signatures the trials held (the launch
   entry points' scalar arguments: shapes, strides, flags); every failed
   trial must be a knob rejection, the winner exact against the plain
   path on integer operands, a second call a cache hit with no trials,
   and ``lower()`` without knobs then ``source == "tuned"``; the same
   for depthwise_conv at its ``SIZES`` width, whose candidates take the
   streaming (reduction-tree) template; (b) ``build(tune=8)`` of phase
   5's h2o-danube-1.8b layer at l = 512 (512 MiB budget): each group's
   merged-or-sequential verdict with both medians, the output within
   1e-4 x max|out| of the plain path, a second build answered from the
   group cache; (c) ``rank_measured`` over ``dse.search(gemm 4096^3,
   top_k=4)`` and over the four named STTs, each beside the analytical
   order.  The STT templates' and the fused kernel's launch counts are
   zeroed at the phase's start and must all be above 0 at its end;
7. ``Accelerator.validate()`` (the loop-nest oracle) at small bounds for
   every algebra under the output- and weight-stationary STTs, which
   between them reach all three templates (``VALIDATE_STTS``): exact on
   integer operands;
8. fused epilogues (bias+gelu, softmax) on every template, against the
   numpy mirror (rtol 1e-5, atol 1e-5: fp32 vs fp64 transcendental
   rounding on exact integer sums);
9. an ``AcceleratorEngine`` answering mixed requests; repeat shapes on a
   second engine must hit the compile cache;
10. each kernel timed with CUDA events at a main-path shape beside its
   plain version, one PyTorch call computing the same function where
   there is one (``torch.matmul``; a yardstick the port never calls) and
   its roofline bound from ``core/hopper.py`` (the BSR kernel also at the
   other four sparse shapes, printed and kept on its entry); each STT
   template's
   timed case and the two fused kernels' must give the same bits on a
   second call; graph (a)'s merged kernel time is printed beside
   (d)'s sequential one, and each fused launch's plan (levels, tile
   and k split a stage, grid) in phase 5; then every
   main-path, sparse and graph case timed end to end (host clock, 3
   calls); the sparse and graph cases and one STT per dense algebra are
   traced once;
11. LM serving at the full width and depth of h2o-danube-1.8b (24
   layers, bf16 compute, fp32 master weights drawn on the card from a
   seed): a ``ContinuousServer`` over a ``SlotEngine(capacity=8,
   max_context=2048, page_size=16, total_pages=512)`` answers 16 greedy
   requests (prompts uniform in 128..1536 tokens, 16..64 new tokens,
   numpy seed 0) submitted from 4 threads.  Each decode step gathers the
   paged KV cache through the paged-gather kernel, each prefill runs its
   self-attention on the flash-attention kernel; both launch counts are
   zeroed just before the server run and read just after.  Checks: (a)
   every request's tokens equal those of the same engine serving it
   alone; (b) its prefill logits and first token equal
   ``DecodeEngine.generate(prompt, cache_len=2048)``'s; (c)
   ``decode_compiles == 1``; (d) the gather kernel equals its plain
   version bit for bit at the serve shape; (e) the flash kernel equals
   ``attention_ref`` at the traffic's prefill shapes and at a windowed
   shape that hides whole kv blocks (bf16 within 2e-2 x max|out|, and
   within ``BF16_ROW_TOL`` of each row's norm of the plain version that
   rounds P to bf16 as the kernel does; fp32 within 1e-4 x max|out|:
   other sum order and ``expf``).  Full token
   agreement with ``DecodeEngine`` (batch 1) is printed, not gated:
   cuBLAS picks kernels by shape, so batch-1 and batch-8 products may
   round apart.  Per-step and per-prefill times, both kernels' times
   beside their bounds, plain versions and library calls (flash in bf16
   at danube's heads and at zamba2-1.2b's shared block, D = 64, each held
   to its plain versions as in (e), and the row error of a planted fault,
   a kv block hidden from the last q block, which must exceed the
   limit), and one traced decode step and prefill are reported;
12. serving the SSM families at full width and depth (``SSM_SERVE``):
   zamba2-1.2b (38 Mamba-2 layers, the shared attention+MLP block after
   every 6, bf16) over ``SlotEngine(capacity=8, max_context=2048,
   page_size=16, total_pages=512)`` answering 16 greedy requests of the
   same traffic (numpy seed 0), and mamba2-370m (48 layers, state 128,
   no paged leaf: one page a slot) answering 8 (seed 1), each from 4
   threads through ``ContinuousServer``.  Every prefill runs the SSD-scan
   kernel in each SSM layer; zamba2's shared block runs flash attention
   in prefill and gathers its paged K/V every decode step.  The three
   launch counts are zeroed before each server run and read after it
   (zamba2: all three above 0; mamba2: the SSD scan).  Checks (a)–(c) as
   in phase 11 ((b) on the prefill logits and the first token); for
   zamba2 (d) the gather bit-exact at the shared pool and (e) flash at
   the shared block's heads (D = 64, 32 heads, no GQA) within phase 11's
   tolerances; (f) the SSD kernels against their plain version at each
   model's longest prefill and at a ragged chunk (Q = 37), y and the
   final state within 1e-4 x max|.| (other sum order and scan
   association, ``expf``), and a second call the same bits.  Step,
   prefill and SSD times (the wrapper's, and the traced device time of
   its three kernels), tokens per second, and one traced decode step
   and prefill per model are reported.

Prints the ``nvidia-smi`` line, one ``{"kernels": [...]}`` JSON line
(nine rows, one per kernel),
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
import threading
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
#: the SSD scan's three kernels (one call launches each once), and all of
#: the port's kernels, by the names the profiler reports
SSD_KERNELS = ("ssd_chunk_state_kernel<", "ssd_state_pass_kernel",
               "ssd_chunk_scan_kernel<")
OUR_KERNELS = ("stt_tile_kernel<", "os_stream_kernel<", "rt_tree_kernel<",
               "os_inplace_kernel<", "ws_kernel<", "ws_tile_kernel<",
               "bsr_tile_kernel<", "stages_kernel<", "gather_kernel<",
               "flash_kernel<", "flash_mma_kernel<") + SSD_KERNELS
#: the serve phase: model, slot engine, traffic
SERVE_MODEL = "h2o-danube-1.8b"
SERVE_ENGINE = dict(capacity=8, max_context=2048, page_size=16,
                    total_pages=512)
SERVE_REQUESTS, SERVE_THREADS = 16, 4
PROMPT_LENS, NEW_TOKENS = (128, 1536), (16, 64)
#: the SSM serve phase: (model, its depth, requests, numpy seed, engine)
SSM_SERVE = (
    ("zamba2-1.2b", 38, 16, 0, dict(capacity=8, max_context=2048,
                                    page_size=16, total_pages=512)),
    ("mamba2-370m", 48, 8, 1, dict(capacity=8, max_context=2048,
                                   page_size=16)),
)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def kernel_times(fn):
    """One call of ``fn`` under ``torch.profiler``: ``[(kernel name,
    device ms, launches)]`` of the device kernels it ran, largest first
    (empty when the trace holds no device events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        # kernels only: an operator's own device time repeats theirs
        if us > 0 and str(getattr(ev, "device_type", "")).endswith("CUDA"):
            rows.append((ev.key, us / 1e3, ev.count))
    return sorted(rows, key=lambda r: -r[1])


def profile_call(fn, call_ms: float):
    """One call under ``torch.profiler``: the device time of the port's
    kernels and of everything else on the device, and their share of the
    unprofiled call time ``call_ms``.  The profiler's tracing of this
    card can come back without device events; those fields are then
    None (not measured)."""
    rows = kernel_times(fn)
    ours = sum(ms for k, ms, _ in rows if any(o in k for o in OUR_KERNELS))
    if ours == 0.0:
        return {"kernel_ms": None, "other_device_ms": None,
                "busy_share": None}
    other = sum(ms for _, ms, _ in rows) - ours
    return {"kernel_ms": ours, "other_device_ms": other,
            "busy_share": (ours + other) / call_ms}


def event_ms(fn, reps):
    """Mean CUDA-event time of ``reps`` calls of ``fn`` after one warm-up
    call."""
    import torch
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


def graph_operands(g, gen):
    """Operands of graph ``g`` on the card, drawn from ``gen``: x ~ N(0,
    1); weights ~ N(0, 1/fan_in) in (out, in) storage; biases ~ N(0,
    0.01): activations stay O(1) through the layer."""
    import torch
    ops = {}
    for e in g.inputs:
        shape = g.edge_shape(e)
        v = torch.randn(shape, generator=gen, device=gen.device)
        if len(shape) == 1:
            v *= 0.1
        elif e != "x":
            v /= shape[-1] ** 0.5
        ops[e] = v
    return ops


def device_breakdown(fn, top: int = 8):
    """One untraced call of ``fn`` on the host clock, then one traced:
    device time by kernel (the ``top`` largest) and in all, and the busy
    share; ``device_ms`` is None when the trace holds no device events."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t) * 1e3
    rows = kernel_times(fn)
    total = sum(ms for _, ms, _ in rows)
    if total == 0.0:
        return {"call_ms": call_ms, "device_ms": None, "busy_share": None,
                "kernels": []}
    return {"call_ms": call_ms, "device_ms": total,
            "busy_share": total / call_ms,
            "kernels": [{"name": k[:90], "ms": ms, "count": n}
                        for k, ms, n in rows[:top]]}


def serve_traffic(n, seed, vocab):
    """``n`` requests: prompts uniform in ``PROMPT_LENS`` tokens, new
    tokens uniform in ``NEW_TOKENS``, from numpy seed ``seed``.  Returns
    (the generator, for later draws; lens; news; prompts)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, n)
    news = rng.integers(NEW_TOKENS[0], NEW_TOKENS[1] + 1, n)
    prompts = [rng.integers(0, vocab, (int(s),)).astype(np.int32)
               for s in lens]
    return rng, lens, news, prompts


def run_server(eng, prompts, news, check):
    """Every request through a ``ContinuousServer`` over ``eng``, submitted
    from ``SERVE_THREADS`` client threads.  Returns (tokens per request,
    seconds, server stats, mean occupancy)."""
    import torch

    from repro_torch.serve import ContinuousServer

    n = len(prompts)
    futures = [None] * n
    t0 = time.perf_counter()
    with ContinuousServer(eng) as server:
        def client(ids):
            for i in ids:
                futures[i] = server.submit(prompts[i],
                                           max_new_tokens=int(news[i]))
        threads = [threading.Thread(target=client,
                                    args=(range(t, n, SERVE_THREADS),))
                   for t in range(SERVE_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        check(not any(t.is_alive() for t in threads), "a client hung")
        server.drain(timeout=600)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    served = [f.result(timeout=1) for f in futures]
    n_tokens = sum(len(s) for s in served)
    check(n_tokens == int(news.sum()), f"served {n_tokens} tokens, "
          f"expected {int(news.sum())}")
    return served, serve_s, dict(server.stats), server.mean_occupancy()


def serve_alone(eng, prompts, news, served, check):
    """Checks (a) and (c): each request served alone on the same engine
    gives its continuous tokens; the decode step was built once.  Returns
    (step ms, [(prompt length, prefill ms)]), host clock."""
    import numpy as np
    step_ms, prefill_ms = [], []
    for i, prompt in enumerate(prompts):
        t = time.perf_counter()
        res = eng.insert(prompt, max_new_tokens=int(news[i]))
        prefill_ms.append((len(prompt), (time.perf_counter() - t) * 1e3))
        check(res is not None, f"request {i} not admitted alone")
        slot, tok = res
        toks = [tok]
        while len(toks) < news[i]:
            t = time.perf_counter()
            r = eng.step()
            step_ms.append((time.perf_counter() - t) * 1e3)
            toks.append(r.token_at(slot))
        eng.evict(slot)
        check(np.array_equal(np.asarray(toks, np.int32), served[i]),
              f"(a) request {i}: continuous tokens differ from the same "
              f"engine serving it alone")
    check(eng.decode_compiles == 1,
          f"(c) decode_compiles {eng.decode_compiles}")
    return step_ms, prefill_ms


def check_prefill(eng, de, lm, prompts, news, served, check, *, full):
    """Check (b): the slot engine's prefill logits equal
    ``DecodeEngine``'s and so does its first token.  With ``full`` the
    whole ``DecodeEngine`` generation runs (batch 1, cache at the slot
    engine's context) and the first step where it leaves the continuous
    tokens is returned per request (None: all agree); printed, not
    gated."""
    import numpy as np
    import torch

    from repro_torch.models import decode as lm_decode

    dev = torch.device("cuda")
    max_context = eng.max_context
    diverge = []
    for i, prompt in enumerate(prompts):
        toks = torch.as_tensor(prompt, device=dev).long()[None]
        with torch.no_grad():
            la = lm_decode.prefill(eng.params, toks, lm,
                                   max_len=max_context)[0]
            lb = lm_decode.prefill(de.params, toks, lm,
                                   max_len=max_context)[0]
        check(torch.equal(la, lb), f"(b) request {i}: prefill logits of "
              f"the slot engine and DecodeEngine differ")
        want = de.generate(prompt[None],
                           max_new_tokens=int(news[i]) if full else 1,
                           cache_len=max_context)[0][0]
        check(want[0] == served[i][0], f"(b) request {i}: first token "
              f"{served[i][0]} != DecodeEngine's {want[0]}")
        if full:
            d = np.flatnonzero(want != served[i])
            diverge.append(int(d[0]) if d.size else None)
    return diverge


def trace_step_and_prefill(eng, lm, prompts, lens, check):
    """Fill every slot, then one decode step and the longest prompt's
    prefill, each on the host clock and once more traced."""
    import numpy as np
    import torch

    from repro_torch.models import decode as lm_decode

    for i in range(eng.capacity):
        check(eng.insert(prompts[i][:128], max_new_tokens=64) is not None,
              "could not fill the batch for the traced step")
    eng.step()
    step_prof = device_breakdown(eng.step)
    pre = torch.as_tensor(prompts[int(np.argmax(lens))],
                          device=torch.device("cuda")).long()[None]
    with torch.no_grad():
        pre_prof = device_breakdown(lambda: lm_decode.prefill(
            eng.params, pre, lm, max_len=eng.max_context))
    for slot in eng.live_slots():
        eng.evict(slot)
    return step_prof, pre_prof


def report_times(tag, step_ms, prefill_ms, step_prof, pre_prof, max_len):
    import numpy as np
    steps = np.asarray(step_ms)
    print(f"{tag}: decode step call_ms mean {steps.mean():.3f} p50 "
          f"{np.median(steps):.3f} p90 {np.percentile(steps, 90):.3f} "
          f"(n={steps.size}); prefill call_ms "
          + ", ".join(f"L={s}: {ms:.2f}" for s, ms in sorted(prefill_ms)))
    for label, prof in (("decode step", step_prof),
                        (f"prefill L={max_len}", pre_prof)):
        if prof["device_ms"] is None:
            print(f"  traced {label}: no device events")
            continue
        print(f"  traced {label}: call {prof['call_ms']:.3f} ms, device "
              f"{prof['device_ms']:.3f} ms, busy {prof['busy_share']:.2f}")
        for kr in prof["kernels"]:
            print(f"    {kr['ms']:8.3f} ms x{kr['count']:<4d} {kr['name']}")
    return {"mean": float(steps.mean()), "p50": float(np.median(steps)),
            "p90": float(np.percentile(steps, 90)), "n": int(steps.size)}


def serve_phase(check):
    """Phase 10: LM serving at full width and depth on the paged-gather
    and flash-attention kernels.  Returns (kernel rows, summary)."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention, paged
    from repro_torch.models import init_params
    from repro_torch.serve import DecodeEngine, SlotEngine

    dev = torch.device("cuda")
    lm = get_config(SERVE_MODEL)
    check(lm.n_layers == 24 and lm.dtype == "bfloat16",
          f"{SERVE_MODEL}: not full depth in bf16")
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=dev).manual_seed(0), lm)
    eng = SlotEngine(params, lm, **SERVE_ENGINE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n = SERVE_REQUESTS
    rng, lens, news, prompts = serve_traffic(n, 0, lm.vocab)

    # the main path: 16 requests from 4 threads through the server
    flash_attention.reset_launches()
    paged.reset_launches()
    served, serve_s, stats, occupancy = run_server(eng, prompts, news, check)
    launches = {**paged.launches, **flash_attention.launches}
    for name, count in launches.items():
        check(count > 0, f"the serve path never launched {name}")
    n_tokens = int(news.sum())
    print(f"serve: {n} requests ({n_tokens} tokens) in {serve_s:.2f} s, "
          f"{n_tokens / serve_s:.1f} tok/s; steps {stats['steps']}, mean "
          f"occupancy {occupancy:.2f}, admission stalls "
          f"{stats['admission_stalls']}; launches {launches}")

    # (a), (c): continuous == one at a time on the same engine, timed
    step_ms, prefill_ms = serve_alone(eng, prompts, news, served, check)

    # (b) prefill == DecodeEngine's; full agreement printed
    de = DecodeEngine(params, lm)
    diverge = check_prefill(eng, de, lm, prompts, news, served, check,
                            full=True)
    agree = sum(d is None for d in diverge)
    print(f"serve checks: (a) continuous == alone for {n} requests, (b) "
          f"prefill logits and first token == DecodeEngine, (c) "
          f"decode_compiles 1; DecodeEngine (batch 1) agrees on all tokens "
          f"for {agree}/{n}, first divergent step {diverge}")
    del de

    # (d) the gather kernel at the serve shape, bit for bit
    gather_row = gather_check(eng, ("self", "k"), lens, news, rng, check)
    gather_row["launches"] = launches["paged_gather"]
    rows = [gather_row]
    print(f"serve checks: (d) gather == plain bit for bit at "
          f"{tuple(eng.cache.pools[('self', 'k')].shape)}")

    # (e) flash attention against attention_ref
    g = torch.Generator(device=dev).manual_seed(3)
    hq, hkv, d = lm.n_heads, lm.n_kv_heads, lm.head_dim
    worst = flash_check(lm, ((int(lens.min()), None),
                             (int(lens.max()), None), (1024, 100)),
                        g, check)

    length = int(lens.max())
    timed = flash_times(hq, hkv, d, length, g, check)
    # the same length at zamba2-1.2b's shared block (D = 64, no GQA)
    zl = get_config("zamba2-1.2b")
    zamba = flash_times(zl.n_heads, zl.n_kv_heads, zl.head_dim, length, g,
                        check)
    for t in (timed, zamba):
        print(f"serve: flash {t['shape']}: {t['ms']:.4f} ms (bound "
              f"{t['bound_ms']:.4f}, SDPA {t['library_ms']:.4f}); row "
              f"error {t['row_err']:.3e} (limit "
              f"{flash_attention.BF16_ROW_TOL}), a dropped kv block "
              f"{t['fault_row_err']:.3e}")
    rows.append({
        "name": "flash_attention.flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:72",
        "launches": launches["flash_attention"], **timed,
        "zamba2": zamba})

    # one decode step at full occupancy and one prefill, traced
    step_prof, pre_prof = trace_step_and_prefill(eng, lm, prompts, lens,
                                                 check)
    steps = report_times("serve", step_ms, prefill_ms, step_prof, pre_prof,
                         int(lens.max()))
    summary = {
        "setup_s": setup_s, "serve_s": serve_s, "tokens": n_tokens,
        "tok_per_s": n_tokens / serve_s, "server_stats": stats,
        "mean_occupancy": occupancy, "decode_step_ms": steps,
        "prefill_ms": prefill_ms, "diverge": diverge,
        "flash_errs": worst, "traced_step": step_prof,
        "traced_prefill": {"len": int(lens.max()), **pre_prof}}
    return rows, summary


def gather_check(eng, path, lens, news, rng, check):
    """Check (d): the gather kernel equals its plain version bit for bit
    on the pool of ``path``, with a table like the engine's with the
    first ``capacity`` requests resident (each slot's pages drawn from a
    permutation of the pool, the rest on the scratch page).  Returns the
    gather's kernel row without ``launches``."""
    import numpy as np
    import torch

    from repro_torch.core import hopper
    from repro_torch.kernels import paged

    pool = eng.cache.pools[path]
    lay = eng.cache.layout
    free = rng.permutation(lay.total_pages).tolist()
    table_np = np.full((lay.capacity, lay.pages_per_slot), lay.scratch_page,
                       np.int32)
    for c in range(lay.capacity):
        need = min(eng.cache.pages_needed(int(lens[c] + news[c])), len(free))
        table_np[c, :need] = [free.pop() for _ in range(need)]
    table = torch.as_tensor(table_np, device=pool.device)
    got = paged.paged_gather(pool, table)
    want = paged.paged_gather_plain(pool, table)
    check(torch.equal(got, want),
          f"(d) paged gather differs from plain on {path}")
    # the bytes this table needs: each distinct page read once, the view
    # written once
    page_bytes = pool[0].numel() * pool.element_size()
    nbytes = (len(np.unique(table_np)) * page_bytes
              + got.numel() * got.element_size() + table_np.nbytes)
    roof = hopper.RooflineTerms("paged gather", 0.0, float(nbytes),
                                dtype="bfloat16")
    return {
        "name": "paged.paged_gather", "route": "cuda",
        "source": "src/repro_torch/csrc/paged.cu",
        "replaces": "src/repro/kernels/paged.py:46",
        "max_abs_err": 0.0,
        "ms": event_ms(lambda: paged.paged_gather(pool, table), 20),
        "plain_ms": event_ms(lambda: paged.paged_gather_plain(pool, table),
                             20),
        "bound_ms": roof.bound_s * 1e3, "bound_by": roof.bound_by,
        "library_ms": event_ms(
            lambda: pool.index_select(0, table.flatten().long()), 20),
        "shape": f"pool {tuple(pool.shape)} bf16, table "
                 f"{tuple(table.shape)}, {len(np.unique(table_np))} distinct "
                 f"pages"}


def flash_times(hq, hkv, d, length, g, check):
    """The flash kernel on random bf16 q (1, hq, length, d) and k, v (1,
    hkv, length, d), causal: its errors against the plain version that
    rounds P to bf16 as the kernel does (max abs, and ``row_error``, held
    to ``BF16_ROW_TOL``) and against the reference's arithmetic (held to
    2e-2 x max|out|); the errors of a planted fault, a kv block hidden
    from the last q block, against the same plain version (its row error
    must exceed the limit); the kernel's time, the plain version's,
    SDPA's and the bound (4 d flops an unmasked pair and q head, bf16
    tensor cores)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import hopper
    from repro_torch.kernels import flash_attention as fa

    q, k, v = [torch.randn((1, h, length, d), generator=g,
                           device=torch.device("cuda")).to(torch.bfloat16)
               for h in (hq, hkv, hkv)]
    shape = (f"q (1, {hq}, {length}, {d}), k/v (1, {hkv}, {length}, {d}) "
             f"bf16, causal")
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_plain(q, k, v, causal=True, round_p=True)
    errs = bf16_flash_errors(got, want, fa.flash_attention_plain(
        q, k, v, causal=True), check, shape)
    fault = dropped_block(q, k, v, length - 64, length // 2 // 64 * 64)
    fault_row = fa.row_error(fault, want)
    check(fault_row > fa.BF16_ROW_TOL,
          f"flash {shape}: a dropped kv block reads {fault_row}, inside "
          f"BF16_ROW_TOL {fa.BF16_ROW_TOL}")
    pairs = length * (length + 1) // 2
    roof = hopper.RooflineTerms(
        "flash attention", 4.0 * d * hq * pairs,
        2.0 * (2 * q.numel() + k.numel() + v.numel()), dtype="bfloat16")
    return {
        **errs, "fault_row_err": fault_row,
        "fault_max_abs_err": (fault.float() - want.float()).abs().max().item(),
        "ms": event_ms(lambda: fa.flash_attention(q, k, v, causal=True), 10),
        "plain_ms": event_ms(lambda: fa.flash_attention_plain(
            q, k, v, causal=True, round_p=True), 3),
        "bound_ms": roof.bound_s * 1e3, "bound_by": roof.bound_by,
        "library_ms": event_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=hq != hkv), 10),
        "shape": shape}


def bf16_flash_errors(got, want, want_ref, check, what):
    """The bf16 flash kernel's output ``got`` against ``want``, the plain
    version that rounds P to bf16 (``row_error`` within
    ``BF16_ROW_TOL``), and ``want_ref``, one with the reference's fp32
    P V (max abs within 2e-2 x max|out|)."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    row = fa.row_error(got, want)
    ref_err = (got.float() - want_ref.float()).abs().max().item()
    scale = want_ref.float().abs().max().item()
    check(bool(torch.isfinite(got.float()).all()) and
          row <= fa.BF16_ROW_TOL,
          f"flash bf16 {what}: row error {row} beyond BF16_ROW_TOL "
          f"{fa.BF16_ROW_TOL} of the plain version")
    check(ref_err <= 2e-2 * scale, f"flash bf16 {what}: max err {ref_err} "
          f"beyond 2e-2 x {scale} of the reference's arithmetic")
    return {"max_abs_err": (got.float() - want.float()).abs().max().item(),
            "row_err": row, "ref_max_abs_err": ref_err}


def dropped_block(q, k, v, rows, k0):
    """A planted fault for the tolerance's self-check: causal attention
    in fp32 with kv columns [k0, k0 + 64) hidden from q rows >= ``rows``
    (a kv block a faulty kernel skips)."""
    import torch

    from repro_torch.kernels import ref

    lq, lkv, group = q.shape[2], k.shape[2], q.shape[1] // k.shape[1]
    kf, vf = (x.float().repeat_interleave(group, dim=1) for x in (k, v))
    scores = torch.matmul(q.float(), kf.transpose(-1, -2)) / q.shape[3] ** 0.5
    mask = ref.attention_mask(lq, lkv, causal=True, window=None,
                              device=q.device)
    mask[rows:, k0:k0 + 64] = False
    p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.matmul(p, vf).to(q.dtype)


def flash_check(lm, cases, g, check):
    """Check (e): the flash kernel (through ``ops.attention``) against
    ``attention_ref`` at ``lm``'s heads for each (length, window): bf16
    within 2e-2 x max|out| and, against the plain version that rounds P
    to bf16, within ``BF16_ROW_TOL`` of each row's norm; fp32 within
    1e-4 x max|out| (other sum order and ``expf``).  Returns the errors
    per case."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    hq, hkv, d = lm.n_heads, lm.n_kv_heads, lm.head_dim
    worst = {}
    for length, window in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = [torch.randn((1, h, length, d), generator=g,
                                   device=dev).to(dtype)
                       for h in (hq, hkv, hkv)]
            out = ops.attention(q, k, v, causal=True, window=window)
            want = ref.attention_ref(q, k, v, causal=True, window=window)
            case = f"L={length} w={window} {str(dtype)[6:]}"
            if dtype == torch.bfloat16:
                worst[case] = bf16_flash_errors(
                    out, fa.flash_attention_plain(
                        q, k, v, causal=True, window=window, round_p=True),
                    want, check, f"(e) {case}")
                continue
            err = (out.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            check(bool(torch.isfinite(out).all()) and err <= 1e-4 * scale,
                  f"(e) flash {case}: max err {err} beyond 1e-4 x {scale}")
            worst[case] = err
    print(f"serve checks: (e) {lm.name} flash errors {worst}")
    return worst


def ssd_operands(bsz, length, lm, g):
    """Random SSD operands at ``lm``'s heads and state, on the card:
    x, B and C (per group) standard normal, dt in [0.1, 1) and a in
    (-1.5, -0.5], the model's ranges."""
    import torch
    dev = torch.device("cuda")
    h, p = lm.ssm_heads, lm.ssm_head_dim
    gr, n = lm.ssm_groups, lm.ssm_state

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    return (randn(bsz, length, h, p), 0.1 + 0.9 * rand(bsz, length, h),
            -0.5 - rand(h), randn(bsz, length, gr, n),
            randn(bsz, length, gr, n))


def ssd_check(lm, cases, g, check):
    """Check (f): the SSD kernels against their plain version
    ``ref.ssd_chunked_ref`` at each (length, chunk) of ``cases``: y and
    the final state within 1e-4 x max|.| in fp32 (other sum order and
    scan association, the card's ``expf``), and a second call the same
    bits.  Returns the max error relative to max|.| per case."""
    import torch

    from repro_torch.kernels import ref, ssd_scan

    worst = {}
    for length, chunk in cases:
        args = ssd_operands(1, length, lm, g)
        got = ssd_scan.ssd_scan(*args, chunk=chunk)
        want = ref.ssd_chunked_ref(*args, chunk=chunk)
        again = ssd_scan.ssd_scan(*args, chunk=chunk)
        check(all(torch.equal(u, v) for u, v in zip(got, again)),
              f"(f) ssd_scan {lm.name} L={length} chunk={chunk}: a second "
              f"call gives other bits")
        rel = []
        for name, gv, wv in zip(("y", "state"), got, want):
            err = (gv - wv).abs().max().item()
            scale = wv.abs().max().item()
            check(bool(torch.isfinite(gv).all()) and err <= 1e-4 * scale,
                  f"(f) ssd_scan {lm.name} L={length} chunk={chunk} "
                  f"{name}: max err {err} beyond 1e-4 x {scale}")
            rel.append(err / scale)
        worst[f"L={length} Q={chunk} N={lm.ssm_state}"] = max(rel)
    print(f"ssm serve checks: (f) {lm.name} ssd_scan vs plain, max err / "
          f"max|.| {worst}; two calls the same bits")
    return worst


def ssd_roofline(bsz, length, chunk, lm):
    """The SSD's least time on the card (fp32 on the CUDA cores).  Per
    chunk, C B^T's lower triangle is needed once per group, Q(Q+1)/2 N
    multiply-adds; per head, its masked product with x Q(Q+1)/2 P, and
    the inter-chunk term and the state update Q N P each; scaling by dt
    and forming dt * a take one multiply an element of x and of dt (the
    kernels fold both into their decay weights).  Bytes are x,
    dt, a, y, B and C per group, and the final state, each once."""
    from repro_torch.core import hopper
    h, p = lm.ssm_heads, lm.ssm_head_dim
    gr, n = lm.ssm_groups, lm.ssm_state
    q, nc = chunk, length // chunk
    tri = q * (q + 1) // 2
    macs = bsz * nc * (gr * tri * n + h * (tri * p + 2 * q * n * p))
    prep = bsz * length * h * (p + 1)
    nbytes = 4.0 * (bsz * (2 * length * h * p + length * h
                           + 2 * length * gr * n + h * n * p) + h)
    return hopper.RooflineTerms("ssd scan", 2.0 * macs + prep, nbytes,
                                dtype="float32")


def ssm_serve_phase(check):
    """Phase 11: serving the hybrid (zamba2-1.2b) and the pure SSM
    (mamba2-370m) at full width and depth, on the SSD-scan, flash and
    paged-gather kernels.  Returns (the ssd_scan kernel row, summary)."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention, paged, ref, ssd_scan
    from repro_torch.models import init_params
    from repro_torch.serve import DecodeEngine, SlotEngine

    dev = torch.device("cuda")
    summary, ssd_launches, timed = {}, 0, None
    for model, depth, n, seed, engine_kw in SSM_SERVE:
        lm = get_config(model)
        check(lm.n_layers == depth and lm.dtype == "bfloat16",
              f"{model}: not full depth in bf16")
        t0 = time.perf_counter()
        params = init_params(torch.Generator(device=dev).manual_seed(0), lm)
        eng = SlotEngine(params, lm, **engine_kw)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        rng, lens, news, prompts = serve_traffic(n, seed, lm.vocab)
        hybrid = lm.family == "hybrid"

        # the main path: the requests from 4 threads through the server
        ssd_scan.reset_launches()
        flash_attention.reset_launches()
        paged.reset_launches()
        served, serve_s, stats, occupancy = run_server(eng, prompts, news,
                                                       check)
        launches = {**ssd_scan.launches, **flash_attention.launches,
                    **paged.launches}
        must = (launches if hybrid else ssd_scan.launches)
        for name, count in must.items():
            check(count > 0, f"the {model} serve path never launched {name}")
        ssd_launches += launches["ssd_scan"]
        n_tokens = int(news.sum())
        print(f"ssm serve {model}: {n} requests ({n_tokens} tokens) in "
              f"{serve_s:.2f} s, {n_tokens / serve_s:.1f} tok/s; steps "
              f"{stats['steps']}, mean occupancy {occupancy:.2f}, admission "
              f"stalls {stats['admission_stalls']}; launches {launches}; "
              f"paged leaves {[p for p, _ in eng.cache.layout.paged]}, "
              f"pages per slot {eng.cache.layout.pages_per_slot}")

        # (a), (c); (b) on the prefill logits and the first token
        step_ms, prefill_ms = serve_alone(eng, prompts, news, served, check)
        de = DecodeEngine(params, lm)
        check_prefill(eng, de, lm, prompts, news, served, check, full=False)
        del de
        print(f"ssm serve checks {model}: (a) continuous == alone for {n} "
              f"requests, (b) prefill logits and first token == "
              f"DecodeEngine, (c) decode_compiles 1")

        part = {"setup_s": setup_s, "serve_s": serve_s, "tokens": n_tokens,
                "tok_per_s": n_tokens / serve_s, "server_stats": stats,
                "mean_occupancy": occupancy, "launches": launches,
                "prefill_ms": prefill_ms}
        g = torch.Generator(device=dev).manual_seed(3)
        if hybrid:
            # (d) the gather at the shared pool; (e) flash at the shared
            # block's heads
            row = gather_check(eng, ("shared", "k"), lens, news, rng, check)
            part["gather_ms"] = row["ms"]
            print(f"ssm serve checks {model}: (d) gather == plain bit for "
                  f"bit at {tuple(eng.cache.pools[('shared', 'k')].shape)}")
            part["flash_errs"] = flash_check(
                lm, ((int(lens.min()), None), (int(lens.max()), None)), g,
                check)
        # (f) the SSD kernel at the longest prefill and a ragged chunk
        longest = -(-int(lens.max()) // lm.ssm_chunk) * lm.ssm_chunk
        part["ssd_errs"] = ssd_check(lm, ((longest, lm.ssm_chunk),
                                          (3 * 37, 37)), g, check)
        args = ssd_operands(1, longest, lm, g)
        roof = ssd_roofline(1, longest, lm.ssm_chunk, lm)
        got = ssd_scan.ssd_scan(*args, chunk=lm.ssm_chunk)
        want = ref.ssd_chunked_ref(*args, chunk=lm.ssm_chunk)

        def ssd_call():
            return ssd_scan.ssd_scan(*args, chunk=lm.ssm_chunk)
        for _ in range(3):      # a trace may come back without device events
            traced = kernel_times(ssd_call)
            ssd_ms = [ms for k, ms, _ in traced
                      if any(n in k for n in SSD_KERNELS)]
            if ssd_ms:
                break
        part["ssd"] = {
            "shape": f"x (1, {longest}, {lm.ssm_heads}, "
                     f"{lm.ssm_head_dim}), b/c (1, {longest}, "
                     f"{lm.ssm_groups}, {lm.ssm_state}) fp32, chunk "
                     f"{lm.ssm_chunk}; ms: one wrapper call (the "
                     f"single-kernel wrapper's time held its prep passes "
                     f"too), kernels_ms: the traced device time of its "
                     f"three kernels",
            "max_abs_err": max((gv - wv).abs().max().item()
                               for gv, wv in zip(got, want)),
            "ms": event_ms(ssd_call, 20),
            "kernels_ms": sum(ssd_ms) if ssd_ms else None,
            "device_ms": sum(ms for _, ms, _ in traced) or None,
            "plain_ms": event_ms(lambda: ref.ssd_chunked_ref(
                *args, chunk=lm.ssm_chunk), 3),
            "bound_ms": roof.bound_s * 1e3, "bound_by": roof.bound_by,
            "gflop": roof.flops / 1e9, "mbytes": roof.bytes / 1e6}
        print(f"ssm serve {model}: ssd_scan at {part['ssd']['shape']}: "
              f"{part['ssd']['ms']:.4f} ms (traced: kernels "
              f"{part['ssd']['kernels_ms']} ms, device "
              f"{part['ssd']['device_ms']} ms), plain "
              f"{part['ssd']['plain_ms']:.3f} ms, bound "
              f"{part['ssd']['bound_ms']:.4f} ms ({roof.bound_by}, "
              f"{part['ssd']['gflop']:.3f} GFLOP, "
              f"{part['ssd']['mbytes']:.1f} MB)")
        if timed is None:
            timed = part["ssd"]
        del args, got, want

        # one decode step at full occupancy and one prefill, traced
        step_prof, pre_prof = trace_step_and_prefill(eng, lm, prompts, lens,
                                                     check)
        part["decode_step_ms"] = report_times(
            f"ssm serve {model}", step_ms, prefill_ms, step_prof, pre_prof,
            int(lens.max()))
        part["traced_step"] = step_prof
        part["traced_prefill"] = {"len": int(lens.max()), **pre_prof}
        summary[model] = part
        del eng, params
        torch.cuda.empty_cache()

    row = {"name": "ssd_scan.ssd_scan", "route": "cuda",
           "source": "src/repro_torch/csrc/ssd_scan.cu",
           "replaces": "src/repro/kernels/ssd_scan.py:61",
           "launches": ssd_launches,
           **{k: timed[k] for k in ("max_abs_err", "ms", "kernels_ms",
                                    "plain_ms", "bound_ms", "bound_by")},
           "library_ms": None, "shape": timed["shape"]}
    return [row], summary


#: the tune phase's algebras: gemm, whose candidates all take the
#: output-stationary template, and depthwise_conv, whose take streaming
TUNE_ALGEBRAS = ("gemm", "depthwise_conv")


def record_launches(stems):
    """Wrap the C launch entry points of the ``stems`` libraries so each
    launch adds its scalar arguments (dtype, shapes, strides, flags — no
    pointers) to a set: two trials with one signature launched the same
    kernel on the same problem.  Returns (the set, a function that
    unwraps)."""
    import ctypes

    from repro_torch.kernels import _build

    scalar = (ctypes.c_int, ctypes.c_longlong, ctypes.c_float)
    seen, undo = set(), []
    for stem in stems:
        lib = _build.library(stem)
        for name, types in _build.SIGNATURES[stem].items():
            real = getattr(lib, name)

            def rec(*args, _real=real, _name=name, _types=types):
                seen.add((_name,) + tuple(a for a, t in zip(args, _types)
                                          if t in scalar))
                return _real(*args)
            setattr(lib, name, rec)
            undo.append((lib, name, real))

    def unwrap():
        for lib, name, real in undo:
            setattr(lib, name, real)
    return seen, unwrap


def tune_gemm_like(name, check, int_operands, plain_path):
    """Phase 6 (a): ``generate(name, tune=4)`` at ``SIZES[name]`` on the
    current (fresh) tuning cache; prints and checks every trial."""
    import torch

    import repro_torch
    from repro_torch.compile import lower
    from repro_torch.core import dse
    from repro_torch.core.algebra import get_algebra

    bounds = SIZES[name]
    alg = get_algebra(name, **bounds)
    pairs = dse.search(alg, top_k=4)
    templates = {df.name: lower(alg, df, validate=False,
                                tuned=False).template for _, df in pairs}
    seen, unwrap = record_launches(("stt_gemm",))
    try:
        t0 = time.perf_counter()
        acc = repro_torch.generate(name, bounds=bounds, tune=4,
                                   validate=False)
        tune_s = time.perf_counter() - t0
    finally:
        unwrap()
    tr = acc.tune_result
    check(not tr.cache_hit and len(tr.trials) > 1,
          f"tune {name}: no trials on a fresh cache")
    for t in tr.trials:
        v = t.variant
        print(f"  trial {t.dataflow_name} {templates[t.dataflow_name]} "
              f"blocks={v.blocks} {v.grid_order}/{v.accum} ok={t.ok} "
              + (f"median {t.median_s * 1e3:.4f} ms" if t.ok
                 else t.error[:70]))
    bad = [t.error for t in tr.trials
           if not t.ok and not t.error.startswith("ValueError")]
    check(not bad, f"tune {name}: trials failed other than by a knob "
          f"rejection: {bad[:2]}")
    ops = int_operands(alg)
    out, want = acc(ops), plain_path(acc, ops)
    check(out.shape == want.shape and torch.equal(out, want),
          f"tune {name}: the winner differs from the plain path")
    del ops, out, want
    again = repro_torch.generate(name, bounds=bounds, tune=4,
                                 validate=False)
    check(again.tune_result.cache_hit and again.tune_result.trials == (),
          f"tune {name}: the second call was not a cache hit")
    k = lower(alg, tr.dataflow, validate=False)
    check(k.source == "tuned", f"tune {name}: lower() without knobs gave "
          f"source {k.source!r}")
    top = pairs[0][1]
    top_k = lower(alg, top, validate=False, tuned=False)
    n_ok = sum(t.ok for t in tr.trials)
    print(f"tune (a) {name}: {len(tr.trials)} trials ({n_ok} ok), "
          f"{len(seen)} distinct launch signatures, {tune_s:.1f} s; untuned "
          f"{tr.untuned_s * 1e3:.4f} ms, tuned {tr.tuned_s * 1e3:.4f} ms "
          f"({tr.speedup:.3f}x); winner {tr.dataflow.name} "
          f"{k.template} blocks={tr.variant.blocks} "
          f"{tr.variant.grid_order}/{tr.variant.accum}; analytical top-1 "
          f"{top.name} {top_k.template} blocks={top_k.blocks}; winner "
          f"exact, second call a cache hit")
    return {"algebra": name, "bounds": bounds, "tune_s": tune_s,
            "trials": [{"dataflow": t.dataflow_name,
                        "template": templates[t.dataflow_name],
                        "blocks": list(t.variant.blocks),
                        "grid_order": t.variant.grid_order,
                        "accum": t.variant.accum, "ok": t.ok,
                        "median_ms": t.median_s * 1e3 if t.ok else None,
                        "error": t.error} for t in tr.trials],
            "distinct_launch_signatures": len(seen),
            "untuned_ms": tr.untuned_s * 1e3, "tuned_ms": tr.tuned_s * 1e3,
            "winner": {"dataflow": tr.dataflow.name, "template": k.template,
                       "blocks": list(tr.variant.blocks),
                       "grid_order": tr.variant.grid_order,
                       "accum": tr.variant.accum},
            "analytical_top1": {"dataflow": top.name,
                                "template": top_k.template,
                                "blocks": list(top_k.blocks)}}


def tune_phase(check, int_operands, plain_path, layer512, layer_ops, big):
    """Phase 6: measured autotuning at full width on a fresh tuning cache
    in a temporary directory; the variable is restored afterwards, so
    the later phases read the run's empty cache."""
    import os
    import tempfile

    import torch

    from repro_torch.compile import lower
    from repro_torch.core import dse, stt
    from repro_torch.core.algebra import get_algebra
    from repro_torch.graph import executor as graph_executor
    from repro_torch.graph import from_model
    from repro_torch.kernels import fused_chain, stt_gemm
    from repro_torch.tune import tuner

    summary = {}
    prior = os.environ.get("REPRO_TUNE_CACHE")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tune_") as tmp:
        os.environ["REPRO_TUNE_CACHE"] = tmp
        try:
            stt_gemm.reset_launches()
            fused_chain.reset_launches()
            summary["a"] = [tune_gemm_like(name, check, int_operands,
                                           plain_path)
                            for name in TUNE_ALGEBRAS]

            # (b) merged or sequential: the danube layer at l = 512
            acc = graph_executor.build(layer512, cfg=big, merge=True,
                                       tune=8, validate=False)
            out = acc(layer_ops)
            want = from_model.layer_oracle(layer_ops, dtype="float32")
            err = (out - want).abs().max().item()
            scale = want.abs().max().item()
            check(out.shape == want.shape and err <= 1e-4 * scale,
                  f"tune (b): max err {err} beyond 1e-4 x {scale}")
            groups = []
            for gname, res in acc.group_tuning.items():
                verdict = "merged" if res.merged else "sequential"
                ms = (f"{res.merged_s * 1e3:.4f}"
                      if res.merged_s is not None else "none")
                print(f"tune (b) {gname}: {verdict}; merged {ms} ms, "
                      f"sequential {res.sequential_s * 1e3:.4f} ms, "
                      f"trials {[(t.variant.bm, t.variant.interleave, t.ok)
                                 for t in res.trials]}")
                groups.append({"group": gname, "verdict": verdict,
                               "merged_ms": (res.merged_s * 1e3
                                             if res.merged_s else None),
                               "sequential_ms": res.sequential_s * 1e3,
                               "trials": len(res.trials)})
            check(bool(groups), "tune (b): no merged-eligible group")
            for ln in acc.describe().splitlines():
                if ln.startswith(("  merged", "  sequential")):
                    print(f"  {ln.strip()}")
            print(f"tune (b): output max err {err:.3e} (max|out| "
                  f"{scale:.3e})")
            again = graph_executor.build(layer512, cfg=big, merge=True,
                                         tune=8, validate=False)
            check(all(r.cache_hit for r in again.group_tuning.values()),
                  "tune (b): the second build did not answer from the "
                  "group cache")
            summary["b"] = {"groups": groups, "max_err": err,
                            "max_out": scale}
            del out, want

            # (c) measured ranking of the analytical candidates
            alg = get_algebra("gemm", **SIZES["gemm"])
            named = [(None, stt.apply_stt(alg, alg.loops[:3],
                                          stt.stt_from_name(s)))
                     for s in STTS]
            summary["c"] = {}
            for label, pairs in (("dse top-4", dse.search(alg, top_k=4)),
                                 ("named STTs", named)):
                ranked = tuner.rank_measured(alg, pairs)
                order = [pairs.index(next(p for p in pairs if p[1] is df))
                         for _, df, _ in ranked]
                rows = [{"rank_analytical": i, "dataflow": df.name,
                         "template": lower(alg, df, validate=False,
                                           tuned=False).template,
                         "median_ms": t * 1e3}
                        for i, (_, df, t) in zip(order, ranked)]
                print(f"tune (c) gemm 4096^3 {label}, measured order "
                      f"(analytical rank: dataflow template median): "
                      + "; ".join(f"{r['rank_analytical']}: "
                                  f"{r['dataflow']} {r['template']} "
                                  f"{r['median_ms']:.4f} ms"
                                  for r in rows))
                summary["c"][label] = rows
        finally:
            if prior is None:
                os.environ.pop("REPRO_TUNE_CACHE", None)
            else:
                os.environ["REPRO_TUNE_CACHE"] = prior
    torch.cuda.synchronize()
    launches = {**stt_gemm.launches, **fused_chain.launches}
    for t in ("output_stationary", "operand_stationary", "reduction_tree",
              "fused_dag"):
        check(launches[t] > 0, f"the tune phase never launched {t}")
    print(f"tune: launches {launches}")
    summary["launches"] = launches
    return summary


def bsr_pattern(k):
    """The BSR kernel's view of sparse kernel ``k``'s pattern: ``(coords,
    bm, bk, m, n)`` of ``C (m, n) = S @ D``, the rhs side transposed as
    ``ops.bsr_matmul`` hands it to the kernel."""
    from repro_torch.kernels import bsr_gemm
    sp, f = k.sparse, k.form
    if sp.side == "lhs":
        return sp.coords, sp.block[0], sp.block[1], f.m, f.n
    return (bsr_gemm.transpose_coords(sp.coords), sp.block[1], sp.block[0],
            f.n, f.m)


def bsr_operands(k, lhs, rhs):
    """``(S, D)`` of :func:`bsr_pattern` from ``k``'s prepared operands."""
    return (lhs, rhs) if k.sparse.side == "lhs" else (rhs.T, lhs.T)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import os
    import tempfile

    import numpy as np

    # an empty tuning cache for the whole run (removed at exit): lower()
    # reads the cache before the analytical choice, and no phase may
    # pick up variants tuned elsewhere
    run_cache = tempfile.TemporaryDirectory(prefix="chip_smoke_cache_")
    os.environ["REPRO_TUNE_CACHE"] = run_cache.name

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
        plan = bsr_gemm.launch_plan(*bsr_pattern(acc.kernel),
                                    order=bsr_gemm.ORDER)
        print(f"  {label}: {plan.describe()}")
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
    graph_ops = {"layer512": graph_operands(layer512, ggen),
                 "mlp512": graph_operands(mlp512, ggen)}
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
        for gk in acc.group_kernels.values():
            # the fused launch's layout: levels, tile/split a stage, grid
            stages = (gk.dag if gk.kind == "dag"
                      else fused_chain.chain_as_dag(gk.chain, gk.m))
            print("  plan: " + fused_chain.card_plan(
                stages, dtype, dev).describe().replace("\n", "\n  "))
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

    # -- 6. measured autotuning ------------------------------------------
    tune_summary = tune_phase(check, int_operands, plain_path, layer512,
                              graph_ops["layer512"], big)
    phase("tune")

    # -- 7. loop-nest oracle at small bounds -------------------------------
    worst = 0.0
    for name, bounds in SMALL.items():
        for s in VALIDATE_STTS:
            acc = repro_torch.generate(name, s, bounds=bounds,
                                       validate=False)
            worst = max(worst, acc.validate())
    check(worst == 0.0, f"validate: max err {worst} against the loop-nest "
          f"oracle on integer operands")
    print(f"validate: {len(SMALL) * len(VALIDATE_STTS)} small "
          f"accelerators, max err {worst}")
    phase("validate")

    # -- 8. fused epilogues against the numpy mirror -----------------------
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

    # -- 9. serving -------------------------------------------------------
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

    # -- 10. timing --------------------------------------------------------
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
        check(torch.equal(run(), got), f"{template}: two calls differ")
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
            # one strip read and write per chunk after the first; the
            # last chunk is flushed from registers
            chunks = -(-kk // stt_gemm.WS_CHUNK_K)
            strip = 4.0 * nb * m * n * 2 * (chunks - 1)
            entry["bound_with_strip_ms"] = max(
                roof.compute_s, (roof.bytes + strip) / roof.spec.hbm_bw) * 1e3
        kernels.append(entry)
        del ops, lhs, rhs, a3, b3, got, want

    # the BSR kernel at the other four sparse shapes: its time, bound and
    # the masked dense product's (kept on row 4's entry)
    bsr_shapes = []
    for label, acc in sparse_accs.items():
        if label == "gemm A d=0.25":
            continue
        k = acc.kernel
        lhs, rhs = k.form.prepare(k.cast_operands(int_operands(acc.algebra)))
        s_op, d_op = bsr_operands(k, lhs, rhs)
        coords, bm, bk, m, n = bsr_pattern(k)

        def run():
            return bsr_gemm.bsr_matmul(s_op, d_op, coords=coords, bm=bm,
                                       bk=bk, bn=128, csr=k._csr)
        got = run()
        err = (got - bsr_gemm.bsr_matmul_plain(
            s_op, d_op, coords=coords, bm=bm, bk=bk,
            out_dtype=k.dtype)).abs().max().item()
        check(err == 0.0, f"BSR kernel vs plain, {label}: max err {err}")
        nz = len(coords) * bm * bk
        roof = hopper.RooflineTerms(
            label, 2.0 * nz * n, 4.0 * (nz + s_op.shape[1] * n + m * n))
        bsr_shapes.append({
            "case": label, "ms": event_ms(run, 10),
            "bound_ms": roof.bound_s * 1e3, "bound_by": roof.bound_by,
            "library_ms": event_ms(lambda: torch.matmul(lhs, rhs), 10),
            "max_abs_err": err,
            "plan": bsr_gemm.launch_plan(coords, bm, bk, m, n,
                                         bsr_gemm.ORDER).describe()})
        print(f"bsr {label}: {bsr_shapes[-1]['ms']:.4f} ms, bound "
              f"{bsr_shapes[-1]['bound_ms']:.4f} ms "
              f"({roof.bound_by}), masked dense torch.matmul "
              f"{bsr_shapes[-1]['library_ms']:.4f} ms")
        del lhs, rhs, s_op, d_op, got

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
                 f"{sp.grid[0] * sp.grid[1]} ({bm}x{bk}) blocks",
        "other_shapes": bsr_shapes})
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
    check(torch.equal(run(), got), "fused chain: two calls differ")
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
    check(all(torch.equal(a, b) for a, b in zip(run(), got)),
          "fused DAG: two calls differ")
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
    merged, seq = (next(c["kernel_ms"] for c in cases if c["stt"] == label)
                   for label in ("(a) layer l=512",
                                 "(d) layer l=512 merge=False"))
    if merged is not None and seq is not None:
        print(f"graph (a) merged kernel {merged:.3f} ms vs (d) sequential "
              f"{seq:.3f} ms ({seq / merged:.2f}x)")
    phase("timing")

    # -- 11. LM serving ---------------------------------------------------
    serve_rows, serve_summary = serve_phase(check)
    kernels.extend(serve_rows)
    phase("serve")

    # -- 12. SSM and hybrid serving ----------------------------------------
    ssm_rows, ssm_summary = ssm_serve_phase(check)
    kernels.extend(ssm_rows)
    phase("ssm serve")
    (OUT_DIR / "chip_smoke_cases.json").write_text(json.dumps(
        {"device": smi, "cases": cases, "kernels": kernels,
         "tune": tune_summary, "serve": serve_summary,
         "ssm_serve": ssm_summary, "phase_s": phase_s}, indent=1))
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
