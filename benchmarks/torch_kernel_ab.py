"""Time the port's redesigned kernels of one source tree on the card.

    python benchmarks/torch_kernel_ab.py [--src SRC] [--tag TAG]
        [--cases flash,ws,os,rt,ssd,ssd-bwd,gather,fused,fused-tiles,bsr,
                 bsr-order]
        [--match TEXT]
        [--ssd-head-blocks 1,2,4,8]

Imports ``repro_torch`` from ``SRC`` (default: this checkout's ``src``),
so that the same script times two trees, for example a parent commit
unpacked beside the checkout, in turns on one card (parent, change,
change, parent).  Prints one JSON line per case, with
the card's ``nvidia-smi`` name and power limit:

* ``flash``: the flash-attention kernel on random bf16 q, k, v at the
  serve path's longest prefill (1495 tokens, causal) at h2o-danube-1.8b's
  heads (32 over 8, D = 80) and zamba2-1.2b's shared block (32 over 32,
  D = 64); CUDA-event mean of 20 calls;
* ``ws``, ``os``, ``rt``: every case of ``chip_smoke.py``'s main path
  (``SIZES`` x ``STTS``) that runs the operand-stationary, the
  output-stationary or the reduction-tree template (``streaming``
  included), on integer operands; ``os`` adds the bf16 gemm and the
  graph cases that run sequentially on the templates, (c) (the
  h2o-danube-1.8b layer at l = 64) and (d) (at l = 512, ``merge=False``).
  Each gives the device time of the port's kernels in one traced
  ``Accelerator.__call__`` (``torch.profiler``; the names of both this
  tree's kernels and the earlier ``os_kernel``/``rt_kernel``; null when
  three traces held none, with the number of traces taken), and the
  CUDA-event mean of 5 calls;
* ``ssd``: the SSD scan on ``chip_smoke.ssd_operands`` at the longest
  serve prefill of zamba2-1.2b (x (1, 1536, 64, 64), N = 64) and of
  mamba2-370m (x (1, 1472, 32, 64), N = 128), and at shorter serve
  prefills of each (zamba2 512 and 256, mamba2 1024 and 512 tokens),
  where the launch plan takes fewer heads a CTA: the CUDA-event mean of 20
  wrapper calls, and in one traced call the device time of the port's
  kernels and of everything on the device (the earlier wrapper's prep
  passes included); ``--ssd-head-blocks`` adds the same at other head
  blocks of the chunk-output kernel than the launch plan's;
* ``ssd-bwd``: the SSD backward at ``chip_smoke.SSD_BWD_CASES`` (both
  models' training shapes and phase 15's smaller cases), on its operands
  and dy, given the forward's scratch: the CUDA-event mean of 10 calls,
  the traced device time of each backward kernel, and the tree's
  ``backward_plan`` where it has one (``--ssd-head-blocks`` adds the same
  at other head blocks of the plan);
* ``gather``: the paged gather at h2o-danube-1.8b's serve pool (513, 16,
  15360) and zamba2-1.2b's shared pool (513, 16, 12288), bf16, with the
  serve phase's table (8 slots of 128 pages holding the first 8
  requests of its traffic, the rest on the scratch page): the CUDA-event
  mean of 20 calls, and of 20 ``index_select`` calls on the same table;
* ``fused``: the fused-chain and fused-DAG kernels on ``chip_smoke.py``'s
  graph operands (h2o-danube-1.8b at l = 512: its MLP chain, row 5, and
  its layer's DAG, row 6), fp32 and bf16, each the CUDA-event mean of
  10 calls, the traced device time of its kernel and, where the tree has
  one, its launch plan and the DAG's traced time cut after each
  dependency level; then graphs (a) (fp32 and bf16), (b) and (d) as
  ``timed`` cases (traced kernel time of one call, event mean of 5);
* ``fused-tiles``: the fused DAG of the h2o-danube-1.8b layer at l = 64,
  128 and 256 (the lengths where the launch plan puts stages on 64-wide
  tiles), fp32 and bf16, with the plan's tiles and with 128-wide tiles
  only (``fused_chain.TILES`` narrowed): each plan, the traced kernel
  time (3 traces) and the largest difference between the two outputs;
* ``bsr``: the BSR kernel at ``chip_smoke.py``'s five sparse cases
  (``SPARSE``: gemm 4096^3 with A at density 0.25 and 1.0 and B at 0.25,
  conv2d with sparse weights, mttkrp with A sparse), called as the
  compiled kernel calls it, on integer operands: the traced kernel time
  (the names of this tree's kernel and the earlier ``bsr_kernel``), the
  CUDA-event mean of 20 calls, whether it equals the plain version, the
  CUDA-event mean of ``torch.matmul`` on the masked dense operands, and
  the launch plan where the tree has one;
* ``bsr-order``: row 4 (gemm A d=0.25) and mttkrp A with the plan's work
  order, heaviest block-row first, and in raster order
  (``bsr_gemm.ORDER`` set to "raster"): 3 traced kernel times and the
  CUDA-event mean of 20 calls each.

``--match`` keeps only the cases whose label holds one of its
comma-separated strings (for example ``gemm x,mttkrp``).  Timing and
tracing are ``chip_smoke.py``'s own (``event_ms``, ``kernel_times``).

Needs a CUDA card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def traced_ms(fn, names, tries=3):
    """Device time, in one traced call of ``fn``, of the kernels whose
    name holds one of ``names`` (``chip_smoke.kernel_times``), and the
    number of traces taken.  A trace that holds none of them is taken
    again, up to ``tries`` times; after that the time is None (not
    measured), never 0."""
    from chip_smoke import kernel_times
    fn()
    for n in range(1, tries + 1):
        ms = [t for k, t, _ in kernel_times(fn) if any(x in k for x in names)]
        if ms:
            return sum(ms), n
    return None, tries


#: template names of the main-path cases each group times
GROUPS = {"ws": ("operand_stationary",), "os": ("output_stationary",),
          "rt": ("reduction_tree", "streaming")}
#: kernel names of the STT templates before the tile/stream redesign, of
#: the SSD scan before the chunk-parallel one, and of the first BSR kernel
EARLIER_KERNELS = ("os_kernel<", "rt_kernel<", "ssd_kernel(", "bsr_kernel<")
#: the sparse cases ``bsr-order`` times in both work orders
BSR_ORDER_CASES = ("gemm A d=0.25", "mttkrp A d=0.25")
#: the SSD cases: model, prefill length (the longest serve prefill, then
#: shorter ones, where the launch plan halves the head block)
SSD_CASES = (("zamba2-1.2b", 1536), ("mamba2-370m", 1472),
             ("zamba2-1.2b", 512), ("zamba2-1.2b", 256),
             ("mamba2-370m", 1024), ("mamba2-370m", 512))
#: the gather cases: model, row width F of its paged pool
GATHER_CASES = (("h2o-danube-1.8b", 15360), ("zamba2-1.2b", 12288))


def gather_table(engine, requests=16, seed=0):
    """The serve phase's page table: each of the first ``capacity``
    requests of its traffic (``chip_smoke.serve_traffic``) holds the pages
    its prompt and new tokens need, drawn from a permutation of the pool;
    the rest point at the scratch page (index ``total_pages``)."""
    import numpy as np
    from chip_smoke import serve_traffic
    _, lens, news, _ = serve_traffic(requests, seed, vocab=2)
    cap, page, total = (engine["capacity"], engine["page_size"],
                        engine["total_pages"])
    free = np.random.default_rng(seed).permutation(total).tolist()
    table = np.full((cap, engine["max_context"] // page), total, np.int32)
    for c in range(cap):
        need = min(-(-int(lens[c] + news[c]) // page), len(free))
        table[c, :need] = [free.pop() for _ in range(need)]
    return table


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="change")
    ap.add_argument("--cases", default="flash,ws,os,rt,ssd,gather,fused",
                    help="comma-separated groups: flash, ws, os, rt, ssd, "
                         "ssd-bwd, gather, fused, fused-tiles, bsr, "
                         "bsr-order")
    ap.add_argument("--ssd-head-blocks", default="",
                    help="comma-separated head blocks to time the SSD "
                         "forward and backward cases at besides their "
                         "launch plan's")
    ap.add_argument("--match", default="",
                    help="time only the cases whose label holds one of "
                         "these comma-separated strings")
    args = ap.parse_args()
    groups = args.cases.split(",")
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import repro_torch
    from chip_smoke import (GRAPH_BUDGET, GRAPH_MODEL, OUR_KERNELS,
                            SERVE_ENGINE, SIZES, STTS, event_ms,
                            graph_operands, kernel_times, ssd_operands)
    from repro_torch.configs.registry import get_config
    from repro_torch.core.algebra import get_algebra
    from repro_torch.core.tiling import ArrayConfig
    from repro_torch.graph import executor as graph_executor
    from repro_torch.graph import from_model
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_chain, paged, ssd_scan
    from repro_torch.models import chains

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    _build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    names = OUR_KERNELS + EARLIER_KERNELS

    def emit(**row):
        print(json.dumps({"tag": args.tag, "card": smi, **row}), flush=True)

    def timed(case, fn):
        if not any(m in case for m in args.match.split(",")):
            return
        ms, traces = traced_ms(fn, names)
        emit(case=case, traced_kernel_ms=ms, traces=traces,
             call_event_ms=event_ms(fn, 5))

    if "flash" in groups:
        for hq, hkv, d in ((32, 8, 80), (32, 32, 64)):
            q, k, v = [torch.randn((1, h, 1495, d), generator=gen,
                                   device=dev).to(torch.bfloat16)
                       for h in (hq, hkv, hkv)]
            emit(case=f"flash q (1, {hq}, 1495, {d}) k/v (1, {hkv}, 1495, "
                      f"{d})",
                 ms=event_ms(lambda: fa.flash_attention(q, k, v,
                                                        causal=True), 20))
            del q, k, v

    if "ssd" in groups:
        for model, length in SSD_CASES:
            lm = get_config(model)
            ops = ssd_operands(1, length, lm, gen)

            def call():
                return ssd_scan.ssd_scan(*ops, chunk=lm.ssm_chunk)
            plan = getattr(ssd_scan, "launch_plan", None)   # None: earlier
            planned = plan(1, length, lm.ssm_heads, lm.ssm_groups,
                           lm.ssm_state, lm.ssm_head_dim,
                           lm.ssm_chunk).head_block if plan else None
            blocks = [None] + [int(b) for b in args.ssd_head_blocks.split(",")
                               if b and plan]
            for hb in blocks:
                if hb is not None:
                    ssd_scan.launch_plan = (
                        lambda *a, hb=hb, **k: plan(*a, **k)._replace(
                            head_block=hb))
                call()
                rows = kernel_times(call)
                ours = [t for k, t, _ in rows if any(x in k for x in names)]
                emit(case=f"ssd {model} x (1, {length}, {lm.ssm_heads}, "
                          f"{lm.ssm_head_dim}) N={lm.ssm_state}",
                     head_block=planned if hb is None else hb,
                     ms=event_ms(call, 20),
                     traced_kernel_ms=sum(ours) if ours else None,
                     traced_device_ms=sum(t for _, t, _ in rows) or None,
                     kernels={k[:60]: t for k, t, _ in rows})
                if plan:
                    ssd_scan.launch_plan = plan
            del ops

    if "ssd-bwd" in groups:
        import types

        from chip_smoke import SSD_BWD_CASES
        plan = getattr(ssd_scan, "backward_plan", None)   # None: earlier
        for label, b, length, h, g, n, p, q, final, unpadded in \
                SSD_BWD_CASES:
            if not any(m in label for m in args.match.split(",")):
                continue
            dims = types.SimpleNamespace(ssm_heads=h, ssm_head_dim=p,
                                         ssm_groups=g, ssm_state=n)
            x, dt, a, bm, cm = ssd_operands(b, length, dims, gen)
            dy = torch.randn((b, length, h, p), generator=gen, device=dev)
            dh = (torch.randn((b, h, n, p), generator=gen, device=dev)
                  if final else None)
            if unpadded is not None:
                dt[:, unpadded:] = 0.0
                dy[:, unpadded:] = 0.0
            _, _, scratch, _ = ssd_scan._forward(x, dt, a, bm, cm, q)

            def bwd():
                return ssd_scan.ssd_scan_backward(x, dt, a, bm, cm, dy, dh,
                                                  chunk=q, scratch=scratch)
            blocks = [None] + [int(v) for v in args.ssd_head_blocks.split(",")
                               if v and plan]
            for hb in blocks:
                if plan:
                    ssd_scan.backward_plan = functools.partial(
                        plan, head_block=hb)
                try:
                    bwd()
                    rows = kernel_times(bwd)
                    emit(case=f"ssd-bwd {label} x ({b}, {length}, {h}, {p}) "
                              f"B/C ({b}, {length}, {g}, {n})",
                         ms=event_ms(bwd, 10),
                         kernels={k[:60]: t for k, t, _ in rows
                                  if any(x_ in k for x_ in names)},
                         traced_device_ms=sum(t for _, t, _ in rows) or None,
                         plan=ssd_scan.backward_plan(
                             b, length, h, g, n, p, q)._asdict() if plan
                         else None)
                finally:
                    if plan:
                        ssd_scan.backward_plan = plan
            del x, dt, a, bm, cm, dy, dh, scratch
            torch.cuda.empty_cache()

    if "gather" in groups:
        table_np = gather_table(SERVE_ENGINE)
        table = torch.as_tensor(table_np, device=dev)
        for model, f in GATHER_CASES:
            pool = torch.randn((SERVE_ENGINE["total_pages"] + 1,
                                SERVE_ENGINE["page_size"], f),
                               generator=gen, device=dev).to(torch.bfloat16)
            flat = table.flatten().long()
            emit(case=f"gather {model} pool {tuple(pool.shape)} bf16, table "
                      f"{tuple(table.shape)}, {len(set(table_np.flat))} "
                      f"distinct pages",
                 exact=torch.equal(paged.paged_gather(pool, table).flatten(),
                                   pool.index_select(0, flat).flatten()),
                 ms=event_ms(lambda: paged.paged_gather(pool, table), 20),
                 index_select_ms=event_ms(lambda: pool.index_select(0, flat),
                                          20))
            del pool

    if "fused" in groups:
        model = get_config(GRAPH_MODEL)
        big = ArrayConfig(strip_budget_bytes=GRAPH_BUDGET)
        layer512 = from_model.layer_graph_from_config(model, l=512)
        mlp512 = chains.mlp_graph(l=512, d=model.d_model, f=model.d_ff)
        ggen = torch.Generator(device=dev).manual_seed(2)
        lops = graph_operands(layer512, ggen)
        mops = graph_operands(mlp512, ggen)
        accs = {}
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            acc = graph_executor.build(mlp512, cfg=big, dtype=dtype,
                                       validate=False)
            (gk,) = acc.group_kernels.values()
            lhs = mops["x"].to(dtype)
            rhs_kn = [mops["W1"].to(dtype).T, mops["W2"].to(dtype).T]

            def chain():
                return fused_chain.fused_chain_matmul(
                    lhs, rhs_kn, [mops["b1"]], stages=gk.chain, bm=gk.bm,
                    interleave=gk.interleave)
            plan = getattr(fused_chain, "card_plan", None)
            emit(case=f"fused chain {GRAPH_MODEL} MLP m=512 {name}",
                 ms=event_ms(chain, 10),
                 traced_kernel_ms=traced_ms(chain, names)[0],
                 plan=plan(fused_chain.chain_as_dag(gk.chain, gk.m), dtype,
                           dev).describe() if plan else None)
            acc = graph_executor.build(layer512, cfg=big, dtype=dtype,
                                       validate=False)
            accs[name] = acc
            (gk,) = acc.group_kernels.values()
            exts = [gk._dag_prep(lops[e], role, gk.dtype)
                    for e, role in gk.ext_roles]

            def dag():
                return fused_chain.fused_dag(exts, stages=gk.dag)
            emit(case=f"fused dag {GRAPH_MODEL} layer l=512 {name}",
                 ms=event_ms(dag, 10),
                 traced_kernel_ms=traced_ms(dag, names)[0],
                 plan=plan(gk.dag, dtype, dev).describe() if plan else None)
            levels = getattr(fused_chain, "dependency_levels", None)
            lv = levels(gk.dag) if levels else ()
            for top in range(max(lv, default=0)):
                # the DAG cut after level `top` (a prefix of its stages
                # here), its last stage untapped: the time of each level
                # with its syncs is the step from one cut to the next
                n = sum(1 for v in lv if v <= top)
                if sorted(lv[:n]) != list(lv[:n]) or max(lv[:n]) != top:
                    break
                cut = gk.dag[:n - 1] + (dataclasses.replace(
                    gk.dag[n - 1], tap=-1),)
                emit(case=f"fused dag {GRAPH_MODEL} layer l=512 {name} "
                          f"levels 0-{top}",
                     traced_kernel_ms=traced_ms(lambda: fused_chain.fused_dag(
                         exts, stages=cut), names)[0])
            del exts
        seq = graph_executor.build(layer512, cfg=big, merge=False,
                                   validate=False)
        mlp = graph_executor.build(mlp512, cfg=big, validate=False)
        for label, acc, ops in (
                ("(a) layer l=512", accs["float32"], lops),
                ("(a) layer l=512 bf16", accs["bfloat16"], lops),
                ("(b) mlp l=512", mlp, mops),
                ("(d) layer l=512 merge=False", seq, lops)):
            timed(f"fused graph {label}", lambda: acc(ops))

    if "fused-tiles" in groups:
        model = get_config(GRAPH_MODEL)
        big = ArrayConfig(strip_budget_bytes=GRAPH_BUDGET)
        ggen = torch.Generator(device=dev).manual_seed(3)
        wide = fused_chain.TILES
        for l in (64, 128, 256):
            layer = from_model.layer_graph_from_config(model, l=l)
            ops = graph_operands(layer, ggen)
            for dtype in (torch.float32, torch.bfloat16):
                acc = graph_executor.build(layer, cfg=big, dtype=dtype,
                                           validate=False)
                (gk,) = acc.group_kernels.values()
                exts = [gk._dag_prep(ops[e], role, gk.dtype)
                        for e, role in gk.ext_roles]
                outs = {}
                for tiles in (wide, wide[:1]):
                    fused_chain.TILES = tiles
                    try:
                        def dag():
                            return fused_chain.fused_dag(exts, stages=gk.dag)
                        outs[tiles] = dag()[0].float()
                        emit(case=f"fused dag {GRAPH_MODEL} layer l={l} "
                                  f"{str(dtype)[6:]} tiles "
                                  f"{','.join(map(str, tiles))}",
                             traced_kernel_ms=[traced_ms(dag, names)[0]
                                               for _ in range(3)],
                             plan=fused_chain.card_plan(
                                 gk.dag, dtype, dev).describe())
                    finally:
                        fused_chain.TILES = wide
                a, b = outs.values()
                emit(case=f"fused dag {GRAPH_MODEL} layer l={l} "
                          f"{str(dtype)[6:]} tiles agree",
                     max_abs_diff=(a - b).abs().max().item(),
                     max_abs_out=a.abs().max().item())
                del exts, outs

    if "bsr" in groups or "bsr-order" in groups:
        from chip_smoke import SPARSE, bsr_operands, bsr_pattern
        from repro_torch.core.algebra import Sparsity
        from repro_torch.kernels import bsr_gemm
        plan = getattr(bsr_gemm, "launch_plan", None)   # None: earlier
        for label, name, tensor, shape, block, density in SPARSE:
            ordered = "bsr-order" in groups and label in BSR_ORDER_CASES
            if not any(m in label for m in args.match.split(",")) or not (
                    "bsr" in groups or ordered):
                continue
            acc = repro_torch.generate(
                name, "output_stationary", bounds=SIZES[name],
                sparsity={tensor: Sparsity.random(shape, block, density,
                                                  seed=0)},
                validate=False)
            k = acc.kernel
            ops = {t.name: torch.randint(-4, 5, acc.algebra.tensor_shape(t),
                                         generator=gen, device=dev,
                                         dtype=torch.float32)
                   for t in acc.algebra.inputs}
            acc(ops)                            # builds the CSR arrays
            lhs, rhs = k.form.prepare(k.cast_operands(ops))
            s_op, d_op = bsr_operands(k, lhs, rhs)
            coords, bm, bk, m, n = bsr_pattern(k)

            def run():
                return bsr_gemm.bsr_matmul(s_op, d_op, coords=coords, bm=bm,
                                           bk=bk, bn=128, csr=k._csr)

            def describe():
                return plan(coords, bm, bk, m, n, bsr_gemm.ORDER).describe() \
                    if plan else None
            if "bsr" in groups:
                emit(case=f"bsr {label}",
                     traced_kernel_ms=traced_ms(run, names)[0],
                     ms=event_ms(run, 20),
                     exact=torch.equal(run(), bsr_gemm.bsr_matmul_plain(
                         s_op, d_op, coords=coords, bm=bm, bk=bk,
                         out_dtype=s_op.dtype)),
                     masked_dense_matmul_ms=event_ms(
                         lambda: torch.matmul(lhs, rhs), 20),
                     plan=describe())
            if ordered and plan:
                default = bsr_gemm.ORDER
                for order in ("heaviest", "raster"):
                    bsr_gemm.ORDER = order
                    try:
                        emit(case=f"bsr-order {label} {order}",
                             traced_kernel_ms=[traced_ms(run, names)[0]
                                               for _ in range(3)],
                             ms=event_ms(run, 20), plan=describe())
                    finally:
                        bsr_gemm.ORDER = default
            del ops, lhs, rhs, s_op, d_op

    stt = [g for g in groups if g in GROUPS]
    for name, bounds in SIZES.items():
        if not stt:
            break
        alg = get_algebra(name, **bounds)
        ops = {t.name: torch.randint(-4, 5, alg.tensor_shape(t),
                                     generator=gen, device=dev,
                                     dtype=torch.float32)
               for t in alg.inputs}
        for s in STTS:
            acc = repro_torch.generate(name, s, bounds=bounds,
                                       validate=False)
            for g in stt:
                if acc.template in GROUPS[g]:
                    timed(f"{g} {name} x {s}", lambda: acc(ops))
        del ops

    if "os" in groups:
        gemm = get_algebra("gemm", **SIZES["gemm"])
        ops16 = {t.name: torch.randn(gemm.tensor_shape(t), generator=gen,
                                     device=dev).to(torch.bfloat16)
                 for t in gemm.inputs}
        acc16 = repro_torch.generate("gemm", "output_stationary",
                                     bounds=SIZES["gemm"],
                                     dtype=torch.bfloat16, validate=False)
        timed("os gemm x output_stationary bf16", lambda: acc16(ops16))
        del ops16
        # graph (c) and (d) of chip_smoke.py, sequential on the templates
        model = get_config(GRAPH_MODEL)
        layer512 = from_model.layer_graph_from_config(model, l=512)
        layer64 = from_model.layer_graph_from_config(model, l=64)
        gops = graph_operands(layer512,
                              torch.Generator(device=dev).manual_seed(2))
        for label, g, ops, cfg, merge in (
                ("(c) layer l=64", layer64, {**gops, "x": gops["x"][:64]},
                 ArrayConfig(), True),
                ("(d) layer l=512 merge=False", layer512, gops,
                 ArrayConfig(strip_budget_bytes=GRAPH_BUDGET), False)):
            acc = graph_executor.build(g, cfg=cfg, merge=merge,
                                       validate=False)
            timed(f"os graph {label}", lambda: acc(ops))
    return 0


if __name__ == "__main__":
    sys.exit(main())
