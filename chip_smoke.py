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
   page_size=16, total_pages=512)`` answering 12 greedy requests
   (prompts 128..1536, 8..32 new tokens, numpy seed 0: more requests
   than slots, so freed slots are refilled under load), and mamba2-370m
   (48 layers, state 128, no paged leaf: one page a slot) answering 8
   (16..64 new tokens, seed 1), each from 4 threads through
   ``ContinuousServer``.  Every prefill runs the SSD-scan
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
   and prefill per model are reported;
13. serving the moe, encdec and vlm families at full width
   (``FAMILY_SERVE``), fp32 masters drawn on the card and freed once the
   engine has cast them: mixtral-8x22b (4 of its 56 layers, all alike;
   8 experts, top 2) answering 8 requests (prompts 128..1536, 16..64 new
   tokens, seed 2) over ``SlotEngine(capacity=8, max_context=2048,
   page_size=16, total_pages=512)``; whisper-small (all 12 encoder and
   12 decoder layers) answering 12 (its trained 448-token context,
   prompts 4..64, 16..64 new tokens, seed 3: more requests than slots),
   each with its own
   ``0.1·normal (1500, 768)`` frames; llama-3.2-vision-11b (all 40
   layers, 8 gated cross layers, gates opened to 0.5) answering 8
   (prompts 128..1024, 16..64 new tokens, seed 4), each with its own
   ``0.1·normal (1601, 4096)`` patches; from 4 threads through
   ``ContinuousServer``.  The gather and flash launch counts are zeroed
   before each server run, must be above 0 after it, and are added to
   the kernels line's rows.  Checks (a)–(c) as in phase 12, (b) with
   ``DecodeEngine`` on the engine's cast parameters; the flash kernel at
   each family's shapes (the longest prompt's causal self-attention;
   whisper's encoder (1, 12, 1500, 64) and cross-attention to 1500
   frames; the vision cross-attention to 1601 patches, non-causal) held
   to its plain version as in phase 11 (e), with a planted dropped kv
   block that must exceed the limit; for mixtral each expert's load and
   the dropped share of the longest prefill, and the expert products of
   a decode step beside their bound.  Peak and held device memory,
   step, prefill and flash times, and one traced decode step and
   prefill per model are reported;
14. training h2o-danube-1.8b (``TRAIN_MODEL``), fp32 masters and AdamW
   moments, bf16 compute, remat: (a) the flash backward kernels
   (``flash_bwd_prep_kernel``, then dK/dV and dQ: ``flash_bwd_dkdv_mma_
   kernel`` and ``flash_bwd_dq_mma_kernel`` in bf16, ``flash_bwd_dkdv_
   kernel`` and ``flash_bwd_dq_kernel`` in fp32) against
   ``flash_attention_backward_plain`` at
   ``FLASH_BWD_CASES`` (danube's training shape, a window that hides
   whole kv blocks, whisper's ragged cross shape) in bf16 and fp32, dQ,
   dK and dV within ``FLASH_BWD_TOL`` x max|.|, a second call the same
   bits, a planted fault (dK's first kv block dropped) beyond the limit,
   times beside the bound (2.5x the forward's flops), the plain version
   and SDPA's forward + backward; (b) ``trainer.make_train_step`` at
   all 24 layers, ``TRAIN_STEPS`` steps of ``TRAIN_BATCH`` x
   ``TRAIN_SEQ`` synthetic tokens (``DataConfig(seed=0)``; AdamW from
   ``opt_config_for`` at peak lr ``TRAIN_LR``, 2 warmup steps), the flash
   launch counts zeroed before and read after (both above 0), every loss
   finite, the last below the first, every parameter leaf's step-1
   gradient norm above 0; step time, tokens per second, model FLOPs
   utilisation, peak memory and one traced step; (c) ``TrainDriver`` at
   ``DRIVER_LAYERS`` layers (full width) under ``run_with_restarts``,
   checkpoints every 4 steps in a temp directory (deleted after), a
   failure at step 6: the resumed run's losses of steps 5-8 within 1e-3
   x |loss| of an uninterrupted run's (the embedding's index-add
   backward sums with atomics); (d) one step of that model with the
   flash kernels against the same step with autograd through the plain
   version that rounds P as the kernel does: loss and every gradient
   within 2e-2 x max|.|.  Row 8 of the kernels line gains the backward's
   entry and the training forward launches; ``FLASH_BWD_CASES`` also
   holds zamba2-1.2b's shared block in training (MHA, D = 64);
15. training mamba2-370m and zamba2-1.2b (``SSM_TRAIN``) the same way:
   (a) the SSD backward kernels (``ssd_bwd_dstate_kernel``, the reverse
   carry ``ssd_bwd_state_pass_kernel``, ``ssd_bwd_chunk_kernel``,
   ``ssd_bwd_sum_kernel``) as built (each chunk kernel's CTAs an SM by
   the runtime's occupancy, at least 2, registers and no local memory, at
   N = 64 and 128), then against ``ssd_scan_backward_plain`` at
   ``SSD_BWD_CASES`` (both models' training shapes, 2 groups of 4 heads
   with a final-state gradient, 2000 steps padded to 2048 as
   ``apply_ssm`` pads them, one head a group, 2 groups of 6 heads), each
   with its ``backward_plan`` (heads a CTA, CTAs, shared bytes): every
   gradient within ``SSD_BWD_TOL`` x max|.|, a second call the same bits,
   a planted fault (the middle chunk's entering state zeroed in the
   scratch the kernels read) beyond the limit, times beside the bound and
   the plain version; (b)
   ``trainer.make_train_step`` for each at full width and depth (48
   layers; 38 and the shared block's 6 applications), phase 14's batch,
   steps and optimizer, the SSD forward, SSD backward and (zamba2) flash
   launch counts zeroed before and above 0 after, losses finite and
   falling, every leaf's step-1 gradient norm above 0; step time, tokens
   per second, MFU ((6 N T + the SSD's forward and backward operations
   in every layer + 3 x the shared attention's) / step / 989 TFLOP/s),
   peak memory and one traced step with the SSD's and flash's device
   time; (c) one step of each (mamba2 at 2 layers, zamba2 at 6: its
   first group and shared application; full width, 2 x 2048 tokens)
   with the kernels against the same step with autograd through the
   plain versions (flash rounding P as the kernel does): loss and every
   gradient within 2e-2 x max|.|.  Row 9 of the kernels line gains the
   backward's entry and the training forward launches; row 8 zamba2's
   flash launches;
16. the generator's mesh (``mesh_phase``; the CommPlan interpreter over
   ``torch.distributed``, whose per-shard products are ``torch.matmul``
   as the reference's are einsums, so it adds no kernel row): (a) a
   one-rank NCCL mesh (1x1, this process) running every registry algebra
   at ``SIZES`` under output-stationary through ``generate(...,
   mesh=m)``; (b) four gloo ranks sharing the card on a 2x2 mesh
   (``dist.spawn``; NCCL allows one rank a device) running
   ``mesh_cases``: gemm 4096^3 under identity (SUMMA),
   output-stationary (Cannon), weight-stationary (the stagger) and the
   K-spatial STT, batched_gemv and depthwise_conv at ``SIZES``, sparse
   gemm A (128 x 128 blocks, density 0.25) compressed and masked-dense.
   Every output, on every rank, is a CUDA tensor equal to the
   single-card accelerator's (the templates and the BSR kernel)
   exactly; compressed footprints fall below the dense ones; the Cannon
   case run once more without its last rotation must differ.  Each
   case's strategy, specs, stored bytes a device and host seconds a
   rank are printed (ranks sharing one card over host-staged gloo: not
   a mesh's speed);
17. serving on a model mesh (``model_mesh_phase``): (a) the flash
   forward's ``q_offset`` at danube's heads (a rank's 256 query rows
   over 1024 keys at ``Q_OFFSETS``, bf16 and fp32) against
   ``flash_attention_plain(q_offset=...)``, with a planted fault (the
   offset ignored); then four gloo ranks sharing the card
   (``model_mesh_ranks``): (b) h2o-danube-1.8b at full width and depth,
   fp32, ``explicit_collectives`` on a 2x2 ("data", "model") mesh,
   batch 2 x 512: logits within 2e-3 x max|logit| of the one-card
   forward with the flag off, 8 greedy ``DecodeEngine`` tokens equal to
   one card's, flash launched on every rank; the same at 2 layers with
   ``FULL_SCORES_MAX_LEN`` at 256, through ``chunked_attn_manual`` and
   the kernel's ``q_offset``; (c) mixtral-8x22b at full width, one
   layer, bf16, capacity factor 8, on a 1x2 mesh through ``moe_manual``:
   held token by token (``moe_agreement``: a routing flip moves a token
   by a whole expert output), tokens routed alike within 5e-2 x
   max|logit|, tokens routed apart near ties on one card; (d) the danube
   slot engine (bf16, capacity 4, page 16) over pools placed by
   ``solve_page_placement`` on a 2x2 ("x", "y") mesh: insert/evict churn
   over 16 steps bit-identical to the unsharded engine, the gather
   launched on every rank, one decode build.  The phase prints its
   seconds and each rank's peak memory; its launches join rows 7–8
   (NCCL refuses two ranks on one device and gloo stages through the
   host: no time here is a mesh's speed);
18. a sharded train step on a model mesh (``train_mesh_phase``): (a)
   the flash backward kernels' ``q_offset`` at phase 17's shapes and
   offsets, bf16 and fp32, against ``flash_attention_backward_plain(
   q_offset=...)`` within ``FLASH_BWD_TOL``, with a planted fault (the
   backward without the offset), times beside the bound, the plain
   version and SDPA's forward + backward under the same mask; then four
   gloo ranks sharing the card (``train_mesh_ranks``) on a 2x2 ("data",
   "model") mesh: (b) h2o-danube-1.8b at full width, ``TM_LAYERS``
   layers (depth cut for the script's time, printed), bf16 compute over
   fp32 masters, ``explicit_collectives`` on, the state placed by
   ``trainer.place_state``, each rank holding its blocks and gathering
   a layer while it runs: the first gradient's blocks within 2e-2 x
   max|g| of the one-card gradient's, ``TM_STEPS`` steps of ``TM_BATCH``
   x ``TM_SEQ`` tokens with losses finite and within 1e-3 x |loss| of
   one card's, flash's forward and backward launched on every rank, the
   first step's ``max_memory_allocated`` within ``TM_PEAK_BAND`` x the
   dry run's ``per_device_total`` of the same cut cell on a fake 2x2
   gloo world (``_TM_DRY``, a subprocess), the most gathered bytes alive
   at once printed; (c)
   the same at 2 layers with ``FULL_SCORES_MAX_LEN`` at 256: every
   layer's query rows through ``chunked_attn_manual`` and the backward
   kernels' ``q_offset``.  The phase prints its seconds and each rank's
   peak memory; its launches join row 8 and its backward entry, which
   also gains the offset rows (no time here is a mesh's speed);
19. elastic training on a model mesh (``elastic_ranks`` in phase 18's
   four ranks, then ``elastic_phase``): h2o-danube-1.8b at full width,
   ``EL_LAYERS`` layers, phase 18's precision and batch; ``TrainDriver``
   on a 2x2 ("data", "model") mesh checkpointing every ``EL_EVERY``
   steps fails at step ``EL_FAIL`` and ``run_with_restarts`` restores
   it onto 4x1 for ``EL_STEPS`` steps in all: (a) the losses within
   ``TM_LOSS_TOL`` x |loss| of one card's uninterrupted run, flash's
   forward and backward launched on every rank (counted from 0 over the
   run); (b) every rank's restored blocks bit for bit the checkpoint's
   arrays, with a planted fault (blocks placed at permuted coordinates)
   that must fail that check; (c) the final checkpoint restored onto one
   card with no specs equal bit for bit to the ranks' gathered final
   state, at step ``EL_STEPS``.  The phase prints its seconds, each
   rank's peak memory and the checkpoint write and restore seconds (not
   a mesh's speed: gloo stages through host memory); its launches join
   row 8 and its backward entry;
20. the dry run against the card (``dryrun_phase``): (a) ``python -m
   repro_torch.launch.dryrun`` (a subprocess: the fake world stays out
   of this process) for h2o-danube-1.8b and mamba2-370m at ``train_4k``,
   ``prefill_32k`` and ``decode_32k`` on the 16x16 mesh, each record's
   roofline line printed; (b) the cells of ``DRY_CELLS`` (danube train
   at 2 layers and batch 2, prefill at batch 1 and decode at batch 8 at
   full depth, mamba2's prefill at batch 1 and full depth) dry-run on a
   fake 1x1 world and run for real as one NCCL rank on a 1x1 mesh under
   ``OpAnalysis``: each kernel's launches and the aten dots' operations
   equal exactly, ``max_memory_allocated`` over the call within
   ``DRY_MEM_BAND`` x the dry run's ``per_device_total``; the call's
   time and the profiler's device time by kernel beside the cut cell's
   roofline ``step_time_s``; (c) a planted fault, the dry run of the
   train cell with one layer fewer, must fail (b)'s launch check.  Its
   launches join rows 8–9 and their backward entries;
21. decode on a cache placed by the cell's ``cache_shardings``
   (``placed_decode_phase``): four gloo ranks sharing the card on a 1x4
   ("data", "model") mesh run ``PLACED_DECODE`` (h2o-danube-1.8b 8 of
   24 layers, mamba2-370m 16 of 48, zamba2-1.2b 12 of 38, full width,
   batch
   ``PD_BATCH`` x ``PD_PROMPT`` tokens) in fp32 and in bf16: ``prefill``
   on the mesh (flash and the SSD scan on each rank), then ``PD_STEPS``
   greedy ``decode_step`` s on the cache blocks it returned.  Checks:
   every rank the same logits; in fp32 the tokens equal one card's
   unplaced decode and the logits within ``PD_LOGIT_TOL`` x max|logit|
   of it; in bf16 (the cells' precision; its agreement with one card
   printed) each rank's cache bytes equal the dry run's
   ``spec_cache_bytes`` of the cut decode cell (``run_cell(...,
   mesh_shape=(1, 4))``, a subprocess), each rank's decode peak printed
   beside the dry run's ``per_device_total``.  Its launches join rows
   8–9;
22. the port's example scripts (``examples_phase``, started after phase
   20's timed cells and run beside phases 21 and 23, whose times are
   host-staged gloo's anyway): ``examples/torch_quickstart.py --ranks
   4``, ``torch_serve_lm.py``,
   ``torch_train_lm.py`` and ``torch_dse_explore.py`` on the card, each
   in a subprocess that zeroes the kernels' launch counts before the
   script and prints them after it: exit 0, the reference's success
   lines, and the kernels each script's path runs launched.  Their
   launches join the rows;
23. serving with parameters placed by the cells' ``param_shardings``
   (``placed_params_phase``): four gloo ranks sharing the card on a 2x2
   ("data", "model") mesh, each holding only its blocks
   (``models.placed.place_params``: drawn whole by one rank at a time,
   placed, freed) and gathering each layer over ``data`` alone while it
   runs, each leaf keeping the rank's ``model`` block that the layer
   computes on (the SSM mixer gathered whole, declared), for
   ``PLACED_PARAMS`` (h2o-danube-1.8b, zamba2-1.2b, mixtral-8x22b at 1
   of 56 layers in bf16 only; full width, batch ``PP_BATCH`` x
   ``PP_PROMPT``): in fp32, at the cut depths and steps, tokens equal
   one card's and
   logits within ``PD_LOGIT_TOL`` x max|logit| of it, and danube's
   ``SlotEngine`` built on the mesh returns one card's results with one
   decode build; in bf16 (every leaf, as the cells' parameters; danube
   and zamba2 at full depth) each rank's parameter bytes equal the
   cut cell's ``param_shardings`` blocks, its prefill and decode peaks
   within ``PP_PEAK_BAND`` x the dry run's ``per_device_total`` on a
   fake 2x2 world standing for gloo (``_PP_DRY``, a subprocess), flash
   and the SSD scan launched a rank as that dry run counts them, and the
   outputs held to one card's bf16 run loosely (``PP_BF16_TOL``: a
   rank's batch rows and vocab block change cuBLAS's kernels, so bf16
   logits round apart): logits within it x max|logit| (a step's rows
   only while their tokens so far agree), and a token that differs a
   near tie, one card's logits of both within it.  Every run: each
   rank's ``placed.GATHERED.peak`` over the pass at most the larger of
   one layer's leaves gathered over ``data`` alone and the output
   projection's vocab block, plus the norms (``_pp_gather_bound``, from
   the specs), printed beside one layer gathered whole, which is above
   it for every model of the phase.  Its launches join rows 7–9.

Prints the ``nvidia-smi`` line, one ``{"kernels": [...]}`` JSON line
(nine rows, one per kernel; rows 7–8 carry the family phase's launches
and flash shapes too, rows 8 and 9 the training phases' launches and the
flash and SSD backwards' entries under ``backward``, the flash
backward's with its ``q_offset`` rows),
and, last, ``{"ok": true, "device": {...}}``.  Per-case times go to
``results/chip_smoke/chip_smoke_cases.json`` (gitignored), each with one
more call traced by ``torch.profiler``: the device time of the port's
kernels, of everything else on the device (layout copies, casts,
masks), and the device's busy share of the untraced call time.
"""
from __future__ import annotations

import dataclasses
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
SSD_BWD_KERNELS = ("ssd_bwd_dstate_kernel<", "ssd_bwd_state_pass_kernel",
                   "ssd_bwd_chunk_kernel<", "ssd_bwd_sum_kernel")
FLASH_BWD_KERNELS = ("flash_bwd_prep_kernel<", "flash_bwd_dkdv_kernel<",
                     "flash_bwd_dq_kernel<", "flash_bwd_dkdv_mma_kernel<",
                     "flash_bwd_dq_mma_kernel<")
OUR_KERNELS = ("stt_tile_kernel<", "os_stream_kernel<", "rt_tree_kernel<",
               "os_inplace_kernel<", "ws_kernel<", "ws_tile_kernel<",
               "bsr_tile_kernel<", "stages_kernel<", "gather_kernel<",
               "flash_kernel<", "flash_mma_kernel<") + SSD_KERNELS + \
    FLASH_BWD_KERNELS + SSD_BWD_KERNELS
#: the serve phase: model, slot engine, traffic
SERVE_MODEL = "h2o-danube-1.8b"
SERVE_ENGINE = dict(capacity=8, max_context=2048, page_size=16,
                    total_pages=512)
SERVE_REQUESTS, SERVE_THREADS = 16, 4
PROMPT_LENS, NEW_TOKENS = (128, 1536), (16, 64)
#: the moe, encdec and vlm serve phase: (model, its depth, requests,
#: numpy seed, engine, prompt lengths, new tokens).  mixtral-8x22b runs 4
#: of its 56 layers (every layer has the same pattern; 10.4 B parameters,
#: 41.7 GB of fp32 masters), whisper-small all 12 + 12 at Whisper's
#: trained 448-token context (transcription: 1500 frames, short prompts),
#: llama-3.2-vision-11b all 40 with its 8 gated cross layers.  whisper
#: answers 12 requests on 8 slots, so its cross lanes are refilled under
#: load (16 with 32..128 new tokens until phase 23 needed the time: each
#: request is decoded again alone, 45 ms a step); the traced step fills
#: all 8 slots, so no model answers fewer
FAMILY_SERVE = (
    ("mixtral-8x22b", 4, 8, 2, dict(capacity=8, max_context=2048,
                                    page_size=16, total_pages=512),
     (128, 1536), (16, 64)),
    ("whisper-small", 12, 12, 3, dict(capacity=8, max_context=448,
                                       page_size=16), (4, 64), (16, 64)),
    ("llama-3.2-vision-11b", 40, 8, 4, dict(capacity=8, max_context=2048,
                                            page_size=16, total_pages=512),
     (128, 1024), (16, 64)),
)
#: the SSM serve phase: (model, its depth, requests, numpy seed, engine,
#: new tokens).  zamba2 answers 12 requests on 8 slots, so its SSM lanes
#: and shared pool are refilled under load (16 with 16..64 new tokens
#: until phase 23 needed the time)
SSM_SERVE = (
    ("zamba2-1.2b", 38, 12, 0, dict(capacity=8, max_context=2048,
                                     page_size=16, total_pages=512),
     (8, 32)),
    ("mamba2-370m", 48, 8, 1, dict(capacity=8, max_context=2048,
                                   page_size=16), NEW_TOKENS),
)


#: the training phase: the model (all of its layers, bf16 compute over
#: fp32 masters and AdamW moments), batch x sequence of synthetic tokens
#: (``DataConfig(seed=0)``), steps; the driver cell's depth at full width
TRAIN_MODEL = "h2o-danube-1.8b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 8
#: peak learning rate (2 warmup steps, cosine over 8): from random
#: weights at full width, 1e-3 left the loss within batch noise of its
#: start after 8 steps and 3e-3 diverged (H100 run, 700 W)
TRAIN_LR = 5e-4
DRIVER_LAYERS = 2
#: the flash backward's checks: (label, B, Hq, Hkv, Lq, Lkv, D, causal,
#: window).  The first is the danube training shape (window 4096 over 2048
#: tokens: causal only); the second's 256-token window hides whole kv
#: blocks from later q blocks; the third is whisper's ragged cross shape;
#: the fourth zamba2-1.2b's shared block in training (MHA, D = 64)
FLASH_BWD_CASES = (
    ("danube training", TRAIN_BATCH, 32, 8, TRAIN_SEQ, TRAIN_SEQ, 80, True,
     4096),
    ("window 256", 1, 32, 8, 1024, 1024, 80, True, 256),
    ("ragged cross", 1, 12, 12, 57, 1500, 64, False, None),
    ("zamba2 training", TRAIN_BATCH, 32, 32, TRAIN_SEQ, TRAIN_SEQ, 64, True,
     None),
)
#: the flash backward's tolerance against its plain version, x max|.|:
#: bf16 the reference's bf16 tolerance (the kernels round P and dS to bf16
#: for the tensor cores, the plain version keeps them fp32), fp32 other
#: sum orders and the card's ``exp2f``
FLASH_BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
#: the ssm/hybrid training phase: (model, its depth, check (c)'s depth);
#: batch, steps, lr and optimizer as in phase 14.  (c) runs mamba2-370m at
#: 2 layers and zamba2-1.2b at 6: its first group and the shared block's
#: first application
SSM_TRAIN = (("mamba2-370m", 48, 2), ("zamba2-1.2b", 38, 6))
#: the SSD backward's checks: (label, B, L, H, G, N, P, chunk, with a
#: final-state gradient, the unpadded length).  The first two are the
#: models' training shapes; the third has 2 groups of 4 heads; the fourth
#: pads 2000 steps to 2048 as ``apply_ssm`` does (dt and dy 0 past the
#: end; x, B and C not); the fifth has one head a group; the sixth 2
#: groups of 6 heads, where the plan's block of 4 heads leaves a last
#: block of 2
SSD_BWD_CASES = (
    ("mamba2 training", TRAIN_BATCH, TRAIN_SEQ, 32, 1, 128, 64, 64, False,
     None),
    ("zamba2 training", TRAIN_BATCH, TRAIN_SEQ, 64, 1, 64, 64, 64, False,
     None),
    ("2 groups, final state", 2, 640, 8, 2, 96, 48, 64, True, None),
    ("padded 2000 -> 2048", 1, 2048, 32, 1, 128, 64, 64, False, 2000),
    ("one head a group", 2, 1024, 8, 8, 64, 64, 64, True, None),
    ("2 groups of 6 heads", 2, 2048, 12, 2, 128, 64, 64, False, None),
)
#: the SSD backward against its plain version, x max|.|: fp32 both, other
#: sum orders and the card's ``expf``
SSD_BWD_TOL = 1e-4


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


def device_breakdown(fn, top: int = 8, groups=None):
    """One untraced call of ``fn`` on the host clock, then one traced:
    device time by kernel (the ``top`` largest) and in all, and the busy
    share; ``device_ms`` is None when the trace holds no device events.
    ``groups`` (label -> kernel names) adds each group's device time."""
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
    out = {"call_ms": call_ms, "device_ms": total,
           "busy_share": total / call_ms,
           "kernels": [{"name": k[:90], "ms": ms, "count": n}
                       for k, ms, n in rows[:top]]}
    if groups:
        out["groups"] = {label: sum(ms for k, ms, _ in rows
                                    if any(n in k for n in names))
                         for label, names in groups.items()}
    return out


def serve_traffic(n, seed, vocab, prompt_lens=PROMPT_LENS,
                  new_tokens=NEW_TOKENS):
    """``n`` requests: prompts uniform in ``prompt_lens`` tokens, new
    tokens uniform in ``new_tokens``, from numpy seed ``seed``.  Returns
    (the generator, for later draws; lens; news; prompts)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = rng.integers(prompt_lens[0], prompt_lens[1] + 1, n)
    news = rng.integers(new_tokens[0], new_tokens[1] + 1, n)
    prompts = [rng.integers(0, vocab, (int(s),)).astype(np.int32)
               for s in lens]
    return rng, lens, news, prompts


def run_server(eng, prompts, news, check, frontends=None):
    """Every request (with its frontend array, if any) through a
    ``ContinuousServer`` over ``eng``, submitted from ``SERVE_THREADS``
    client threads.  Returns (tokens per request, seconds, server stats,
    mean occupancy)."""
    import torch

    from repro_torch.serve import ContinuousServer

    n = len(prompts)
    frontends = frontends or [None] * n
    futures = [None] * n
    t0 = time.perf_counter()
    with ContinuousServer(eng) as server:
        def client(ids):
            for i in ids:
                futures[i] = server.submit(prompts[i],
                                           max_new_tokens=int(news[i]),
                                           frontend=frontends[i])
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


def serve_alone(eng, prompts, news, served, check, frontends=None):
    """Checks (a) and (c): each request served alone on the same engine
    gives its continuous tokens; the decode step was built once.  Returns
    (step ms, [(prompt length, prefill ms)]), host clock."""
    import numpy as np
    frontends = frontends or [None] * len(prompts)
    step_ms, prefill_ms = [], []
    for i, prompt in enumerate(prompts):
        t = time.perf_counter()
        res = eng.insert(prompt, max_new_tokens=int(news[i]),
                         frontend=frontends[i])
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


def check_prefill(eng, de, lm, prompts, news, served, check, *, full,
                  frontends=None):
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
    frontends = frontends or [None] * len(prompts)
    diverge = []
    for i, prompt in enumerate(prompts):
        toks = torch.as_tensor(prompt, device=dev).long()[None]
        fe = frontends[i]
        fe = None if fe is None else fe[None]
        fe_dev = None if fe is None else torch.as_tensor(fe, device=dev)
        with torch.no_grad():
            la = lm_decode.prefill(eng.params, toks, lm, frontend=fe_dev,
                                   max_len=max_context)[0]
            lb = lm_decode.prefill(de.params, toks, lm, frontend=fe_dev,
                                   max_len=max_context)[0]
        check(torch.equal(la, lb), f"(b) request {i}: prefill logits of "
              f"the slot engine and DecodeEngine differ")
        want = de.generate(prompt[None], frontend=fe,
                           max_new_tokens=int(news[i]) if full else 1,
                           cache_len=max_context)[0][0]
        check(want[0] == served[i][0], f"(b) request {i}: first token "
              f"{served[i][0]} != DecodeEngine's {want[0]}")
        if full:
            d = np.flatnonzero(want != served[i])
            diverge.append(int(d[0]) if d.size else None)
    return diverge


def trace_step_and_prefill(eng, lm, prompts, lens, check, frontends=None):
    """Fill every slot, then one decode step and the longest prompt's
    prefill, each on the host clock and once more traced."""
    import numpy as np
    import torch

    from repro_torch.models import decode as lm_decode

    dev = torch.device("cuda")
    frontends = frontends or [None] * len(prompts)
    for i in range(eng.capacity):
        check(eng.insert(prompts[i][:128], max_new_tokens=64,
                         frontend=frontends[i]) is not None,
              "could not fill the batch for the traced step")
    eng.step()
    step_prof = device_breakdown(eng.step)
    longest = int(np.argmax(lens))
    pre = torch.as_tensor(prompts[longest], device=dev).long()[None]
    fe = frontends[longest]
    fe = None if fe is None else torch.as_tensor(fe, device=dev)[None]
    with torch.no_grad():
        pre_prof = device_breakdown(lambda: lm_decode.prefill(
            eng.params, pre, lm, frontend=fe, max_len=eng.max_context))
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
    # serving runs the forward only: the backward's count stays 0
    launches = {**paged.launches,
                "flash_attention": flash_attention.launches["flash_attention"]}
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
    roof = hopper.RooflineTerms("paged gather", *paged.cost(
        pool.shape, table.shape, pool.element_size(),
        len(np.unique(table_np))), dtype="bfloat16")
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


def flash_times(hq, hkv, d, length, g, check, *, lq=None, causal=True):
    """The flash kernel on random bf16 q (1, hq, lq, d) and k, v (1, hkv,
    length, d), causal (``lq`` = ``length``) or not (an encoder's
    self-attention, or cross-attention to ``length`` frontend tokens):
    its errors against the plain version that rounds P to bf16 as the
    kernel does (max abs, and ``row_error``, held to ``BF16_ROW_TOL``)
    and against the reference's arithmetic (held to 2e-2 x max|out|);
    the errors of a planted fault, a kv block hidden from the last q
    rows, against the same plain version (its row error must exceed the
    limit); the kernel's time, the plain version's, SDPA's and the bound
    (4 d flops an unmasked pair and q head, bf16 tensor cores)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import hopper
    from repro_torch.kernels import flash_attention as fa

    lq = length if lq is None else lq
    q, k, v = [torch.randn((1, h, n, d), generator=g,
                           device=torch.device("cuda")).to(torch.bfloat16)
               for h, n in ((hq, lq), (hkv, length), (hkv, length))]
    shape = (f"q (1, {hq}, {lq}, {d}), k/v (1, {hkv}, {length}, {d}) "
             f"bf16, {'causal' if causal else 'non-causal'}")
    got = fa.flash_attention(q, k, v, causal=causal)
    want = fa.flash_attention_plain(q, k, v, causal=causal, round_p=True)
    errs = bf16_flash_errors(got, want, fa.flash_attention_plain(
        q, k, v, causal=causal), check, shape)
    # the middle kv block (half the keys when there are fewer than 128),
    # hidden from the last 64 q rows or, causal, from the rows that see
    # past it
    width = min(64, length // 2)
    k0 = length // 2 // 64 * 64
    fault = dropped_block(q, k, v, max(lq - 64, k0 + width if causal else 0),
                          k0, width, causal=causal)
    fault_row = fa.row_error(fault, want)
    check(fault_row > fa.BF16_ROW_TOL,
          f"flash {shape}: a dropped kv block reads {fault_row}, inside "
          f"BF16_ROW_TOL {fa.BF16_ROW_TOL}")
    roof = hopper.RooflineTerms(
        "flash attention", *fa.cost(1, hq, hkv, lq, length, d,
                                    causal=causal), dtype="bfloat16")
    return {
        **errs, "fault_row_err": fault_row,
        "fault_max_abs_err": (fault.float() - want.float()).abs().max().item(),
        "ms": event_ms(lambda: fa.flash_attention(q, k, v, causal=causal),
                       10),
        "plain_ms": event_ms(lambda: fa.flash_attention_plain(
            q, k, v, causal=causal, round_p=True), 3),
        "bound_ms": roof.bound_s * 1e3, "bound_by": roof.bound_by,
        "library_ms": event_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=hq != hkv), 10),
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


def dropped_block(q, k, v, rows, k0, width=64, *, causal=True):
    """A planted fault for the tolerance's self-check: attention in fp32
    (causal, or not) with kv columns [k0, k0 + width) hidden from q rows
    >= ``rows`` (a kv block a faulty kernel skips)."""
    import torch

    from repro_torch.kernels import ref

    lq, lkv, group = q.shape[2], k.shape[2], q.shape[1] // k.shape[1]
    kf, vf = (x.float().repeat_interleave(group, dim=1) for x in (k, v))
    scores = torch.matmul(q.float(), kf.transpose(-1, -2)) / q.shape[3] ** 0.5
    mask = ref.attention_mask(lq, lkv, causal=causal, window=None,
                              device=q.device)
    mask[rows:, k0:k0 + width] = False
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
    """The SSD's least time on the card (fp32 on the CUDA cores), from
    ``kernels.ssd_scan.cost``: per chunk C B^T's lower triangle once per
    group, per head its masked product with x, the inter-chunk term and
    the state update; x, dt, a, y, B and C per group and the final state
    read or written once."""
    from repro_torch.core import hopper
    from repro_torch.kernels import ssd_scan
    return hopper.RooflineTerms("ssd scan", *ssd_scan.cost(
        bsz, length, lm.ssm_heads, lm.ssm_groups, lm.ssm_state,
        lm.ssm_head_dim, chunk), dtype="float32")


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
    for model, depth, n, seed, engine_kw, news_r in SSM_SERVE:
        lm = get_config(model)
        check(lm.n_layers == depth and lm.dtype == "bfloat16",
              f"{model}: not full depth in bf16")
        t0 = time.perf_counter()
        params = init_params(torch.Generator(device=dev).manual_seed(0), lm)
        eng = SlotEngine(params, lm, **engine_kw)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        rng, lens, news, prompts = serve_traffic(n, seed, lm.vocab,
                                                 new_tokens=news_r)
        hybrid = lm.family == "hybrid"

        # the main path: the requests from 4 threads through the server
        ssd_scan.reset_launches()
        flash_attention.reset_launches()
        paged.reset_launches()
        served, serve_s, stats, occupancy = run_server(eng, prompts, news,
                                                       check)
        launches = {"ssd_scan": ssd_scan.launches["ssd_scan"],
                    **paged.launches, "flash_attention":
                    flash_attention.launches["flash_attention"]}
        must = (launches if hybrid else {"ssd_scan": launches["ssd_scan"]})
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


def moe_load(eng, lm, prompt, check):
    """The MoE's routing on one prefill of ``prompt``: per layer, the
    choices each expert kept and the share of choices dropped by the
    capacity race.  Reads ``mlp._dispatch``'s results during the call."""
    import torch

    from repro_torch.models import decode as lm_decode
    from repro_torch.models import mlp

    real, seen = mlp._dispatch, []

    def spy(top_idx, n_experts, capacity):
        out = real(top_idx, n_experts, capacity)
        seen.append((top_idx, out[1], capacity))
        return out

    mlp._dispatch = spy
    try:
        with torch.no_grad():
            lm_decode.prefill(eng.params, torch.as_tensor(
                prompt, device=torch.device("cuda")).long()[None], lm,
                max_len=eng.max_context)
    finally:
        mlp._dispatch = real
    check(len(seen) == lm.n_layers, f"moe load: {len(seen)} MoE calls for "
          f"{lm.n_layers} layers")
    layers = []
    for top_idx, keep, cap in seen:
        chosen = torch.bincount(top_idx.flatten(), minlength=lm.n_experts)
        kept = torch.bincount(top_idx[keep], minlength=lm.n_experts)
        layers.append({"capacity": cap, "chosen": chosen.tolist(),
                       "kept": kept.tolist(),
                       "dropped_share": 1.0 - kept.sum().item()
                       / top_idx.numel()})
    return {"prompt_len": len(prompt), "layers": layers,
            "dropped_share": sum(x["dropped_share"] for x in layers)
            / len(layers)}


def moe_step_ms(eng, lm, check):
    """The expert products of one decode step at full occupancy: every
    layer's ``apply_moe`` on (capacity, 1, d) bf16, timed with CUDA
    events, beside the bound of reading every expert's three weights
    once (a step reads them all: with top-2 of 8 over 8 slots, nearly
    every expert has a token)."""
    import torch

    from repro_torch.core import hopper
    from repro_torch.models import mlp
    from repro_torch.models.transformer import layer_params

    g = torch.Generator(device=torch.device("cuda")).manual_seed(5)
    x = torch.randn((eng.capacity, 1, lm.d_model), generator=g,
                    device=torch.device("cuda")).to(torch.bfloat16)
    ffn = [layer_params(eng.params["layers"]["ffn"], i)
           for i in range(lm.n_layers)]

    def step():
        for p in ffn:
            mlp.apply_moe(p, x, lm)
    nbytes = sum(p[w].numel() * p[w].element_size() for p in ffn
                 for w in ("wg", "wu", "wd"))
    roof = hopper.RooflineTerms("moe decode", 0.0, float(nbytes),
                                dtype="bfloat16")
    ms = event_ms(step, 10)
    check(ms > 0, "moe step time")
    return {"ms": ms, "bound_ms": roof.bound_s * 1e3,
            "gbytes": nbytes / 1e9}


def family_serve_phase(check):
    """Phase 13: serving the moe, encdec and vlm families (``FAMILY_SERVE``)
    at full width on the flash and paged-gather kernels.  Returns (the
    launches of both kernels over the three server runs, the flash times
    at the non-causal and cross shapes, summary)."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention, paged
    from repro_torch.models import init_params
    from repro_torch.serve import DecodeEngine, SlotEngine

    dev = torch.device("cuda")
    summary, flash_rows = {}, []
    # an engine and its decode step refer to each other: only the cycle
    # collector frees an earlier model, and two of these do not fit at once
    gc.collect()
    torch.cuda.empty_cache()
    total = {"paged_gather": 0, "flash_attention": 0}
    for model, depth, n, seed, engine_kw, lens_r, news_r in FAMILY_SERVE:
        torch.cuda.reset_peak_memory_stats()
        full = get_config(model)
        lm = dataclasses.replace(full, n_layers=depth)
        check(lm.dtype == "bfloat16", f"{model}: not bf16")
        t0 = time.perf_counter()
        params = init_params(torch.Generator(device=dev).manual_seed(0), lm)
        if lm.family == "vlm":
            params["cross_layers"]["gate"].fill_(0.5)   # the image matters
        eng = SlotEngine(params, lm, **engine_kw)
        del params                 # the fp32 masters: the engine cast them
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        setup_s = time.perf_counter() - t0
        rng, lens, news, prompts = serve_traffic(n, seed, lm.vocab, lens_r,
                                                 news_r)
        fes = [None] * n
        if lm.frontend_tokens:
            fes = [(0.1 * rng.standard_normal(
                (lm.frontend_tokens, lm.d_model), dtype=np.float32))
                for _ in range(n)]

        # the main path: the requests from 4 threads through the server
        flash_attention.reset_launches()
        paged.reset_launches()
        served, serve_s, stats, occupancy = run_server(eng, prompts, news,
                                                       check, fes)
        launches = {**paged.launches, "flash_attention":
                    flash_attention.launches["flash_attention"]}
        for name, count in launches.items():
            check(count > 0, f"the {model} serve path never launched {name}")
            total[name] += count
        n_tokens = int(news.sum())
        print(f"family serve {model} ({lm.family}, {depth} of "
              f"{full.n_layers} layers): {n} requests ({n_tokens} tokens) "
              f"in {serve_s:.2f} s, {n_tokens / serve_s:.1f} tok/s; steps "
              f"{stats['steps']}, mean occupancy {occupancy:.2f}, admission "
              f"stalls {stats['admission_stalls']}; launches {launches}; "
              f"memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB "
              f"peak, {torch.cuda.memory_allocated() / 1e9:.1f} GB held")

        # (a), (c); (b) on the prefill logits and the first token, with
        # DecodeEngine on the engine's cast parameters
        step_ms, prefill_ms = serve_alone(eng, prompts, news, served, check,
                                          fes)
        de = DecodeEngine(eng.params, lm)
        check_prefill(eng, de, lm, prompts, news, served, check, full=False,
                      frontends=fes)
        del de
        print(f"family serve checks {model}: (a) continuous == alone for "
              f"{n} requests, (b) prefill logits and first token == "
              f"DecodeEngine, (c) decode_compiles 1")
        part = {"layers": depth, "setup_s": setup_s, "serve_s": serve_s,
                "tokens": n_tokens, "tok_per_s": n_tokens / serve_s,
                "server_stats": stats, "mean_occupancy": occupancy,
                "launches": launches, "prefill_ms": prefill_ms,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}

        # the flash kernel at the shapes this family launched
        g = torch.Generator(device=dev).manual_seed(3)
        hq, hkv, d = lm.n_heads, lm.n_kv_heads, lm.head_dim
        longest = int(lens.max())
        cases = [("self, causal", dict(length=longest))]
        if lm.family == "encdec":
            cases += [("encoder", dict(length=lm.frontend_tokens,
                                       causal=False)),
                      ("cross", dict(length=lm.frontend_tokens, lq=longest,
                                     causal=False))]
        if lm.family == "vlm":
            cases += [("cross", dict(length=lm.frontend_tokens, lq=longest,
                                     causal=False))]
        part["flash"] = {}
        for label, kw in cases:
            t = flash_times(hq, hkv, d, g=g, check=check, **kw)
            part["flash"][label] = t
            if kw.get("causal", True) is False:
                flash_rows.append({"model": model, "case": label, **t})
            print(f"family serve {model}: flash {label} {t['shape']}: "
                  f"{t['ms']:.4f} ms (bound {t['bound_ms']:.4f}, plain "
                  f"{t['plain_ms']:.3f}, SDPA {t['library_ms']:.4f}); row "
                  f"error {t['row_err']:.3e} (limit "
                  f"{flash_attention.BF16_ROW_TOL}), a dropped kv block "
                  f"{t['fault_row_err']:.3e}")
        if lm.family == "moe":
            part["moe_load"] = load = moe_load(
                eng, lm, prompts[int(np.argmax(lens))], check)
            for i, lay in enumerate(load["layers"]):
                print(f"family serve {model}: layer {i} prefill "
                      f"L={load['prompt_len']} capacity {lay['capacity']}: "
                      f"chosen {lay['chosen']}, kept {lay['kept']}, "
                      f"dropped {lay['dropped_share']:.3f}")
            part["moe_step"] = ms = moe_step_ms(eng, lm, check)
            print(f"family serve {model}: the expert products of a decode "
                  f"step ({depth} layers): {ms['ms']:.3f} ms, bound "
                  f"{ms['bound_ms']:.3f} ms (bytes: {ms['gbytes']:.2f} GB "
                  f"of expert weights)")

        # one decode step at full occupancy and one prefill, traced
        step_prof, pre_prof = trace_step_and_prefill(eng, lm, prompts, lens,
                                                     check, fes)
        part["decode_step_ms"] = report_times(
            f"family serve {model}", step_ms, prefill_ms, step_prof,
            pre_prof, longest)
        part["traced_step"] = step_prof
        part["traced_prefill"] = {"len": longest, **pre_prof}
        summary[model] = part
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return total, flash_rows, summary


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


def flash_backward_check(case, dtype, g, check):
    """Check (a): the flash backward kernels against
    ``flash_attention_backward_plain`` on the kernel forward's output and
    log-sum-exp, with random dO: dQ, dK and dV within ``FLASH_BWD_TOL`` x
    max|.|, a second call the same bits, and a planted fault (dK with its
    first kv block dropped, the block most q rows see) beyond the limit.
    Times: the backward, its plain version, and at the training shapes
    (danube's, zamba2's) SDPA's forward + backward as the library
    yardstick; the bound counts 2.5x the forward's 4 D flops a visible
    pair and q head."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import hopper
    from repro_torch.kernels import flash_attention as fa

    label, b, hq, hkv, lq, lkv, d, causal, window = case
    name = str(dtype)[6:]
    dev = torch.device("cuda")
    q, k, v, dout = [torch.randn(shape, generator=g, device=dev).to(dtype)
                     for shape in ((b, hq, lq, d), (b, hkv, lkv, d),
                                   (b, hkv, lkv, d), (b, hq, lq, d))]
    out, lse = fa._forward(q, k, v, causal, window, with_lse=True)

    def run():
        return fa.flash_attention_backward(q, k, v, out, dout, lse,
                                           causal=causal, window=window)

    def plain():
        return fa.flash_attention_backward_plain(
            q, k, v, out, dout, lse, causal=causal, window=window)
    got, want = run(), plain()
    tol = FLASH_BWD_TOL[name]
    errs = {}
    for what, x, w in zip(("dq", "dk", "dv"), got, want):
        scale = w.float().abs().max().item()
        err = (x.float() - w.float()).abs().max().item()
        check(bool(torch.isfinite(x.float()).all()) and err <= tol * scale,
              f"flash backward {label} {name}: {what} max err {err} beyond "
              f"{tol} x {scale}")
        errs[what] = err / scale
    again = run()
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          f"flash backward {label} {name}: two calls differ")
    fault = want[1].clone()
    fault[:, :, :64] = 0
    fault_err = ((fault.float() - want[1].float()).abs().max().item()
                 / want[1].float().abs().max().item())
    check(fault_err > tol, f"flash backward {label} {name}: a dropped kv "
          f"block reads {fault_err}, inside the tolerance {tol}")
    roof = hopper.RooflineTerms(f"flash backward {label}", *fa.cost(
        b, hq, hkv, lq, lkv, d, causal=causal, window=window,
        itemsize=q.element_size(), backward=True), dtype=name)
    row = {"case": label, "dtype": name, "rel_err": errs,
           "max_abs_err": max((x.float() - w.float()).abs().max().item()
                              for x, w in zip(got, want)),
           "fault_rel_err": fault_err, "ms": event_ms(run, 3),
           "plain_ms": event_ms(plain, 1), "bound_ms": roof.bound_s * 1e3,
           "bound_by": roof.bound_by, "library_ms": None,
           "shape": f"q ({b}, {hq}, {lq}, {d}), k/v ({b}, {hkv}, {lkv}, "
                    f"{d}) {name}, {'causal' if causal else 'non-causal'}"
                    f"{'' if window is None else f', window {window}'}"}
    row["sdpa_backward_ms"] = None
    if label.endswith("training"):
        qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))

        def sdpa():
            o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                               enable_gqa=hq != hkv)
            torch.autograd.grad(o, (qs, ks, vs), dout)
        row["library_ms"] = event_ms(sdpa, 3)
        row["sdpa_backward_ms"] = sdpa_backward_ms(
            lambda: F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=causal, enable_gqa=hq != hkv),
            (qs, ks, vs), dout)
    del q, k, v, dout, out, lse, got, want, again, fault
    torch.cuda.empty_cache()
    print(f"train checks: (a) flash backward {row['shape']}: rel errors "
          f"{ {k: f'{e:.2e}' for k, e in errs.items()} }, fault "
          f"{fault_err:.3f}, {row['ms']:.3f} ms (bound {row['bound_ms']:.4f}"
          f" {row['bound_by']}, plain {row['plain_ms']:.3f}, SDPA fwd+bwd "
          f"{row['library_ms']}, SDPA bwd alone {row['sdpa_backward_ms']})")
    return row


def sdpa_backward_ms(forward, inputs, dout, reps=3):
    """CUDA-event ms of SDPA's backward alone: ``forward()``'s graph
    built once, then ``autograd.grad`` of its output over ``inputs``
    timed with ``retain_graph``."""
    import torch
    o = forward()
    ms = event_ms(lambda: torch.autograd.grad(o, inputs, dout,
                                              retain_graph=True), reps)
    del o
    return ms


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def train_steps(step, init, batch, tag, check):
    """``TRAIN_STEPS`` calls of ``step`` on ``batch(i)`` from the state
    ``init()`` makes (made here: a caller holding the first state would
    keep a second copy of the masters and moments alive over every
    step), each timed on the host clock between synchronizes, with the
    peak device memory over them.  Checks every loss finite, the last
    below the first, and every parameter leaf's step-1 gradient norm
    above 0.  Returns (state, losses, step ms, grad norms, step 1's
    gradient norm by leaf, peak GB)."""
    import numpy as np
    import torch

    from repro_torch.train import trainer

    state = init()
    grad_norms = {}
    real_update = trainer.adamw.apply_updates

    def recording_update(params, grads, st, oc):
        if not grad_norms:          # step 1's gradients, leaf by leaf
            grad_norms.update({p: x.float().norm().item()
                               for p, x in _leaves(grads)})
        return real_update(params, grads, st, oc)
    trainer.adamw.apply_updates = recording_update
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, gnorms = [], [], []
    try:
        for i in range(TRAIN_STEPS):
            b = batch(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, b)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(metrics["loss"]))
            gnorms.append(float(metrics["grad_norm"]))
    finally:
        trainer.adamw.apply_updates = real_update
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(np.isfinite(losses)), f"{tag}: non-finite losses {losses}")
    check(losses[-1] < losses[0], f"{tag}: the loss did not fall: {losses}")
    zero = sorted(p for p, n in grad_norms.items() if not n > 0)
    check(len(grad_norms) > 0 and not zero,
          f"{tag}: leaves without a gradient after step 1: {zero}")
    return state, losses, step_ms, gnorms, grad_norms, peak_gb


def train_phase(check):
    """Phase 14: training h2o-danube-1.8b on the card.  (a) the flash
    backward kernels at ``FLASH_BWD_CASES``; (b) ``make_train_step`` at
    full width and depth, ``TRAIN_STEPS`` steps of ``TRAIN_BATCH`` x
    ``TRAIN_SEQ`` synthetic tokens, with the flash launch counts zeroed
    before and read after; (c) ``TrainDriver`` at ``DRIVER_LAYERS`` layers
    under ``run_with_restarts`` with a failure injected at step 6 and
    checkpoints every 4 steps, against an uninterrupted run; (d) one step
    of the same 2-layer model with the flash kernels against the same
    step with the plain attention.  Returns (the backward's kernels-line
    entry, the forward's launches in (b), summary)."""
    import dataclasses
    import gc
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, _batch_numpy
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.specs import opt_config_for
    from repro_torch.models import init_params
    from repro_torch.runtime.driver import (RunConfig, TrainDriver,
                                            run_with_restarts)
    from repro_torch.train import trainer

    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    summary = {}

    # (a) the backward kernels against their plain version
    g = torch.Generator(device=dev).manual_seed(14)
    rows = [flash_backward_check(case, dtype, g, check)
            for case in FLASH_BWD_CASES
            for dtype in (torch.bfloat16, torch.float32)]
    summary["flash_backward"] = rows

    # (b) the full-depth trainer
    cfg = get_config(TRAIN_MODEL)
    check(cfg.remat and cfg.dtype == "bfloat16",
          f"{TRAIN_MODEL}: expected remat and bf16 compute")
    opt_cfg = dataclasses.replace(opt_config_for(cfg), lr=TRAIN_LR,
                                  warmup_steps=2, total_steps=TRAIN_STEPS)
    print(f"train: {cfg.name}, {cfg.n_layers} layers, "
          f"{cfg.param_count() / 1e9:.3f} B parameters, batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}; {opt_cfg}")
    data = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=0)

    def batch(i):
        return {k: torch.as_tensor(v, device=dev)
                for k, v in _batch_numpy(data, i).items()}
    step = trainer.make_train_step(cfg, opt_cfg)
    fa.reset_launches()
    state, losses, step_ms, gnorms, grad_norms, peak_gb = train_steps(
        step, lambda: trainer.init_state(
            torch.Generator(device=dev).manual_seed(0), cfg, opt_cfg),
        batch, "train", check)
    train_launches = dict(fa.launches)
    for name, count in train_launches.items():
        check(count > 0, f"the training phase never launched {name}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    pairs = fa.visible_pairs(TRAIN_SEQ, TRAIN_SEQ, True, cfg.swa_window)
    attn_flops = 3 * 4.0 * cfg.head_dim * cfg.n_heads * TRAIN_BATCH * pairs \
        * cfg.n_layers
    model_flops = 6.0 * cfg.param_count() * tokens + attn_flops
    steady = float(np.median(step_ms[1:]))
    mfu = model_flops / (steady / 1e3) / 989e12
    prof = device_breakdown(lambda: step(state, batch(TRAIN_STEPS)), top=12)
    summary["trainer"] = {
        "losses": losses, "grad_norms": gnorms, "step_ms": step_ms,
        "steady_step_ms": steady,
        "tokens_per_s": tokens / (steady / 1e3), "mfu": mfu,
        "model_tflop": model_flops / 1e12, "peak_gb": peak_gb,
        "launches": train_launches, "grad_leaves": len(grad_norms),
        "traced_step": prof}
    print(f"train: losses {[round(x, 4) for x in losses]}; grad norms "
          f"{[round(x, 3) for x in gnorms]}; step ms "
          f"{[round(x, 1) for x in step_ms]}; median {steady:.1f} ms, "
          f"{tokens / (steady / 1e3):.0f} tokens/s, MFU {mfu:.3f} "
          f"({model_flops / 1e12:.1f} TFLOP a step, 989 TFLOP/s); peak "
          f"{peak_gb:.1f} GB; launches {train_launches}; "
          f"{len(grad_norms)} leaves with a gradient")
    if prof["device_ms"] is None:
        print("  traced step: no device events")
    else:
        print(f"  traced step: call {prof['call_ms']:.1f} ms, device "
              f"{prof['device_ms']:.1f} ms, busy {prof['busy_share']:.2f}")
        for kr in prof["kernels"]:
            print(f"    {kr['ms']:8.3f} ms x{kr['count']:<5d} "
                  f"{kr['name'][:100]}")
    del state, step
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the driver: a failure at step 6, checkpoints every 4
    small = dataclasses.replace(cfg, n_layers=DRIVER_LAYERS)
    small_opt = dataclasses.replace(opt_cfg, total_steps=8)
    runs = {}
    for label, fail in (("uninterrupted", None), ("failure at 6", 6)):
        root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        made = []

        def make():
            made.append(1)
            return TrainDriver(
                small, small_opt, data,
                RunConfig(total_steps=8, ckpt_every=4, log_every=1,
                          ckpt_dir=root, keep_ckpts=1),
                failure_at=fail if len(made) == 1 else None)
        t0 = time.perf_counter()
        try:
            out = run_with_restarts(make, max_restarts=1)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        out["s"] = time.perf_counter() - t0
        runs[label] = out
        gc.collect()
        torch.cuda.empty_cache()
    whole, resumed = runs["uninterrupted"], runs["failure at 6"]
    check(resumed["restarts"] == 1 and resumed["final_step"] == 8,
          f"driver: restarts {resumed['restarts']}, final step "
          f"{resumed['final_step']}")
    lw = {m["step"]: m["loss"] for m in whole["metrics"]}
    # the restarted driver's log: steps 5..8, from the step-4 checkpoint
    lr_ = {m["step"]: m["loss"] for m in resumed["metrics"]}
    check(sorted(lr_) == [5, 6, 7, 8], f"driver: resumed steps {sorted(lr_)}")
    diffs = {s: abs(lr_[s] - lw[s]) / abs(lw[s]) for s in lr_}
    check(max(diffs.values()) <= 1e-3,
          f"driver: resumed losses {lr_} against {lw}")
    summary["driver"] = {
        "uninterrupted": lw, "resumed": lr_, "rel_diffs": diffs,
        "bit_identical": all(lr_[s] == lw[s] for s in lr_),
        "seconds": {k: r["s"] for k, r in runs.items()}}
    print(f"train checks: (c) driver at {DRIVER_LAYERS} layers resumed from "
          f"step 4 after a failure at 6: losses {lr_} against {lw}, "
          f"largest rel diff {max(diffs.values()):.2e}, bit-identical "
          f"{summary['driver']['bit_identical']}; "
          f"{ {k: round(r['s'], 1) for k, r in runs.items()} } s")

    # (d) the flash kernels against the plain attention, one step
    params = init_params(torch.Generator(device=dev).manual_seed(1), small)
    b = {k: v[:2] for k, v in batch(0).items()}
    fa.reset_launches()
    loss_k, _, grads_k = trainer.value_and_grad(params, b, small)
    kernel_launches = dict(fa.launches)
    real_flash = fa.flash_attention

    def plain_attention(q, k, v, *, causal=True, window=None, q_offset=0):
        # the kernels' stated arithmetic (P rounded to bf16 before P V),
        # differentiated by autograd
        return fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window, round_p=True,
                                        q_offset=q_offset)
    fa.flash_attention = plain_attention
    try:
        fa.reset_launches()
        loss_p, _, grads_p = trainer.value_and_grad(params, b, small)
        plain_launches = dict(fa.launches)
    finally:
        fa.flash_attention = real_flash
    check(all(n > 0 for n in kernel_launches.values()) and
          not any(plain_launches.values()),
          f"(d): launches {kernel_launches} (kernels), {plain_launches} "
          f"(plain)")
    loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    check(loss_err <= 2e-2, f"(d): loss {float(loss_k)} against "
          f"{float(loss_p)}")
    grad_errs = {}
    for (path, gk), (_, gp) in zip(_leaves(grads_k), _leaves(grads_p)):
        scale = gp.float().abs().max().item()
        grad_errs[path] = (gk.float() - gp.float()).abs().max().item() / scale
        check(grad_errs[path] <= 2e-2, f"(d): gradient {path} rel err "
              f"{grad_errs[path]} beyond 2e-2")
    summary["plain_route"] = {"loss": [float(loss_k), float(loss_p)],
                              "loss_rel_err": loss_err,
                              "grad_rel_errs": grad_errs}
    print(f"train checks: (d) {DRIVER_LAYERS} layers, flash kernels "
          f"against plain attention: loss {float(loss_k):.5f} / "
          f"{float(loss_p):.5f}, largest gradient rel err "
          f"{max(grad_errs.values()):.2e} ({max(grad_errs, key=grad_errs.get)})")
    del params, grads_k, grads_p
    gc.collect()
    torch.cuda.empty_cache()

    main = next(r for r in rows if r["case"] == "danube training"
                and r["dtype"] == "bfloat16")
    entry = {
        "name": "flash_attention.flash_attention_backward", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "none: the port's own kernel (the reference "
                    "differentiates its XLA attention)",
        "launches": train_launches["flash_attention_backward"],
        **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms", "sdpa_backward_ms",
                                "shape")},
        "other_shapes": [r for r in rows if r is not main]}
    return entry, train_launches["flash_attention"], summary


def ssd_backward_roofline(bsz, length, heads, groups, state, head_dim,
                          chunk, final):
    """The SSD backward's least time on the card (fp32 on the CUDA
    cores), from ``kernels.ssd_scan.cost(backward=True)``, counted as
    ``csrc/ssd_scan.cu``'s note counts it.  (Until the head-block design
    the count held the two triangles with N per head: 23.8 GFLOP, 0.355
    ms, at mamba2-370m's training shape, for 19.6 GFLOP, 0.292 ms,
    now.)"""
    from repro_torch.core import hopper
    from repro_torch.kernels import ssd_scan
    return hopper.RooflineTerms("ssd backward", *ssd_scan.cost(
        bsz, length, heads, groups, state, head_dim, chunk, backward=True,
        final=final), dtype="float32")


def ssd_backward_built(check):
    """The SSD backward's chunk kernels as built, at both state widths
    (the library's ``ssd_scan_backward_info``): shared bytes equal to
    ``backward_plan``'s, CTAs an SM by the runtime's occupancy (at least
    2: 16 warps), registers a thread, and no local (spilled) memory."""
    import ctypes

    from repro_torch.kernels import _build, ssd_scan

    built = {}
    for n in (64, 128):
        out = (ctypes.c_int * 8)()
        code = _build.library("ssd_scan").ssd_scan_backward_info(n, out)
        check(code == 0, f"ssd_scan_backward_info({n}): CUDA error {code}")
        plan = ssd_scan.backward_plan(TRAIN_BATCH, TRAIN_SEQ, 32, 1, n, 64,
                                      64)
        info = {kernel: {"shared_bytes": out[k], "ctas_per_sm": out[k + 1],
                         "registers": out[k + 2], "local_bytes": out[k + 3]}
                for kernel, k in (("ssd_bwd_chunk_kernel", 0),
                                  ("ssd_bwd_dstate_kernel", 4))}
        chunk = info["ssd_bwd_chunk_kernel"]
        check(chunk["shared_bytes"] == plan.chunk_smem
              and info["ssd_bwd_dstate_kernel"]["shared_bytes"]
              == plan.dstate_smem, f"ssd backward N={n}: shared bytes "
              f"{out[0]}, {out[4]} against the plan's {plan.chunk_smem}, "
              f"{plan.dstate_smem}")
        check(chunk["ctas_per_sm"] >= 2, f"ssd backward N={n}: "
              f"{chunk['ctas_per_sm']} chunk-kernel CTAs an SM, not 2")
        check(all(v["local_bytes"] == 0 for v in info.values()),
              f"ssd backward N={n}: local memory {info}")
        built[f"N={n}"] = info
        print(f"ssm train checks: (a) ssd backward kernels at N={n}: "
              + "; ".join(f"{k} {v['shared_bytes']} shared bytes, "
                          f"{v['ctas_per_sm']} CTAs an SM, "
                          f"{v['registers']} registers, "
                          f"{v['local_bytes']} local bytes"
                          for k, v in info.items()))
    return built


def ssd_backward_check(case, g, check):
    """Check (a): the SSD backward kernels against
    ``ssd_scan_backward_plain`` on random operands in the models' ranges
    and random dy (and final-state gradient): every gradient within
    ``SSD_BWD_TOL`` x max|.|, a second call the same bits, and a planted
    fault (the forward's entering state of the middle chunk zeroed in the
    scratch the kernels read) beyond the limit.  Times: the kernels (given
    the forward's scratch), the plain version; no PyTorch call computes
    the SSD's gradient."""
    import types

    import torch

    from repro_torch.kernels import ssd_scan

    label, b, length, h, gr, n, p, q, final, unpadded = case
    dev = torch.device("cuda")
    dims = types.SimpleNamespace(ssm_heads=h, ssm_head_dim=p,
                                 ssm_groups=gr, ssm_state=n)
    x, dt, a, bm, cm = ssd_operands(b, length, dims, g)
    dy = torch.randn((b, length, h, p), generator=g, device=dev)
    dh = (torch.randn((b, h, n, p), generator=g, device=dev) if final
          else None)
    if unpadded is not None:
        dt[:, unpadded:] = 0.0
        dy[:, unpadded:] = 0.0
    _, _, scratch, _ = ssd_scan._forward(x, dt, a, bm, cm, q)

    def run(scr=scratch):
        return ssd_scan.ssd_scan_backward(x, dt, a, bm, cm, dy, dh, chunk=q,
                                          scratch=scr)

    def plain():
        return ssd_scan.ssd_scan_backward_plain(x, dt, a, bm, cm, dy, dh,
                                                chunk=q)
    got, want = run(), plain()
    errs = {}
    for what, u, w in zip(("dx", "ddt", "da", "db", "dc"), got, want):
        scale = w.abs().max().item()
        err = (u - w).abs().max().item()
        check(bool(torch.isfinite(u).all()) and err <= SSD_BWD_TOL * scale,
              f"ssd backward {label}: {what} max err {err} beyond "
              f"{SSD_BWD_TOL} x {scale}")
        errs[what] = err / scale
    again = run()
    check(all(torch.equal(u, v) for u, v in zip(got, again)),
          f"ssd backward {label}: two calls differ")
    nc = length // q
    bad = scratch.clone()
    bad[:b * nc * h * n * p].view(b, nc, h, n, p)[:, nc // 2] = 0.0
    fault_err = max(((u - w).abs().max() / w.abs().max()).item()
                    for u, w in zip(run(bad), want))
    check(fault_err > SSD_BWD_TOL, f"ssd backward {label}: a dropped "
          f"entering state reads {fault_err}, inside {SSD_BWD_TOL}")
    roof = ssd_backward_roofline(b, length, h, gr, n, p, q, final)
    plan = ssd_scan.backward_plan(b, length, h, gr, n, p, q)
    row = {"case": label, "rel_err": errs,
           "plan": {"head_block": plan.head_block, "blocks": plan.blocks,
                    "ctas": plan.grid[0] * plan.grid[1] * plan.grid[2],
                    "chunk_smem": plan.chunk_smem,
                    "dstate_smem": plan.dstate_smem},
           "max_abs_err": max((u - w).abs().max().item()
                              for u, w in zip(got, want)),
           "fault_rel_err": fault_err, "ms": event_ms(run, 10),
           "plain_ms": event_ms(plain, 2), "bound_ms": roof.bound_s * 1e3,
           "bound_by": roof.bound_by, "library_ms": None,
           "gflop": roof.flops / 1e9, "mbytes": roof.bytes / 1e6,
           "shape": f"x ({b}, {length}, {h}, {p}), B/C ({b}, {length}, {gr}"
                    f", {n}) fp32, chunk {q}"
                    f"{', with dh_final' if final else ''}"
                    f"{'' if unpadded is None else f', {unpadded} steps'}"}
    del x, dt, a, bm, cm, dy, dh, scratch, bad, got, want, again
    torch.cuda.empty_cache()
    print(f"ssm train checks: (a) ssd backward {row['shape']}: plan "
          f"{plan.head_block} heads a CTA ({plan.blocks} blocks a group), "
          f"{row['plan']['ctas']} CTAs, {plan.chunk_smem} / "
          f"{plan.dstate_smem} shared bytes (chunk / S_c kernel)")
    print(f"ssm train checks: (a) ssd backward {row['shape']}: rel errors "
          f"{ {k: f'{e:.2e}' for k, e in errs.items()} }, fault "
          f"{fault_err:.3f}, {row['ms']:.3f} ms (bound {row['bound_ms']:.4f}"
          f" {row['bound_by']}, {row['gflop']:.1f} GFLOP; plain "
          f"{row['plain_ms']:.3f})")
    return row


def ssm_train_phase(check):
    """Phase 15: training mamba2-370m and zamba2-1.2b on the card.  (a)
    the SSD backward kernels at ``SSD_BWD_CASES``; (b)
    ``make_train_step`` for each model of ``SSM_TRAIN`` at full width and
    depth, phase 14's batch, steps and optimizer, with the SSD forward,
    SSD backward and flash launch counts zeroed before and read after;
    (c) one step of each at check (c)'s depth with the kernels against
    the same step with autograd through the plain versions.  Returns
    (the SSD backward's kernels-line entry, the SSD forward launches in
    (b), the flash forward and backward launches in (b), summary)."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, _batch_numpy
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref, ssd_scan
    from repro_torch.launch.specs import opt_config_for
    from repro_torch.models import init_params
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.train import trainer

    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    summary = {}

    # (a) the backward kernels as built, then against their plain version
    built = ssd_backward_built(check)
    summary["ssd_backward_built"] = built
    g = torch.Generator(device=dev).manual_seed(15)
    rows = [ssd_backward_check(case, g, check) for case in SSD_BWD_CASES]
    summary["ssd_backward"] = rows

    # (b) the full-depth trainers
    totals = {"ssd_scan": 0, "ssd_scan_backward": 0, "flash_attention": 0,
              "flash_attention_backward": 0}
    for model, depth, _ in SSM_TRAIN:
        cfg = get_config(model)
        check(cfg.n_layers == depth and cfg.remat
              and cfg.dtype == "bfloat16",
              f"{model}: expected {depth} layers, remat and bf16 compute")
        hybrid = cfg.family == "hybrid"
        opt_cfg = dataclasses.replace(opt_config_for(cfg), lr=TRAIN_LR,
                                      warmup_steps=2,
                                      total_steps=TRAIN_STEPS)
        data = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH, seed=0)

        def batch(i, data=data):
            return {k: torch.as_tensor(v, device=dev)
                    for k, v in _batch_numpy(data, i).items()}
        print(f"ssm train: {cfg.name}, {cfg.n_layers} layers, "
              f"{cfg.param_count() / 1e9:.3f} B parameters, batch "
              f"{TRAIN_BATCH} x {TRAIN_SEQ}")
        step = trainer.make_train_step(cfg, opt_cfg)
        ssd_scan.reset_launches()
        fa.reset_launches()
        state, losses, step_ms, gnorms, grad_norms, peak_gb = train_steps(
            step, lambda cfg=cfg, opt_cfg=opt_cfg: trainer.init_state(
                torch.Generator(device=dev).manual_seed(0), cfg, opt_cfg),
            batch, f"ssm train {model}", check)
        launches = {**ssd_scan.launches, **fa.launches}
        must = launches if hybrid else ssd_scan.launches
        for name, count in must.items():
            check(count > 0, f"the {model} training never launched {name}")
        for name in totals:
            totals[name] += launches[name]
        tokens = TRAIN_BATCH * TRAIN_SEQ
        # model FLOPs: 6 N T, the SSD's forward and backward operations in
        # every layer, and the shared block's attention (3x its forward)
        # in each of its applications
        ssd_ops = cfg.n_layers * (
            ssd_roofline(TRAIN_BATCH, TRAIN_SEQ, cfg.ssm_chunk, cfg).flops
            + ssd_backward_roofline(
                TRAIN_BATCH, TRAIN_SEQ, cfg.ssm_heads, cfg.ssm_groups,
                cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_chunk,
                False).flops)
        attn_ops = 0.0
        if hybrid:
            pairs = fa.visible_pairs(TRAIN_SEQ, TRAIN_SEQ, True,
                                     cfg.swa_window)
            attn_ops = 3 * 4.0 * cfg.head_dim * cfg.n_heads * TRAIN_BATCH \
                * pairs * (cfg.n_layers // cfg.attn_every)
        model_flops = 6.0 * cfg.param_count() * tokens + ssd_ops + attn_ops
        steady = float(np.median(step_ms[1:]))
        mfu = model_flops / (steady / 1e3) / 989e12
        prof = device_breakdown(
            lambda: step(state, batch(TRAIN_STEPS)), top=12,
            groups={"ssd forward": SSD_KERNELS,
                    "ssd backward": SSD_BWD_KERNELS,
                    "flash forward": ("flash_kernel<", "flash_mma_kernel<"),
                    "flash backward": FLASH_BWD_KERNELS})
        summary[model] = {
            "losses": losses, "grad_norms": gnorms, "step_ms": step_ms,
            "steady_step_ms": steady, "tokens_per_s": tokens / (steady / 1e3),
            "mfu": mfu, "model_tflop": model_flops / 1e12,
            "ssd_tflop": ssd_ops / 1e12, "attention_tflop": attn_ops / 1e12,
            "peak_gb": peak_gb, "launches": launches,
            "grad_leaves": len(grad_norms), "traced_step": prof}
        print(f"ssm train {model}: losses {[round(x, 4) for x in losses]}; "
              f"grad norms {[round(x, 3) for x in gnorms]}; step ms "
              f"{[round(x, 1) for x in step_ms]}; median {steady:.1f} ms, "
              f"{tokens / (steady / 1e3):.0f} tokens/s, MFU {mfu:.3f} "
              f"({model_flops / 1e12:.1f} TFLOP a step, of which SSD "
              f"{ssd_ops / 1e12:.2f} and attention {attn_ops / 1e12:.2f}; "
              f"989 TFLOP/s); peak {peak_gb:.1f} GB; launches {launches}; "
              f"{len(grad_norms)} leaves with a gradient")
        if prof["device_ms"] is None:
            print("  traced step: no device events")
        else:
            print(f"  traced step: call {prof['call_ms']:.1f} ms, device "
                  f"{prof['device_ms']:.1f} ms, busy "
                  f"{prof['busy_share']:.2f}; "
                  f"{ {k: round(v, 2) for k, v in prof['groups'].items()} }")
            for kr in prof["kernels"]:
                print(f"    {kr['ms']:8.3f} ms x{kr['count']:<5d} "
                      f"{kr['name'][:100]}")
        del state, step
        gc.collect()
        torch.cuda.empty_cache()

    # (c) the kernels against the plain versions, one step
    real_ssd, real_flash = ssm_mod.ssd_scan, fa.flash_attention

    def plain_ssd(x, dt, a, b, c, *, chunk=64):
        return ref.ssd_chunked_ref(x, dt, a, b, c, chunk=chunk)

    def plain_attention(q, k, v, *, causal=True, window=None, q_offset=0):
        # the kernels' stated arithmetic (P rounded to bf16 before P V)
        return fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window, round_p=True,
                                        q_offset=q_offset)
    summary["plain_route"] = {}
    for model, _, small_depth in SSM_TRAIN:
        small = dataclasses.replace(get_config(model), n_layers=small_depth)
        data = DataConfig(vocab=small.vocab, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH, seed=0)
        b = {k: torch.as_tensor(v[:2], device=dev)
             for k, v in _batch_numpy(data, 0).items()}
        params = init_params(torch.Generator(device=dev).manual_seed(1),
                             small)
        ssd_scan.reset_launches()
        fa.reset_launches()
        loss_k, _, grads_k = trainer.value_and_grad(params, b, small)
        kernel_launches = {**ssd_scan.launches, **fa.launches}
        ssm_mod.ssd_scan, fa.flash_attention = plain_ssd, plain_attention
        try:
            ssd_scan.reset_launches()
            fa.reset_launches()
            loss_p, _, grads_p = trainer.value_and_grad(params, b, small)
            plain_launches = {**ssd_scan.launches, **fa.launches}
        finally:
            ssm_mod.ssd_scan, fa.flash_attention = real_ssd, real_flash
        must = (kernel_launches if small.family == "hybrid"
                else {k: kernel_launches[k] for k in ssd_scan.launches})
        check(all(n > 0 for n in must.values())
              and not any(plain_launches.values()),
              f"(c) {model}: launches {kernel_launches} (kernels), "
              f"{plain_launches} (plain)")
        loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
        check(loss_err <= 2e-2, f"(c) {model}: loss {float(loss_k)} against "
              f"{float(loss_p)}")
        grad_errs = {}
        for (path, gk), (_, gp) in zip(_leaves(grads_k), _leaves(grads_p)):
            scale = gp.float().abs().max().item()
            grad_errs[path] = ((gk.float() - gp.float()).abs().max().item()
                               / scale)
            check(grad_errs[path] <= 2e-2, f"(c) {model}: gradient {path} "
                  f"rel err {grad_errs[path]} beyond 2e-2")
        worst = max(grad_errs, key=grad_errs.get)
        summary["plain_route"][model] = {
            "layers": small_depth, "loss": [float(loss_k), float(loss_p)],
            "loss_rel_err": loss_err, "grad_rel_errs": grad_errs,
            "launches": kernel_launches}
        print(f"ssm train checks: (c) {model} at {small_depth} layers, "
              f"kernels against plain versions: loss {float(loss_k):.5f} / "
              f"{float(loss_p):.5f}, largest gradient rel err "
              f"{grad_errs[worst]:.2e} ({worst}); launches {kernel_launches}")
        del params, grads_k, grads_p
        gc.collect()
        torch.cuda.empty_cache()

    main = rows[0]
    entry = {
        "name": "ssd_scan.ssd_scan_backward", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "none: the port's own kernel (the reference "
                    "differentiates its XLA ssd_chunked_ref)",
        "launches": totals["ssd_scan_backward"],
        **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms", "shape")},
        "other_shapes": rows[1:], "built": built}
    flash = {k: totals[k] for k in ("flash_attention",
                                    "flash_attention_backward")}
    return entry, totals["ssd_scan"], flash, summary


#: phase 16: the generator's mesh.  (a)'s algebras run at ``SIZES`` on a
#: one-rank NCCL mesh; (b) four gloo ranks share the card on a 2x2 mesh
MESH_RANKS = 4
MESH_SPARSE_BLOCK = (128, 128)


def mesh_cases(sizes, block):
    """Phase 16 (b)'s cases on the 2x2 mesh: gemm under the four STT
    families (SUMMA, Cannon, the stagger, ring-reduce), the two batched
    forms, and sparse gemm A compressed and masked-dense."""
    from repro_torch.dist.cases import K_SPATIAL_T, case

    g = sizes["gemm"]
    sp = (("random", "A", (g["m"], g["k"]), block, 0.25, 0),)
    out = [case(f"gemm x {df}", "gemm", g, df, (2, 2))
           for df in ("identity", "output_stationary", "weight_stationary")]
    out += [case("gemm x K-spatial", "gemm", g, K_SPATIAL_T, (2, 2))]
    out += [case(f"{name} x output_stationary", name, sizes[name],
                 "output_stationary", (2, 2))
            for name in ("batched_gemv", "depthwise_conv")]
    out += [case(f"gemm A d=0.25 sparse={mode}", "gemm", g,
                 "output_stationary", (2, 2), sparsity=sp, sparse=mode)
            for mode in ("auto", "dense")]
    return out


def mesh_ranks(case_list, fault, device):
    """Phase 16 (b) in each of the four ranks: the cases, then the planted
    fault — the Cannon case once more with its last rotation dropped
    (``RankMesh.ppermute`` patched here, in this rank only, to hand back
    its input on the last rotation step: Cannon rotates both sides
    ``S - 1`` times, two calls a step).  Rank 0's records."""
    from repro_torch.dist import cases, comm_engine

    recs = cases.run_cases(case_list, device, "gloo", keep_out=False,
                           single=True)
    real = comm_engine.RankMesh.ppermute
    calls = [0]
    last_step = 2 * (fault.mesh[0] - 2)

    def dropping(self, x, axis, perm):
        calls[0] += 1
        return x if calls[0] > last_step else real(self, x, axis, perm)

    comm_engine.RankMesh.ppermute = dropping
    try:
        bad = cases.run_cases([fault], device, "gloo", keep_out=False,
                              single=True)
    finally:
        comm_engine.RankMesh.ppermute = real
    return recs, bad.get(fault.label), calls[0]


def _mesh_line(label, rec):
    secs = [max(s) for s in rec["seconds"]]
    foot = " ".join(f"{k}={v:.0f}B" for k, v in rec["footprint"].items())
    return (f"  {label:34s} {rec['strategy']:17s} "
            f"in={rec['in_specs'][0]}/{rec['in_specs'][1]} "
            f"out={rec['out_spec']} stored/dev {foot}; host s/rank "
            + ",".join(f"{s:.3f}" for s in secs))


def mesh_phase(check, device="cuda", sizes=None, block=MESH_SPARSE_BLOCK):
    """Phase 16: the generator's mesh on the card.

    (a) a one-rank NCCL mesh (1x1, this process): every registry
    algebra at ``SIZES`` through ``generate(name, "output_stationary",
    bounds=..., mesh=m)`` on integer operands in [-4, 4]; each output
    equals the single-card accelerator's exactly.  (b) four gloo ranks
    sharing the card on a 2x2 mesh (``dist.spawn``): ``mesh_cases``;
    every rank's output is a CUDA tensor equal to its single-card
    accelerator's (the OS/WS/RT templates and the BSR kernel) exactly,
    compressed footprints fall below the dense ones, and the planted
    fault (Cannon without its last rotation) is caught.  Times are host
    seconds of ranks sharing one card over host-staged gloo, not a
    mesh's speed.  Returns the phase's summary."""
    from repro_torch.dist import cases, spawn

    sizes = SIZES if sizes is None else sizes
    t0 = time.perf_counter()
    one = [cases.case(name, name, b, "output_stationary", (1, 1))
           for name, b in sizes.items()]
    with spawn.single_rank(device=device):
        recs_a = cases.run_cases(one, device, keep_out=False, single=True)
    for c in one:
        rec = recs_a[c.label]
        check(rec["equal_single"] and rec["on_mesh_device"],
              f"1x1 mesh {c.label}: output differs from the single-card "
              f"accelerator or left the card ({rec['devices']})")
    a_s = time.perf_counter() - t0
    print(f"mesh (a) 1x1 {'NCCL' if device == 'cuda' else 'gloo'}: "
          f"{len(one)} algebras at full width equal the single-card "
          f"accelerator ({a_s:.1f} s)")
    for c in one:
        print(_mesh_line(c.label, recs_a[c.label]))

    t0 = time.perf_counter()
    case_list = mesh_cases(sizes, block)
    fault = dataclasses.replace(case_list[1], label="fault: Cannon "
                                "without its last rotation")
    recs_b, bad, calls = spawn.run_ranks(
        mesh_ranks, MESH_RANKS, device=device, backend="gloo",
        args=(case_list, fault, device), timeout=600)
    b_s = time.perf_counter() - t0
    for c in case_list:
        rec = recs_b[c.label]
        check(rec["equal_single"] and rec["agree"],
              f"2x2 mesh {c.label}: a rank's output differs from the "
              f"single-card accelerator")
        check(rec["on_mesh_device"] and all(
            d.startswith(device) for d in rec["devices"]),
            f"2x2 mesh {c.label}: outputs on {rec['devices']}")
    check(recs_b[case_list[1].label]["strategy"] == "cannon",
          "gemm x output_stationary did not run Cannon")
    check(recs_b[case_list[2].label]["strategy"] == "k_spatial_stagger",
          "gemm x weight_stationary did not run the stagger")
    comp, dense = (recs_b[c.label] for c in case_list[-2:])
    check(comp["lhs_compressed"] and not dense["lhs_compressed"],
          "sparse gemm A: the compressed/dense modes did not take")
    check(comp["footprint"]["lhs"] < dense["footprint"]["lhs"],
          f"sparse gemm A: compressed footprint {comp['footprint']} not "
          f"below the dense one {dense['footprint']}")
    check(not bad["equal_single"],
          "the planted fault (Cannon without its last rotation) was not "
          "caught")
    print(f"mesh (b) 2x2, {MESH_RANKS} gloo ranks sharing one card "
          f"(host-staged collectives; host seconds, not a mesh's speed): "
          f"{len(case_list)} cases equal the single-card accelerator on "
          f"every rank; planted fault caught ({calls} ring calls); "
          f"{b_s:.1f} s with spawning")
    for c in case_list:
        print(_mesh_line(c.label, recs_b[c.label]))
    return {"one_rank_nccl": {k: _mesh_summary(v) for k, v in
                              recs_a.items()},
            "gloo_2x2": {k: _mesh_summary(v) for k, v in recs_b.items()},
            "fault_caught": not bad["equal_single"],
            "seconds": {"a": a_s, "b": b_s},
            "note": "host seconds of ranks sharing one card over "
                    "host-staged gloo, not a mesh's speed"}


def _mesh_summary(rec):
    return {k: rec[k] for k in ("strategy", "in_specs", "out_spec",
                                "footprint", "seconds", "devices",
                                "equal_single")}


#: phase 17: serving on a model mesh.  (a) the flash kernel's q_offset at
#: danube's heads; (b)-(d) four gloo ranks sharing the card
TP_MODEL = "h2o-danube-1.8b"
TP_BATCH, TP_PROMPT, TP_TOKENS = 2, 512, 8
TP_CHUNKED_LAYERS, TP_FULL_MAX = 2, 256
Q_OFFSETS = (0, 256, 768)
Q_OFFSET_SHAPE = (32, 8, 80, 256, 1024)      # hq, hkv, d, rows, kv length
MOE_MODEL, MOE_PROMPT = "mixtral-8x22b", 256
PLACED = dict(capacity=4, max_context=256, page_size=16)
PLACED_LENS, PLACED_STEPS = (100, 180), 16
TP_LOGIT_TOL, MOE_LOGIT_TOL = 2e-3, 5e-2


def q_offset_check(g, check):
    """Phase 17 (a): the flash forward at danube's heads on a rank's 256
    query rows against 1024 keys, causal, at ``Q_OFFSETS``, bf16 (against
    the P-rounding plain version within ``BF16_ROW_TOL``) and fp32
    (within 1e-4 x max|out|), each against ``flash_attention_plain(
    q_offset=...)``; a planted fault — the offset ignored — must fail
    the same limit at every offset above 0.  Times at each offset."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    hq, hkv, d, rows, lkv = Q_OFFSET_SHAPE
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((1, hq, rows, d), generator=g,
                        device="cuda").to(dtype)
        k, v = (torch.randn((1, hkv, lkv, d), generator=g,
                            device="cuda").to(dtype) for _ in range(2))
        bf16 = dtype == torch.bfloat16
        for off in Q_OFFSETS:
            got = fa.flash_attention(q, k, v, causal=True, q_offset=off)
            want = fa.flash_attention_plain(q, k, v, causal=True,
                                            round_p=bf16, q_offset=off)
            fault = fa.flash_attention(q, k, v, causal=True)
            if bf16:
                err = fa.row_error(got, want)
                bad = fa.row_error(fault, want)
                tol = fa.BF16_ROW_TOL
            else:
                scale = want.abs().max().item()
                err = (got - want).abs().max().item() / scale
                bad = (fault - want).abs().max().item() / scale
                tol = 1e-4
            tag = f"q_offset {off} {str(dtype)[6:]}"
            check(bool(torch.isfinite(got.float()).all()) and err <= tol,
                  f"flash {tag}: error {err} beyond {tol}")
            if off:
                check(bad > tol, f"flash {tag}: the planted fault (offset "
                      f"ignored) reads {bad}, inside {tol}")
            ms = event_ms(lambda: fa.flash_attention(
                q, k, v, causal=True, q_offset=off), 10)
            out[tag] = {"err": err, "fault_err": bad if off else None,
                        "ms": ms}
            print(f"  (a) {tag}: err {err:.3e} (limit {tol}), offset "
                  f"ignored {bad:.3e}, {ms:.4f} ms")
    return out


class routes:
    """Record the MoE router's choices (``mlp.route``'s top-k experts and
    probabilities) for the ``with`` block: ``moe_manual`` and the
    one-device MoE both route through it."""

    def __enter__(self):
        from repro_torch.models import mlp
        self.mlp, self.real, self.seen = mlp, mlp.route, []

        def route(*a, **k):
            out = self.real(*a, **k)
            self.seen.append((out[3].cpu(), out[1].cpu()))
            return out
        mlp.route = route
        return self

    def __exit__(self, *exc):
        self.mlp.route = self.real


def moe_agreement(got, want, got_top, want_top, want_probs):
    """Phase 17 (c): a routing flip moves one token's output by the whole
    expert output, so the logits are held token by token: tokens routed
    alike and every token routed otherwise a near tie on one card (its
    k-th and (k+1)-th router probabilities close).  Returns (the largest
    error of the tokens routed alike over max|logit|, the tokens routed
    apart, the widest one-card gap among them)."""
    import torch

    same = (torch.sort(got_top, -1).values
            == torch.sort(want_top, -1).values).all(-1)     # (B, S)
    scale = want.float().abs().max().item()
    err = ((got.float() - want.float()).abs().amax(-1)[same].max().item()
           / scale if bool(same.any()) else float("inf"))
    k = got_top.shape[-1]
    top = torch.sort(want_probs, -1, descending=True).values
    gaps = (top[..., k - 1] - top[..., k])[~same]
    return err, int((~same).sum()), (gaps.max().item() if gaps.numel()
                                     else 0.0)


def _tp_cfg(name, **kw):
    import dataclasses

    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config(name), **kw)


def model_mesh_ranks(spec, paths):
    """Phase 17 (b)-(d) in each of four gloo ranks sharing the card;
    every rank's record on rank 0 (logits go to ``paths``' files)."""
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.dist import serve_selftest
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged
    from repro_torch.launch.mesh import make_mesh, set_mesh
    from repro_torch.models import attention, explicit_tp, init_params
    from repro_torch.models.transformer import compute_params, forward
    from repro_torch.serve import (DecodeEngine, ServeConfig, SlotEngine,
                                   place_pools, solve_page_placement)

    dev = torch.device("cuda")
    rank = dist.get_rank()
    rec = {"rank": rank, "seconds": {}}
    tp = make_mesh((2, 2), ("data", "model"), device="cuda", backend="gloo")
    moe = make_mesh((1, 2), ("data", "model"), device="cuda",
                    backend="gloo")
    xy = make_mesh((2, 2), ("x", "y"), device="cuda", backend="gloo")
    tokens = torch.as_tensor(spec["tokens"], device=dev)

    # (b) explicit TP on danube, fp32, 24 layers
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = _tp_cfg(TP_MODEL, dtype="float32", explicit_collectives=True)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    fa.reset_launches()
    # the engine built off the mesh keeps the parameters whole (one built
    # on it places them: phase 23); it decodes on the mesh it runs under
    eng = DecodeEngine(params, cfg, ServeConfig(max_new_tokens=TP_TOKENS))
    with torch.no_grad(), set_mesh(tp):
        logits = forward(params, tokens, cfg)[0]
        rec["flash_b"] = fa.launches["flash_attention"]
        rec["tokens"] = eng.generate(np.asarray(spec["tokens"]))[0].tolist()
    if rank == 0:
        torch.save(logits.cpu(), paths["b"])
    del logits, eng
    # the same model at 2 layers with FULL_SCORES_MAX_LEN lowered: the
    # rows go through chunked_attn_manual and the kernel's q_offset
    short = {k: v[:TP_CHUNKED_LAYERS] for k, v in params["layers"].items()
             if not isinstance(v, dict)}
    short.update({k: {n: t[:TP_CHUNKED_LAYERS] for n, t in v.items()}
                  for k, v in params["layers"].items() if isinstance(v, dict)})
    cfg2 = _tp_cfg(TP_MODEL, dtype="float32", explicit_collectives=True,
                   n_layers=TP_CHUNKED_LAYERS)
    calls = []
    real = explicit_tp.chunked_attn_manual

    def counted(*a, **k):
        out = real(*a, **k)
        calls.append(out is not None)
        return out
    keep = attention.FULL_SCORES_MAX_LEN
    attention.FULL_SCORES_MAX_LEN = TP_FULL_MAX
    explicit_tp.chunked_attn_manual = counted
    try:
        with torch.no_grad(), set_mesh(tp):
            logits = forward({**params, "layers": short}, tokens, cfg2)[0]
    finally:
        attention.FULL_SCORES_MAX_LEN = keep
        explicit_tp.chunked_attn_manual = real
    rec["chunked_calls"] = sum(calls)
    rec["flash_b_chunked"] = fa.launches["flash_attention"] - rec["flash_b"]
    if rank == 0:
        torch.save(logits.cpu(), paths["b2"])
    rec["peak_gb_b"] = torch.cuda.max_memory_allocated() / 1e9
    del logits, params, short
    gc.collect()
    torch.cuda.empty_cache()
    rec["seconds"]["b"] = time.perf_counter() - t0

    # (c) the MoE on a 1x2 mesh (ranks 0 and 1), bf16, one layer
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    moe_calls = []
    if rank < 2:
        mcfg = _tp_cfg(MOE_MODEL, n_layers=1, capacity_factor=8.0,
                       explicit_collectives=True)
        mp = compute_params(init_params(
            torch.Generator(device=dev).manual_seed(0), mcfg), mcfg)
        gc.collect()
        torch.cuda.empty_cache()
        real_moe = explicit_tp.moe_manual

        def moe_counted(*a, **k):
            out = real_moe(*a, **k)
            moe_calls.append(out is not None)
            return out
        explicit_tp.moe_manual = moe_counted
        try:
            with torch.no_grad(), set_mesh(moe), routes() as seen:
                logits = forward(mp, torch.as_tensor(spec["moe_tokens"],
                                                     device=dev), mcfg)[0]
        finally:
            explicit_tp.moe_manual = real_moe
        if rank == 0:
            torch.save((logits.cpu(), seen.seen[0][0]), paths["c"])
        del mp, logits
        gc.collect()
        torch.cuda.empty_cache()
    rec["moe_manual"] = sum(moe_calls)
    rec["peak_gb_c"] = torch.cuda.max_memory_allocated() / 1e9
    rec["seconds"]["c"] = time.perf_counter() - t0

    # (d) pools placed over the 2x2 ("x", "y") mesh, danube bf16
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    lcfg = _tp_cfg(TP_MODEL)
    eng = SlotEngine(init_params(torch.Generator(device=dev).manual_seed(0),
                                 lcfg), lcfg, **PLACED)
    gc.collect()
    torch.cuda.empty_cache()
    sol, pspec = solve_page_placement(lcfg, eng.cache.layout,
                                      axes=("x", "y"), shape=(2, 2))
    place_pools(eng.cache, xy, pspec)
    paged.reset_launches()
    prompts = [np.asarray(p, np.int32) for p in spec["placed_prompts"]]
    got = serve_selftest._drive(eng, prompts, PLACED_STEPS)
    rec["placed"] = [g.tolist() for g in got]
    rec["placed_churn_compiles"] = serve_selftest.churn(
        eng, prompts, got, PLACED_STEPS)
    rec["gather_d"] = paged.launches["paged_gather"]
    rec["placement"] = {"strategy": sol.strategy, "spec": str(pspec),
                        "pages": eng.cache.placement.pages,
                        "shards": eng.cache.placement.shards}
    rec["peak_gb_d"] = torch.cuda.max_memory_allocated() / 1e9
    rec["seconds"]["d"] = time.perf_counter() - t0
    del eng
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, rec)
    return out


def model_mesh_phase(check):
    """Phase 17: serving on a model mesh.  (a) ``q_offset_check``; then
    the one-card references (flag off): danube's fp32 forward of
    ``TP_BATCH`` x ``TP_PROMPT`` tokens at 24 layers and at 2 layers with
    ``FULL_SCORES_MAX_LEN`` lowered, its ``DecodeEngine`` tokens,
    mixtral's bf16 one-layer forward, and the unsharded ``SlotEngine``'s
    drive; then four gloo ranks sharing the card (``model_mesh_ranks``):
    (b) the same danube runs flag on over a 2x2 ("data", "model") mesh,
    logits within ``TP_LOGIT_TOL`` x max|logit|, the tokens equal, flash
    launched on every rank, the 2-layer run through
    ``chunked_attn_manual``; (c) mixtral on a 1x2 mesh through
    ``moe_manual``, within ``MOE_LOGIT_TOL``; (d) the danube slot engine
    over pools placed by ``solve_page_placement`` on a 2x2 ("x", "y")
    mesh, insert/evict churn over ``PLACED_STEPS`` steps bit-identical to
    the unsharded engine, the gather launched on every rank, the decode
    step built once.  One card: ranks share it over host-staged gloo, so
    no time here is a mesh's speed.  Returns (the launches of the gather
    and flash kernels over the ranks, summary)."""
    import gc
    import tempfile

    import numpy as np
    import torch

    from repro_torch.dist import serve_selftest, spawn
    from repro_torch.models import attention, init_params
    from repro_torch.models.transformer import compute_params, forward
    from repro_torch.serve import DecodeEngine, ServeConfig, SlotEngine

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)
    summary = {"q_offset": q_offset_check(g, check)}
    rng = np.random.default_rng(17)
    cfg = _tp_cfg(TP_MODEL, dtype="float32")
    spec = {"tokens": rng.integers(0, cfg.vocab,
                                   (TP_BATCH, TP_PROMPT)).tolist(),
            "moe_tokens": rng.integers(0, _tp_cfg(MOE_MODEL).vocab,
                                       (TP_BATCH, MOE_PROMPT)).tolist(),
            "placed_prompts": [rng.integers(0, cfg.vocab, (n,)).tolist()
                               for n in PLACED_LENS]}
    t0 = time.perf_counter()
    tokens = torch.as_tensor(spec["tokens"], device=dev)
    with torch.no_grad():
        params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
        want_b = forward(params, tokens, cfg)[0].cpu()
        want_tokens = DecodeEngine(params, cfg, ServeConfig(
            max_new_tokens=TP_TOKENS)).generate(np.asarray(
                spec["tokens"]))[0]
        keep = attention.FULL_SCORES_MAX_LEN
        attention.FULL_SCORES_MAX_LEN = TP_FULL_MAX
        try:
            cfg2 = _tp_cfg(TP_MODEL, dtype="float32",
                           n_layers=TP_CHUNKED_LAYERS)
            short = {k: ({n: t[:TP_CHUNKED_LAYERS] for n, t in v.items()}
                         if isinstance(v, dict) else v[:TP_CHUNKED_LAYERS])
                     for k, v in params["layers"].items()}
            want_b2 = forward({**params, "layers": short}, tokens,
                              cfg2)[0].cpu()
        finally:
            attention.FULL_SCORES_MAX_LEN = keep
        del params, short
        gc.collect()
        torch.cuda.empty_cache()
        mcfg = _tp_cfg(MOE_MODEL, n_layers=1, capacity_factor=8.0)
        mp = compute_params(init_params(
            torch.Generator(device=dev).manual_seed(0), mcfg), mcfg)
        gc.collect()
        with routes() as seen:
            want_c = forward(mp, torch.as_tensor(spec["moe_tokens"],
                                                 device=dev),
                             mcfg)[0].float().cpu()
        want_top, want_probs = seen.seen[0]
        del mp
        gc.collect()
        torch.cuda.empty_cache()
        lcfg = _tp_cfg(TP_MODEL)
        eng = SlotEngine(init_params(torch.Generator(device=dev).manual_seed(
            0), lcfg), lcfg, **PLACED)
        want_d = serve_selftest._drive(
            eng, [np.asarray(p, np.int32) for p in spec["placed_prompts"]],
            PLACED_STEPS)
        del eng
    gc.collect()
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
        paths = {k: f"{tmp}/{k}.pt" for k in ("b", "b2", "c")}
        recs = spawn.run_ranks(model_mesh_ranks, MESH_RANKS, device="cuda",
                               backend="gloo", args=(spec, paths),
                               timeout=900)
        got_b, got_b2 = (torch.load(paths[k]) for k in ("b", "b2"))
        got_c, got_top = torch.load(paths["c"])
    ranks_s = time.perf_counter() - t0

    def rel(got, want):
        return ((got.float() - want.float()).abs().max()
                / want.float().abs().max()).item()

    err_b, err_b2 = rel(got_b, want_b), rel(got_b2, want_b2)
    err_c, flips, flip_gap = moe_agreement(got_c, want_c, got_top, want_top,
                                           want_probs)
    check(got_b.shape == want_b.shape and err_b <= TP_LOGIT_TOL,
          f"(b) danube on the 2x2 mesh: logits {tuple(got_b.shape)} off by "
          f"{err_b} x max|logit| (limit {TP_LOGIT_TOL})")
    check(err_b2 <= TP_LOGIT_TOL, f"(b) 2 layers through "
          f"chunked_attn_manual: off by {err_b2} (limit {TP_LOGIT_TOL})")
    check(err_c <= MOE_LOGIT_TOL, f"(c) mixtral through moe_manual: the "
          f"tokens routed alike off by {err_c} (limit {MOE_LOGIT_TOL})")
    check(flip_gap <= 1e-2 and flips <= got_top[..., 0].numel() // 20,
          f"(c) {flips} tokens routed apart, the widest one-card gap "
          f"{flip_gap} (a flip must be a near tie, at most 5% of tokens)")
    for r in recs:
        tag = f"rank {r['rank']}"
        check(np.array_equal(np.asarray(r["tokens"]), want_tokens),
              f"(b) {tag}: the mesh's greedy tokens differ from one card's")
        check(r["flash_b"] > 0 and r["flash_b_chunked"] > 0,
              f"(b) {tag}: flash launches {r['flash_b']} / "
              f"{r['flash_b_chunked']}")
        check(r["chunked_calls"] == TP_CHUNKED_LAYERS,
              f"(b) {tag}: chunked_attn_manual ran {r['chunked_calls']} "
              f"times, not once a layer")
        check(r["rank"] >= 2 or r["moe_manual"] == 1,
              f"(c) {tag}: moe_manual ran {r['moe_manual']} times")
        check(all(np.array_equal(np.asarray(a), b)
                  for a, b in zip(r["placed"], want_d)),
              f"(d) {tag}: decode over placed pools differs from the "
              f"unsharded engine")
        check(r["gather_d"] > 0, f"(d) {tag}: the gather never launched")
        check(r["placed_churn_compiles"] == 1,
              f"(d) {tag}: {r['placed_churn_compiles']} decode builds")
    secs = time.perf_counter() - t_phase
    launches = {"paged_gather": sum(r["gather_d"] for r in recs),
                "flash_attention": sum(r["flash_b"] + r["flash_b_chunked"]
                                       for r in recs)}
    peaks = {r["rank"]: max(r[f"peak_gb_{p}"] for p in "bcd") for r in recs}
    print(f"model mesh (b) danube fp32 24 layers on 2x2: logits err "
          f"{err_b:.3e} x max, {TP_TOKENS} tokens equal on every rank; 2 "
          f"layers via chunked_attn_manual err {err_b2:.3e}; (c) mixtral "
          f"1 layer bf16 on 1x2 via moe_manual err {err_c:.3e} on the tokens "
          f"routed alike, {flips} of {got_top[..., 0].numel()} routed "
          f"apart (gaps <= {flip_gap:.2e}); (d) placed "
          f"pools {recs[0]['placement']}, {PLACED_STEPS} steps + churn "
          f"bit-identical; launches {launches}")
    print(f"model mesh seconds: phase {secs:.1f} (one-card references "
          f"{ref_s:.1f}, four ranks {ranks_s:.1f} with spawning; per rank "
          + "; ".join(f"{r['rank']}: " + ", ".join(
              f"{k} {v:.1f}" for k, v in r["seconds"].items())
              for r in recs)
          + "); peak GB a rank " + ", ".join(f"{k}: {v:.1f}" for k, v in
                                           peaks.items())
          + " (ranks share one card over host-staged gloo: not a mesh's "
          "speed)")
    summary.update({
        "err_b": err_b, "err_b_chunked": err_b2, "err_c": err_c,
        "moe_flips": flips, "moe_flip_gap": flip_gap,
        "placement": recs[0]["placement"], "launches": launches,
        "seconds": {"phase": secs, "references": ref_s, "ranks": ranks_s,
                    "per_rank": {r["rank"]: r["seconds"] for r in recs}},
        "peak_gb": peaks,
        "note": "four ranks share one card over host-staged gloo: times "
                "are not a mesh's speed"})
    return launches, summary


#: phase 18: a sharded train step on a model mesh.  (a) the flash
#: backward's q_offset at danube's heads; (b)-(c) four gloo ranks sharing
#: the card on a 2x2 ("data", "model") mesh
TM_MODEL = "h2o-danube-1.8b"
#: (b)'s depth, cut for the script's time: a rank holds its blocks and
#: one gathered layer, so memory sets no cut, but every pass gathers
#: each layer twice (forward, remat recompute) and sums its gradient
#: over host-staged gloo (~0.35 GB/s a rank)
TM_LAYERS = 2
TM_BATCH, TM_SEQ, TM_STEPS = 4, 512, 3
TM_CHUNKED_LAYERS = 2
TM_LOSS_TOL, TM_GRAD_TOL = 1e-3, 2e-2
#: (b)'s first step's peak a rank against the dry run's per_device_total
#: of the same cut cell on a fake 2x2 world standing for gloo
TM_PEAK_BAND = (0.9, 1.3)

_TM_DRY = r"""
import json, sys
from repro_torch.launch import dryrun
arch, layers, batch, seq = json.loads(sys.argv[1])
r = dryrun.run_cell(arch, "train_4k", overrides={
    "n_layers": layers, "explicit_collectives": True}, batch=batch,
    seq_len=seq, mesh_shape=(2, 2), backend="gloo")
json.dump({"memory": r["memory"], "launches": r["kernel_launches"]},
          open(sys.argv[2], "w"))
"""


def q_offset_backward_check(g, check):
    """Phase 18 (a): the flash backward kernels at danube's heads on a
    rank's 256 query rows over 1024 keys, causal, at ``Q_OFFSETS``, bf16
    and fp32, given the kernel forward's output and log-sum-exp at the
    same offset: dQ, dK and dV against ``flash_attention_backward_plain(
    q_offset=...)`` within ``FLASH_BWD_TOL`` x max|.|; a planted fault —
    the backward called without the offset — must fail that limit at every
    offset above 0.  Times: the backward, its plain version, SDPA's
    forward + backward under the same mask and SDPA's backward alone
    (``sdpa_backward_ms``); the bound counts 2.5x the
    forward's 4 D flops a visible pair and q head."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import hopper
    from repro_torch.kernels import flash_attention as fa

    hq, hkv, d, rows, lkv = Q_OFFSET_SHAPE
    out_rows = []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        tol = FLASH_BWD_TOL[name]
        q, dout = (torch.randn((1, hq, rows, d), generator=g,
                               device="cuda").to(dtype) for _ in range(2))
        k, v = (torch.randn((1, hkv, lkv, d), generator=g,
                            device="cuda").to(dtype) for _ in range(2))
        for off in Q_OFFSETS:
            out, lse = fa._forward(q, k, v, True, None, with_lse=True,
                                   q_offset=off)

            def run(o=off):
                return fa.flash_attention_backward(
                    q, k, v, out, dout, lse, causal=True, q_offset=o)

            def plain():
                return fa.flash_attention_backward_plain(
                    q, k, v, out, dout, lse, causal=True, q_offset=off)
            got, want, fault = run(), plain(), run(0)
            errs, bad = {}, 0.0
            for what, x, w, f in zip(("dq", "dk", "dv"), got, want, fault):
                scale = w.float().abs().max().item()
                errs[what] = (x.float() - w.float()).abs().max().item() / scale
                bad = max(bad, (f.float() - w.float()).abs().max().item()
                          / scale)
                check(bool(torch.isfinite(x.float()).all())
                      and errs[what] <= tol,
                      f"flash backward q_offset {off} {name}: {what} off by "
                      f"{errs[what]} x max (limit {tol})")
            if off:
                check(bad > tol, f"flash backward q_offset {off} {name}: the "
                      f"planted fault (offset ignored) reads {bad}, inside "
                      f"{tol}")
            qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
            mask = fa._mask(rows, 0, lkv, True, None, q.device, off)

            def sdpa():
                o = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                   enable_gqa=True)
                torch.autograd.grad(o, (qs, ks, vs), dout)
            roof = hopper.RooflineTerms(
                f"flash backward q_offset {off}", *fa.cost(
                    1, hq, hkv, rows, lkv, d, causal=True, q_offset=off,
                    itemsize=q.element_size(), backward=True), dtype=name)
            row = {"case": f"q_offset {off}", "dtype": name,
                   "rel_err": errs, "fault_rel_err": bad if off else None,
                   "max_abs_err": max((x.float() - w.float()).abs().max()
                                      .item() for x, w in zip(got, want)),
                   "ms": event_ms(run, 5), "plain_ms": event_ms(plain, 1),
                   "bound_ms": roof.bound_s * 1e3, "bound_by": roof.bound_by,
                   "library_ms": event_ms(sdpa, 3),
                   "sdpa_backward_ms": sdpa_backward_ms(
                       lambda: F.scaled_dot_product_attention(
                           qs, ks, vs, attn_mask=mask, enable_gqa=True),
                       (qs, ks, vs), dout),
                   "shape": f"q (1, {hq}, {rows}, {d}) at rows {off}.."
                            f"{off + rows - 1}, k/v (1, {hkv}, {lkv}, {d}) "
                            f"{name}, causal"}
            out_rows.append(row)
            print(f"  (a) flash backward q_offset {off} {name}: rel errors "
                  f"{ {k: f'{e:.2e}' for k, e in errs.items()} }, offset "
                  f"ignored {bad:.3e}, {row['ms']:.4f} ms (bound "
                  f"{row['bound_ms']:.4f} {row['bound_by']}, plain "
                  f"{row['plain_ms']:.3f}, SDPA fwd+bwd "
                  f"{row['library_ms']:.3f}, bwd alone "
                  f"{row['sdpa_backward_ms']:.3f})")
            del out, lse, got, want, fault
    torch.cuda.empty_cache()
    return out_rows


def _tm_cfg(n_layers):
    return _tp_cfg(TM_MODEL, n_layers=n_layers, explicit_collectives=True)


def _tm_opt():
    from repro_torch.optim import adamw
    return adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=2,
                             total_steps=TM_STEPS)


def _tm_batch(cfg, i, dev):
    import torch

    from repro_torch.data.pipeline import DataConfig, _batch_numpy
    data = DataConfig(vocab=cfg.vocab, seq_len=TM_SEQ,
                      global_batch=TM_BATCH, seed=0)
    return {k: torch.as_tensor(v, device=dev)
            for k, v in _batch_numpy(data, i).items()}


def train_mesh_ranks(paths, elastic_dir=None):
    """Phase 18 (b)-(c) in each of four gloo ranks sharing the card, then
    phase 19's rank part (``elastic_ranks``) when ``elastic_dir`` is
    given; every rank's record on rank 0.  Each rank holds its blocks of
    the gradient to its blocks of the one-card gradient (``paths``'
    files, memory-mapped); ``paths`` None skips phase 18."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_mesh, set_mesh
    from repro_torch.models import attention, explicit_tp, placed as pp
    from repro_torch.models import transformer
    from repro_torch.train import trainer

    dev = torch.device("cuda")
    rank = dist.get_rank()
    rec = {"rank": rank, "seconds": {}, "peak_gb": {}, "step_peak": {},
           "gathered_peak": {}}
    mesh = make_mesh((2, 2), ("data", "model"), device="cuda",
                     backend="gloo")

    def run(tag, n_layers, steps):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cfg, opt = _tm_cfg(n_layers), _tm_opt()
        state = trainer.init_state(torch.Generator(device=dev).manual_seed(0),
                                   cfg, opt)
        step, st_sh, _ = trainer.make_sharded_train_step(
            cfg, opt, mesh, state, transformer.param_axes(cfg))
        placed = trainer.place_state(state, st_sh, mesh)
        del state
        gc.collect()
        torch.cuda.empty_cache()
        want = torch.load(paths[tag], mmap=True)
        fa.reset_launches()
        pp.GATHERED.reset()
        with set_mesh(mesh) as rm:
            loss, _, grads = trainer.sharded_value_and_grad(
                placed.params, _tm_batch(cfg, 0, dev), cfg, st_sh.params, rm)
            mine = trainer.place_tree(want["grads"], st_sh.params, rm)
            errs = {path: (gb.float() - w).abs().max().item()
                    / want["scale"][path]
                    for (path, gb), (_, w) in zip(_leaves(grads),
                                                  _leaves(mine))}
        del grads, mine
        losses, peaks = [float(loss)], []
        for i in range(steps):
            batch = _tm_batch(cfg, i, dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            placed, m = step(placed, batch)
            losses.append(float(m["loss"]))
            peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.synchronize()
        # the dry run's cell is one step on the placed state
        rec["step_peak"][tag] = peaks[0]
        rec["gathered_peak"][tag] = pp.GATHERED.peak
        rec[tag] = {"grad_errs": errs, "losses": losses,
                    "launches": dict(fa.launches)}
        rec["peak_gb"][tag] = max(peaks) / 1e9
        del placed, want
        gc.collect()
        torch.cuda.empty_cache()
        rec["seconds"][tag] = time.perf_counter() - t0

    if paths is not None:
        # (b) TM_LAYERS layers, the heads split over "model"
        run("b", TM_LAYERS, TM_STEPS)
        # (c) 2 layers above FULL_SCORES_MAX_LEN: the query rows through
        # chunked_attn_manual and the kernels' q_offset
        calls = []
        real = explicit_tp.chunked_attn_manual

        def counted(*a, **k):
            out = real(*a, **k)
            calls.append(out is not None)
            return out
        keep = attention.FULL_SCORES_MAX_LEN
        attention.FULL_SCORES_MAX_LEN = TP_FULL_MAX
        explicit_tp.chunked_attn_manual = counted
        try:
            run("c", TM_CHUNKED_LAYERS, 1)
        finally:
            attention.FULL_SCORES_MAX_LEN = keep
            explicit_tp.chunked_attn_manual = real
        rec["chunked_calls"] = [len(calls), sum(calls)]
    if elastic_dir is not None:
        rec["elastic"] = elastic_ranks(elastic_dir, mesh)
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, rec)
    return out


def train_mesh_phase(check, elastic_dir=None):
    """Phase 18: a sharded train step on a model mesh.  (a)
    ``q_offset_backward_check``; then the one-card references (no mesh,
    the same seeded weights and batches): h2o-danube-1.8b at full width
    and ``TM_LAYERS`` layers, bf16 compute over fp32 masters (remat on),
    the first batch's loss and gradient and ``TM_STEPS`` steps' losses of
    ``TM_BATCH`` x ``TM_SEQ`` tokens, and the same at ``TM_CHUNKED_LAYERS``
    layers (one step); then four gloo ranks sharing the card
    (``train_mesh_ranks``) on a 2x2 ("data", "model") mesh,
    ``explicit_collectives`` and sequence parallelism on: (b)
    ``make_sharded_train_step`` on the placed state, each rank's blocks of
    the first gradient (``sharded_value_and_grad``) within ``TM_GRAD_TOL``
    x max|g| of the one-card gradient's, the losses finite and within
    ``TM_LOSS_TOL`` x |loss| of one card's, the flash forward and backward
    launched on every rank; (c) the 2-layer model with
    ``FULL_SCORES_MAX_LEN`` at 256: the query rows through
    ``chunked_attn_manual`` on every layer and the backward kernels'
    ``q_offset``, held the same way.  One card: ranks share it over
    host-staged gloo, so no time here is a mesh's speed.  With
    ``elastic_dir`` the same ranks then run phase 19's rank part there.
    Returns (the flash forward's and backward's launches over the ranks
    in (b)-(c), the backward's rows at the offsets, summary, every
    rank's phase 19 record or None)."""
    import gc
    import math
    import os
    import tempfile

    import torch

    from repro_torch.dist import spawn
    from repro_torch.train import trainer

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    dry_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_tm_dry_")
    dry_json = os.path.join(dry_dir.name, "dry.json")
    dry = subprocess.Popen(
        [sys.executable, "-c", _TM_DRY, json.dumps(
            [TM_MODEL, TM_LAYERS, TM_BATCH, TM_SEQ]), dry_json],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    g = torch.Generator(device=dev).manual_seed(18)
    offset_rows = q_offset_backward_check(g, check)
    summary = {"q_offset_backward": offset_rows}
    t0 = time.perf_counter()
    cfg = _tm_cfg(TM_LAYERS)
    print(f"train mesh: {cfg.name} at full width, {TM_LAYERS} of 24 layers "
          f"(depth cut for the script's time: every pass gathers each layer "
          f"twice and sums its gradient over host-staged gloo), "
          f"{cfg.param_count() / 1e9:.3f} B parameters, batch {TM_BATCH} x "
          f"{TM_SEQ}, {TM_STEPS} steps, bf16 compute over fp32 masters, each "
          f"rank on its parameter blocks")
    ref = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tm_") as tmp:
        paths = {"b": f"{tmp}/b.pt", "c": f"{tmp}/c.pt"}
        for tag, n_layers, steps in (("b", TM_LAYERS, TM_STEPS),
                                     ("c", TM_CHUNKED_LAYERS, 1)):
            c, opt = _tm_cfg(n_layers), _tm_opt()
            state = trainer.init_state(
                torch.Generator(device=dev).manual_seed(0), c, opt)
            loss, _, grads = trainer.value_and_grad(
                state.params, _tm_batch(c, 0, dev), c)
            flat = {}
            for p, x in _leaves(grads):
                node = flat
                for key in p.strip("/").split("/")[:-1]:
                    node = node.setdefault(key, {})
                node[p.rsplit("/", 1)[1]] = x.float().cpu()
            torch.save({"grads": flat, "scale": {
                p: x.abs().max().item() for p, x in _leaves(flat)}},
                paths[tag])
            del grads, flat
            losses = [float(loss)]
            step = trainer.make_train_step(c, opt)
            for i in range(steps):
                state, m = step(state, _tm_batch(c, i, dev))
                losses.append(float(m["loss"]))
            ref[tag] = losses
            del state, step
            gc.collect()
            torch.cuda.empty_cache()
        ref_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        recs = spawn.run_ranks(train_mesh_ranks, MESH_RANKS, device="cuda",
                               backend="gloo", args=(paths, elastic_dir),
                               timeout=900)
        ranks_s = time.perf_counter() - t0
    launches = {"flash_attention": 0, "flash_attention_backward": 0}
    worst = {}
    for r in recs:
        tag = f"rank {r['rank']}"
        for part in ("b", "c"):
            got, want = r[part]["losses"], ref[part]
            errs = [abs(a - b) / abs(b) for a, b in zip(got, want)]
            check(all(math.isfinite(x) for x in got)
                  and max(errs) <= TM_LOSS_TOL,
                  f"({part}) {tag}: losses {got} against one card's {want}")
            path = max(r[part]["grad_errs"], key=r[part]["grad_errs"].get)
            gerr = r[part]["grad_errs"][path]
            check(gerr <= TM_GRAD_TOL, f"({part}) {tag}: gradient {path} "
                  f"off by {gerr} x max|g| (limit {TM_GRAD_TOL})")
            la = r[part]["launches"]
            check(la["flash_attention"] > 0
                  and la["flash_attention_backward"] > 0,
                  f"({part}) {tag}: flash launches {la}")
            for k in launches:
                launches[k] += la[k]
            worst[part] = max(worst.get(part, (0.0, "", 0.0)),
                              (gerr, path, max(errs)))
        # a layer's forward in the gradient and in the step, each run
        # again in the backward under remat
        calls = TM_CHUNKED_LAYERS * 2 * (2 if cfg.remat else 1)
        check(r["chunked_calls"] == [calls, calls],
              f"(c) {tag}: chunked_attn_manual [calls, applied] "
              f"{r['chunked_calls']}, expected {calls} applied")
    out_d, _ = dry.communicate(timeout=600)
    check(dry.returncode == 0, f"phase 18: the cut dry run exited "
          f"{dry.returncode}:\n{out_d[-3000:]}")
    with open(dry_json) as f:
        dry_rec = json.load(f)
    dry_dir.cleanup()
    dry_total = dry_rec["memory"]["per_device_total"]
    lo, hi = TM_PEAK_BAND
    ratios = {}
    for r in recs:
        ratios[r["rank"]] = r["step_peak"]["b"] / dry_total
        check(lo <= ratios[r["rank"]] <= hi, f"(b) rank {r['rank']}: a "
              f"step's peak {r['step_peak']['b'] / 1e9:.3f} GB, "
              f"{ratios[r['rank']]:.3f}x the dry run's per_device_total "
              f"{dry_total / 1e9:.3f} GB (band {lo}-{hi})")
    elastic = ([r.pop("elastic") for r in recs] if elastic_dir is not None
               else None)
    # phase 19's part of the ranks' run is its own
    secs = time.perf_counter() - t_phase - max(
        (e["seconds"] for e in elastic or ()), default=0.0)
    for part, (gerr, path, lerr) in worst.items():
        print(f"train mesh ({part}): the worst rank's gradient {path} off "
              f"by {gerr:.3e} x max|g|, losses {recs[0][part]['losses']} "
              f"against one card's {ref[part]} (largest rel diff "
              f"{lerr:.2e})")
    print(f"train mesh (b): a step's peak a rank "
          + ", ".join(f"{r['step_peak']['b'] / 1e9:.3f}" for r in recs)
          + f" GB, {min(ratios.values()):.3f}-{max(ratios.values()):.3f}x "
          f"the dry run's per_device_total {dry_total / 1e9:.3f} GB (fake "
          f"2x2 gloo world; argument bytes "
          f"{dry_rec['memory']['argument_bytes'] / 1e9:.3f}); the most "
          f"gathered bytes alive at once a rank (b)/(c) "
          + ", ".join("/".join(f"{v / 1e6:.1f}" for v in
                               r["gathered_peak"].values()) for r in recs)
          + " MB")
    print(f"train mesh launches over the 4 ranks: {launches}")
    print(f"train mesh seconds: phase {secs:.1f} (one-card references "
          f"{ref_s:.1f}, four ranks {ranks_s:.1f} with spawning; per rank "
          + "; ".join(f"{r['rank']}: " + ", ".join(
              f"{k} {v:.1f}" for k, v in r["seconds"].items())
              for r in recs)
          + "); peak GB a rank " + ", ".join(
              f"{r['rank']}: " + "/".join(f"{v:.1f}"
                                          for v in r["peak_gb"].values())
              for r in recs)
          + " ((b)/(c); ranks share one card over host-staged gloo: not a "
          "mesh's speed)")
    summary.update({
        "layers": TM_LAYERS, "references": ref,
        "dry_run": dry_rec, "peak_ratio": ratios,
        "ranks": [{k: r[k] for k in ("rank", "seconds", "peak_gb",
                                     "step_peak", "gathered_peak",
                                     "chunked_calls")}
                  | {p: {"losses": r[p]["losses"],
                         "launches": r[p]["launches"],
                         "worst_grad_err": max(r[p]["grad_errs"].values())}
                     for p in ("b", "c")} for r in recs],
        "launches": launches,
        "seconds": {"phase": secs, "references": ref_s, "ranks": ranks_s},
        "note": "four ranks share one card over host-staged gloo: times "
                "are not a mesh's speed"})
    return launches, offset_rows, summary, elastic


#: phase 19: elastic training on a model mesh.  h2o-danube-1.8b at full
#: width and EL_LAYERS layers, phase 18's precision, batch and lr, in its
#: four gloo ranks: ``TrainDriver`` on 2x2 ("data", "model") checkpointing
#: every EL_EVERY steps, failing at step EL_FAIL, restarted by
#: ``run_with_restarts`` onto 4x1 for EL_STEPS steps in all (4 of 6 since
#: phase 23 joined the script: the restart still resumes two steps)
EL_LAYERS, EL_STEPS, EL_EVERY, EL_FAIL = 2, 4, 2, 3
EL_MESHES = ((2, 2), (4, 1))


def _el_run(cfg, ckpt_dir, **kw):
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim import adamw
    from repro_torch.runtime.driver import RunConfig
    return (cfg, adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=2,
                                   total_steps=EL_STEPS),
            DataConfig(vocab=cfg.vocab, seq_len=TM_SEQ,
                       global_batch=TM_BATCH, seed=0),
            RunConfig(total_steps=EL_STEPS, ckpt_every=EL_EVERY,
                      ckpt_dir=ckpt_dir, log_every=1, **kw))


def elastic_ranks(ckpt_dir, mesh):
    """Phase 19's rank part, in each of phase 18's four ranks (``mesh``:
    their 2x2 mesh): the driver on 2x2 failing at ``EL_FAIL``, restarted
    onto 4x1 from the last checkpoint, flash's launches counted from 0
    over the run; (b) the restarted driver's blocks against the
    checkpoint's arrays, and the same restore at permuted coordinates
    (the planted fault); the ranks' final state's digest, gathered as a
    checkpoint gathers it (the writing rank's; None elsewhere); the
    checkpoint write and restore seconds, the peak memory."""
    import gc

    import torch

    from repro_torch.checkpoint import store
    from repro_torch.dist import train_cases as tc
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.driver import TrainDriver, run_with_restarts

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    meshes = [mesh, make_mesh(EL_MESHES[1], ("data", "model"),
                              device="cuda", backend="gloo")]
    cfg = _tm_cfg(EL_LAYERS)
    rec = {"save_s": [], "snapshot_s": [], "restore_s": []}
    real_save, real_restore = store.save, store.restore
    real_snapshot = store.AsyncCheckpointer.save_async

    def timed(fn, key):
        def call(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            rec[key].append(time.perf_counter() - t)
            return out
        return call
    drivers = []

    def make():
        if drivers:                      # the failed driver's blocks go
            drivers[-1].state = None
            gc.collect()
            torch.cuda.empty_cache()
        m = meshes[len(drivers)]
        d = TrainDriver(*_el_run(cfg, ckpt_dir), mesh=m,
                        failure_at=None if drivers else EL_FAIL)
        if d.start_step:
            arrays = tc.ckpt_arrays(ckpt_dir, d.start_step)
            rec["restored_bad"] = tc.block_mismatches(d.state, d.state_sh,
                                                      m, arrays)
            fault = tc.place_arrays(d.state, d.state_sh, tc.permuted(m),
                                    arrays)
            rec["fault_bad"] = len(tc.block_mismatches(
                fault, d.state_sh, m, arrays))
            del fault, arrays
        drivers.append(d)
        return d

    store.save, store.restore = (timed(real_save, "save_s"),
                                 timed(real_restore, "restore_s"))
    store.AsyncCheckpointer.save_async = timed(real_snapshot, "snapshot_s")
    fa.reset_launches()
    try:
        out = run_with_restarts(make)
    finally:
        store.save, store.restore = real_save, real_restore
        store.AsyncCheckpointer.save_async = real_snapshot
    torch.cuda.synchronize()
    rec["launches"] = dict(fa.launches)
    last = drivers[-1]
    rec.update({
        "losses": {m["step"]: m["loss"] for d in drivers
                   for m in d.metrics_log},
        "restarts": out["restarts"], "final_step": out["final_step"],
        "start_step": last.start_step,
        "digest": tc.state_digest(last.state, last.state_sh, meshes[1]),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
    drivers.clear()
    del last
    gc.collect()
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    return rec


def elastic_phase(check, recs, ckpt_dir):
    """Phase 19: elastic training on a model mesh.  ``recs``: every
    rank's ``elastic_ranks`` record (run in phase 18's world); then here,
    on one card: the reference, ``EL_STEPS`` uninterrupted steps of the
    same seeded model and batches.  (a) every rank's losses finite and
    within ``TM_LOSS_TOL`` x |loss| of one card's, one restart from step
    ``EL_FAIL // EL_EVERY * EL_EVERY``, flash's forward and backward
    launched on every rank; (b) every rank's restored blocks bit for bit
    the checkpoint's, and blocks restored at permuted coordinates not;
    (c) the mesh's final checkpoint restored onto one card with no specs
    (``TrainDriver`` on the card: start step ``EL_STEPS``) equal bit for
    bit to the ranks' gathered final state.  Returns (flash's launches
    over the ranks, summary)."""
    import gc
    import math

    import torch

    from repro_torch.dist import train_cases as tc
    from repro_torch.runtime.driver import TrainDriver
    from repro_torch.train import trainer

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = _tm_cfg(EL_LAYERS)
    _, opt, data, _ = _el_run(cfg, ckpt_dir)
    print(f"elastic: {cfg.name} at full width, {EL_LAYERS} of 24 layers, "
          f"{cfg.param_count() / 1e9:.3f} B parameters, batch {TM_BATCH} x "
          f"{TM_SEQ}, bf16 compute over fp32 masters; TrainDriver on "
          f"{EL_MESHES[0]} checkpointing every {EL_EVERY} steps, a failure "
          f"at step {EL_FAIL}, run_with_restarts onto {EL_MESHES[1]}, "
          f"{EL_STEPS} steps")
    t0 = time.perf_counter()
    state = trainer.init_state(torch.Generator(device=dev).manual_seed(
        data.seed), cfg, opt)
    step = trainer.make_train_step(cfg, opt)
    ref = {}
    for i in range(EL_STEPS):
        state, m = step(state, _tm_batch(cfg, i, dev))
        ref[i + 1] = float(m["loss"])
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0
    launches = {"flash_attention": 0, "flash_attention_backward": 0}
    restart_at = EL_FAIL // EL_EVERY * EL_EVERY
    worst = 0.0
    for rank, r in enumerate(recs):
        tag = f"rank {rank}"
        got = {int(k): v for k, v in r["losses"].items()}
        check(sorted(got) == sorted(ref), f"(a) {tag}: steps {sorted(got)}")
        errs = [abs(got[k] - w) / abs(w) for k, w in ref.items()]
        worst = max(worst, max(errs))
        check(all(math.isfinite(x) for x in got.values())
              and max(errs) <= TM_LOSS_TOL,
              f"(a) {tag}: losses {got} against one card's {ref}")
        check(r["restarts"] == 1 and r["start_step"] == restart_at
              and r["final_step"] == EL_STEPS,
              f"(a) {tag}: restarts {r['restarts']}, restart from step "
              f"{r['start_step']}, final step {r['final_step']}")
        la = r["launches"]
        check(la["flash_attention"] > 0
              and la["flash_attention_backward"] > 0,
              f"(a) {tag}: flash launches {la}")
        for k in launches:
            launches[k] += la[k]
        check(r["restored_bad"] == [], f"(b) {tag}: restored blocks off the "
              f"checkpoint's: {r['restored_bad'][:4]}")
        check(r["fault_bad"] > 0, f"(b) {tag}: the planted fault (blocks "
              "placed at permuted coordinates) passed the block check")
    digests = {r["digest"] for r in recs} - {None}
    check(len(digests) == 1, f"(c) {len(digests)} digests of the ranks' "
          "gathered final state, not 1 (the writing rank's)")
    t0 = time.perf_counter()
    one = TrainDriver(*_el_run(cfg, ckpt_dir), device=dev)
    restore_one_s = time.perf_counter() - t0
    check(one.start_step == EL_STEPS, f"(c) one card restored step "
          f"{one.start_step}, expected {EL_STEPS}")
    same = tc.state_digest(one.state) in digests
    check(same, "(c) the final checkpoint restored on one card differs from "
          "the ranks' gathered final state")
    del one
    gc.collect()
    torch.cuda.empty_cache()
    rank_s = max(r["seconds"] for r in recs)
    secs = time.perf_counter() - t_phase + rank_s
    print(f"elastic (a): losses {[round(ref[k], 4) for k in sorted(ref)]} "
          f"on one card; the worst rank's largest rel diff {worst:.2e} "
          f"(limit {TM_LOSS_TOL}); restart from step {restart_at} onto "
          f"{EL_MESHES[1]}; flash launches over the 4 ranks {launches}")
    print(f"elastic (b): restored blocks bit-equal on every rank "
          f"{all(r['restored_bad'] == [] for r in recs)}; planted fault "
          f"(permuted coordinates) leaves off on each rank "
          f"{[r['fault_bad'] for r in recs]}")
    print(f"elastic (c): one card restored step {EL_STEPS}, equal to the "
          f"ranks' gathered final state {same} ({restore_one_s:.1f} s)")
    print(f"elastic seconds: phase {secs:.1f} (ranks {rank_s:.1f}, one-card "
          f"reference {ref_s:.1f}); checkpoint writes a rank (gather, one "
          "rank writing, barrier) " + "; ".join(
              f"{i}: " + "/".join(f"{x:.1f}" for x in r["save_s"])
              for i, r in enumerate(recs))
          + "; periodic checkpoints' snapshots (gather; the write runs "
          "behind the steps) " + "; ".join(
              f"{i}: " + "/".join(f"{x:.1f}" for x in r["snapshot_s"])
              for i, r in enumerate(recs))
          + "; restores " + "; ".join(
              f"{i}: " + "/".join(f"{x:.1f}" for x in r["restore_s"])
              for i, r in enumerate(recs))
          + "; peak GB a rank " + ", ".join(
              f"{i}: {r['peak_gb']:.1f}" for i, r in enumerate(recs))
          + " (ranks share one card over host-staged gloo: not a mesh's "
          "speed)")
    summary = {
        "layers": EL_LAYERS, "meshes": EL_MESHES, "reference": ref,
        "ranks": [{k: r[k] for k in ("losses", "launches", "save_s",
                                     "snapshot_s", "restore_s", "peak_gb",
                                     "seconds", "fault_bad", "start_step")}
                  for r in recs],
        "worst_loss_rel": worst, "launches": launches,
        "seconds": {"phase": secs, "ranks": rank_s, "reference": ref_s,
                    "one_card_restore": restore_one_s},
        "note": "four ranks share one card over host-staged gloo: times "
                "are not a mesh's speed"}
    return launches, summary


# ---------------------------------------------------------------------------
# 20. the dry run against the card
# ---------------------------------------------------------------------------

#: (arch, shape, layers (None: full depth), global batch): the dry run's
#: cells cut to fit one card
DRY_CELLS = (("h2o-danube-1.8b", "train_4k", 2, 2),
             ("h2o-danube-1.8b", "prefill_32k", None, 1),
             ("h2o-danube-1.8b", "decode_32k", None, 8),
             ("mamba2-370m", "prefill_32k", None, 1))
DRY_ARCHS = ("h2o-danube-1.8b", "mamba2-370m")
DRY_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
#: the card's peak over the dry run's ``per_device_total``
DRY_MEM_BAND = (0.5, 1.5)

_DRY_CUT = r"""
import json, sys
from repro_torch.launch import dryrun
out = []
for arch, shape, layers, batch in json.loads(sys.argv[1]):
    cut = dryrun.depth_cut(arch, layers) if layers else None
    out.append(dryrun.run_cell(arch, shape, overrides=cut, batch=batch,
                               mesh_shape=(1, 1)))
json.dump(out, open(sys.argv[2], "w"))
"""


def dryrun_phase(check):
    """Phase 20: the dry run (``launch.dryrun`` on ``meta`` tensors in a
    fake world, in subprocesses: the fake world stays out of this
    process) against the card.

    (a) ``python -m repro_torch.launch.dryrun`` for h2o-danube-1.8b and
    mamba2-370m at ``DRY_SHAPES`` on the single-pod 16x16 mesh: each
    record's roofline line (predictions from H100 data-sheet constants).
    (b) The cells of ``DRY_CELLS`` cut to fit one card, dry-run on a fake
    1x1 world, and run for real as one NCCL rank on a 1x1 mesh
    (``spawn.single_rank``) under ``OpAnalysis`` on real tensors drawn on
    the card: each kernel's launches equal exactly, the aten dots'
    operations equal exactly (the kernels' ctypes launches bypass the
    dispatcher here: their cost is compared through the launches), and
    ``max_memory_allocated`` over the call within ``DRY_MEM_BAND`` x the
    dry run's ``per_device_total``; then, without the mode, the call's
    host time and the profiler's device time by kernel beside the cut
    cell's ``step_time_s``.  (c) Planted fault: the dry run of the
    train cell with one layer fewer must fail (b)'s launch check.
    Returns ({kernel: launches of (b)}, summary)."""
    import json
    import os
    import tempfile

    import torch

    from repro_torch.dist import spawn
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged, ssd_scan
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_host_mesh

    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    sweep = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         ",".join(DRY_ARCHS), "--shape", ",".join(DRY_SHAPES), "--mesh",
         "single", "--out", tmp.name, "--force"], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    cut_json = os.path.join(tmp.name, "cut.json")
    cells = [list(c) for c in DRY_CELLS]
    fault_cell = [DRY_CELLS[0][0], DRY_CELLS[0][1], DRY_CELLS[0][2] - 1,
                  DRY_CELLS[0][3]]
    cut = subprocess.Popen(
        [sys.executable, "-c", _DRY_CUT, json.dumps(cells + [fault_cell]),
         cut_json], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)

    # (b) the real calls, while the dry runs trace on the host
    dev = torch.device("cuda")
    real = []
    mods = (fa, ssd_scan, paged)
    with spawn.single_rank(device=dev):
        for arch, shape, layers, batch in DRY_CELLS:
            over = dryrun.depth_cut(arch, layers) if layers else None
            mesh = make_host_mesh(1, 1, device=dev)
            cell = specs.input_specs(arch, shape, mesh, overrides=over,
                                     batch=batch)
            gen = torch.Generator(device=dev).manual_seed(0)
            args, held = dryrun.rank_args(cell, mesh, gen, dev)
            for m in mods:
                m.reset_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out, res = dryrun.analyze_cell(cell, mesh, args, held,
                                           device="cuda")
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            launches = {k: v for m in mods for k, v in m.launches.items()
                        if v}
            grad = (torch.enable_grad if cell.kind == "train"
                    else torch.no_grad)
            held_args = list(args)
            if cell.kind == "train":
                held_args[0] = out[0]          # the inputs were donated
            del out

            def call(a=held_args, fn=cell.fn, kind=cell.kind, grad=grad):
                with grad():
                    res = fn(*a)
                if kind == "train":
                    a[0] = res[0]
                return res
            bd = device_breakdown(call, top=6)
            real.append({"arch": arch, "shape": shape, "layers": layers,
                         "batch": batch, "launches": launches,
                         "dot_flops": res["stats"].dot_flops,
                         "peak_bytes": peak, "breakdown": bd})
            del held_args, args, call
            torch.cuda.empty_cache()

    out_a, _ = sweep.communicate(timeout=600)
    out_c, _ = cut.communicate(timeout=600)
    check(sweep.returncode == 0, f"phase 20 (a): the dry run exited "
          f"{sweep.returncode}:\n{out_a[-3000:]}")
    check(cut.returncode == 0, f"phase 20 (b): the cut dry runs exited "
          f"{cut.returncode}:\n{out_c[-3000:]}")
    sweep_recs = {}
    for arch in DRY_ARCHS:
        for shape in DRY_SHAPES:
            path = os.path.join(tmp.name, f"{arch}_{shape}_single.json")
            with open(path) as f:
                rec = json.load(f)
            sweep_recs[f"{arch}/{shape}"] = {
                "roofline": rec["roofline"], "memory": rec["memory"],
                "kernel_launches": rec["kernel_launches"],
                "trace_s": rec["trace_s"]}
            print(f"  (a) {arch} {shape} 16x16: "
                  f"{dryrun.roofline_line(rec)}")
    with open(cut_json) as f:
        dry = json.load(f)
    tmp.cleanup()

    rows, totals = [], {}
    for r, d in zip(real, dry):
        tag = f"{r['arch']} {r['shape']} (layers {r['layers'] or 'all'}, " \
              f"batch {r['batch']})"
        check(r["launches"] == d["kernel_launches"],
              f"phase 20 (b) {tag}: launches {r['launches']} on the card, "
              f"{d['kernel_launches']} in the dry run")
        want = sum(d["hlo_stats"]["dot_flops_by_name"].values())
        check(r["dot_flops"] == want, f"phase 20 (b) {tag}: dot operations "
              f"{r['dot_flops']} on the card, {want} in the dry run")
        pred = d["memory"]["per_device_total"]
        ratio = r["peak_bytes"] / pred
        check(DRY_MEM_BAND[0] <= ratio <= DRY_MEM_BAND[1],
              f"phase 20 (b) {tag}: peak {r['peak_bytes']} B, "
              f"{ratio:.3f} x the predicted {pred} B")
        for k, v in r["launches"].items():
            totals[k] = totals.get(k, 0) + v
        bd = r["breakdown"]
        step = d["roofline"]["step_time_s"] * 1e3
        rows.append({"cell": tag, "launches": r["launches"],
                     "dot_flops": r["dot_flops"], "peak_bytes":
                     r["peak_bytes"], "predicted_bytes": pred,
                     "peak_ratio": ratio, "call_ms": bd["call_ms"],
                     "device_ms": bd["device_ms"], "step_time_ms": step,
                     "bottleneck": d["roofline"]["bottleneck"],
                     "kernels": bd["kernels"]})
        print(f"  (b) {tag}: launches {r['launches']} equal, dots "
              f"{r['dot_flops']:.4g} equal, peak {r['peak_bytes'] / 1e9:.3f}"
              f" GB = {ratio:.3f} x predicted {pred / 1e9:.3f} GB; call "
              f"{bd['call_ms']:.2f} ms, device {bd['device_ms']} ms, "
              f"roofline {step:.3f} ms ({d['roofline']['bottleneck']})")
        for k in bd["kernels"]:
            print(f"      {k['ms']:9.3f} ms x{k['count']:<5d} {k['name']}")
    fault = dry[len(real)]
    check(fault["kernel_launches"] != real[0]["launches"],
          f"phase 20 (c): the dry run with one layer fewer gives the "
          f"card's launches {real[0]['launches']}")
    print(f"  (c) planted fault: {DRY_CELLS[0][2] - 1} layer(s) predict "
          f"{fault['kernel_launches']} against {real[0]['launches']}: "
          f"caught")
    seconds = time.perf_counter() - t0
    print(f"  phase 20: {seconds:.1f} s")
    return totals, {"sweep": sweep_recs, "cells": rows, "seconds": seconds}


#: phase 21: decode on a cache placed by cache_shardings: (model, its
#: depth) at full width, on a 1x4 ("data", "model") mesh of gloo ranks
#: sharing the card, in fp32 (tokens and logits against one card) and in
#: the cells' bf16 (cache bytes against the dry run's specs).  A third of
#: each model's depth since phase 23 joined the script (full depth: 96 s
#: of its 1200 s limit; every layer is alike, and zamba2's 12 keep two
#: shared-block applications)
PLACED_DECODE = (("h2o-danube-1.8b", 8), ("mamba2-370m", 16),
                 ("zamba2-1.2b", 12))
PD_MESH = (1, 4)
PD_DTYPES = ("float32", "bfloat16")
PD_BATCH, PD_PROMPT, PD_STEPS = 4, 512, 16
#: fp32 logits against one card's, x max|logit| (the CPU gates' fp32
#: tolerance, ``tests/test_torch_placed_decode.py``).  bf16 is not held
#: to one card's logits here: cuBLAS picks its kernels by shape, so the
#: rank's head counts sum in another order, and one bf16 rounding apart
#: moves the logits by ~2^-8; the bf16 run's agreement is printed
PD_LOGIT_TOL = 1e-5

_PD_DRY = r"""
import json, sys
from repro_torch.launch import dryrun
out = []
for arch, layers, batch, length in json.loads(sys.argv[1]):
    rec = dryrun.run_cell(arch, "decode_32k",
                          overrides=dryrun.depth_cut(arch, layers),
                          batch=batch, seq_len=length, mesh_shape=(1, 4))
    out.append(rec["memory"])
json.dump(out, open(sys.argv[2], "w"))
"""


def _pd_decode(params, tokens, cfg):
    """Prefill, then ``PD_STEPS`` greedy steps: {logits (steps + 1, B, V)
    fp32 on the host, tokens (B, steps), the prefill cache's bytes
    (``pos`` aside), the peaks of ``max_memory_allocated`` over the
    prefill and over the steps, and the seconds of each}."""
    import torch

    from repro_torch.models import decode as dec
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache = dec.prefill(params, tokens, cfg,
                                max_len=PD_PROMPT + PD_STEPS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pre_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    held = {k: v for k, v in cache.items() if k != "pos"}
    cache_bytes = sum(t.numel() * t.element_size()
                      for part in held.values() for t in part.values())
    out, toks = [logits.float().cpu()], []
    for _ in range(PD_STEPS):
        nxt = logits.argmax(-1)[:, None]
        toks.append(nxt.cpu())
        logits, cache = dec.decode_step(params, nxt, cache, cfg)
        out.append(logits.float().cpu())
    torch.cuda.synchronize()
    return {"logits": torch.stack(out), "tokens": torch.cat(toks, dim=1),
            "cache_bytes": cache_bytes, "prefill_peak": pre_peak,
            "decode_peak": torch.cuda.max_memory_allocated(),
            "prefill_s": t1 - t0, "decode_s": time.perf_counter() - t1}


def _pd_params(name, layers, dtype, dev):
    import gc

    import torch

    from repro_torch.models import init_params
    from repro_torch.models.transformer import compute_params
    cfg = _tp_cfg(name, n_layers=layers, dtype=dtype)
    params = compute_params(init_params(
        torch.Generator(device=dev).manual_seed(0), cfg), cfg)
    gc.collect()
    torch.cuda.empty_cache()
    return cfg, params


def _pd_runs():
    return [(m, d) for m in PLACED_DECODE for d in PD_DTYPES]


def _pd_agreement(got, want, w_toks, toks):
    """(logit error x max|logit| up to the first token that differs, a
    line saying where the tokens part: '' when they never do).  Logits i
    decide token i, so up to the first differing token both runs saw
    the same inputs."""
    import numpy as np
    scale = want.abs().max().item()
    diff = np.asarray(toks) != w_toks.numpy()
    steps = np.flatnonzero(diff.any(axis=0))
    upto = PD_STEPS + 1 if steps.size == 0 else steps[0] + 1
    err = (got[:upto] - want[:upto]).abs().max().item() / scale
    if steps.size == 0:
        return err, ""
    top2 = want[steps[0]].topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1])[diff[:, steps[0]]]
    return err, (f"tokens part from step {steps[0]} on ({int(diff.sum())} "
                 f"of {diff.size}); one card's top-2 gap there "
                 f"{gap.min().item() / scale:.3e} x max|logit|")


def placed_decode_ranks(spec, out_dir):
    """Phase 21 in each of four gloo ranks sharing the card: every
    model's prefill and greedy decode on the 1x4 mesh (logits to
    ``out_dir``); every rank's record on rank 0."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan
    from repro_torch.launch.mesh import make_mesh, set_mesh

    dev = torch.device("cuda")
    rank = dist.get_rank()
    mesh = make_mesh(PD_MESH, ("data", "model"), device="cuda",
                     backend="gloo")
    rec = {"rank": rank, "models": {}}
    for (name, layers), dtype in _pd_runs():
        cfg, params = _pd_params(name, layers, dtype, dev)
        tokens = torch.as_tensor(spec[name], device=dev)
        fa.reset_launches()
        ssd_scan.reset_launches()
        with torch.no_grad(), set_mesh(mesh):
            res = _pd_decode(params, tokens, cfg)
        torch.save(res.pop("logits"), f"{out_dir}/{name}.{dtype}.{rank}.pt")
        res["tokens"] = res["tokens"].tolist()
        res["launches"] = {"flash_attention": fa.launches["flash_attention"],
                           "ssd_scan": ssd_scan.launches["ssd_scan"]}
        rec["models"][f"{name}/{dtype}"] = res
        del params, tokens, res
        gc.collect()
        torch.cuda.empty_cache()
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, rec)
    return out


def placed_decode_phase(check):
    """Phase 21 (module docstring).  Returns ({kernel: launches over the
    ranks}, summary)."""
    import gc
    import os
    import tempfile

    import numpy as np
    import torch

    from repro_torch.dist import spawn

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_placed_")
    dry_json = os.path.join(tmp.name, "dry.json")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    dry = subprocess.Popen(
        [sys.executable, "-c", _PD_DRY, json.dumps(
            [[n, layers, PD_BATCH, PD_PROMPT + PD_STEPS]
             for n, layers in PLACED_DECODE]), dry_json],
        env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    rng = np.random.default_rng(21)
    spec = {name: rng.integers(0, _tp_cfg(name).vocab,
                               (PD_BATCH, PD_PROMPT)).tolist()
            for name, _ in PLACED_DECODE}

    # one card, unplaced
    t0 = time.perf_counter()
    want = {}
    for (name, layers), dtype in _pd_runs():
        cfg, params = _pd_params(name, layers, dtype, dev)
        with torch.no_grad():
            want[f"{name}/{dtype}"] = _pd_decode(
                params, torch.as_tensor(spec[name], device=dev), cfg)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    recs = spawn.run_ranks(placed_decode_ranks, 4, device="cuda",
                           backend="gloo", args=(spec, tmp.name),
                           timeout=600)
    ranks_s = time.perf_counter() - t0
    out_d, _ = dry.communicate(timeout=600)
    check(dry.returncode == 0, f"phase 21: the cut dry runs exited "
          f"{dry.returncode}:\n{out_d[-3000:]}")
    with open(dry_json) as f:
        dry_mem = dict(zip([n for n, _ in PLACED_DECODE], json.load(f)))

    launches = {"flash_attention": 0, "ssd_scan": 0}
    rows = {}
    for (name, layers), dtype in _pd_runs():
        key = f"{name}/{dtype}"
        w, mem = want[key], dry_mem[name]
        row = {"layers": layers, "dtype": dtype, "ranks": {},
               "one_card": {k: w[k] for k in (
                   "cache_bytes", "decode_peak", "prefill_peak",
                   "prefill_s", "decode_s")}}
        first = None
        for r in recs:
            m = r["models"][key]
            tag = f"phase 21 {key} rank {r['rank']}"
            got = torch.load(f"{tmp.name}/{name}.{dtype}.{r['rank']}.pt")
            err, parted = _pd_agreement(got, w["logits"], w["tokens"],
                                        m["tokens"])
            if first is None:
                first = got
            check(torch.equal(got, first), f"{tag}: the ranks' logits "
                  "differ")
            if dtype == "float32":
                check(not parted, f"{tag}: the greedy tokens differ from "
                      f"one card's: {parted}, the logits {err:.3e} x "
                      f"max|logit| apart until then")
                check(err <= PD_LOGIT_TOL, f"{tag}: logits {err:.3e} x "
                      f"max|logit| off one card's (limit {PD_LOGIT_TOL})")
            else:
                check(m["cache_bytes"] == mem["spec_cache_bytes"]
                      == mem["cache_bytes"],
                      f"{tag}: holds {m['cache_bytes']} cache bytes, the "
                      f"dry run's specs place {mem['spec_cache_bytes']}")
            need = (("flash_attention",) if name != "mamba2-370m" else ())
            need += (("ssd_scan",) if name != "h2o-danube-1.8b" else ())
            for k in need:
                check(m["launches"][k] > 0, f"{tag}: {k} never launched")
            for k, v in m["launches"].items():
                launches[k] += v
            row["ranks"][r["rank"]] = {
                "logit_err": err, "tokens_part": parted,
                **{k: m[k] for k in ("cache_bytes", "prefill_peak",
                                     "decode_peak", "launches",
                                     "prefill_s", "decode_s")}}
        rows[key] = row
        r0 = row["ranks"][0]
        agree = (f"tokens equal one card's on every rank, logits "
                 f"{r0['logit_err']:.3e} x max|logit| apart"
                 if not r0["tokens_part"] else
                 f"{r0['tokens_part']}, logits {r0['logit_err']:.3e} x "
                 f"max|logit| apart until then")
        line = (f"  placed decode {key} ({layers} layers, batch {PD_BATCH} "
                f"x {PD_PROMPT} + {PD_STEPS} steps, 1x4): {agree}; cache "
                f"{r0['cache_bytes'] / 1e6:.3f} MB a rank (one card "
                f"{w['cache_bytes'] / 1e6:.3f} MB)")
        if dtype == "bfloat16":
            line += (f" = the dry run's spec {mem['spec_cache_bytes'] / 1e6:.3f}"
                     f" MB; decode peak " + ", ".join(
                         f"{v['decode_peak'] / 1e9:.3f}"
                         for v in row["ranks"].values())
                     + f" GB a rank beside the dry run's decode "
                     f"per_device_total {mem['per_device_total'] / 1e9:.3f} "
                     f"GB (one card {w['decode_peak'] / 1e9:.3f}; prefill "
                     f"peak {r0['prefill_peak'] / 1e9:.3f} GB a rank, one "
                     f"card {w['prefill_peak'] / 1e9:.3f})")
            row["dry_run"] = mem
        print(line + f"; launches {r0['launches']} a rank; prefill "
              f"{r0['prefill_s']:.2f} s, {PD_STEPS} steps "
              f"{r0['decode_s']:.2f} s (host-staged gloo)")
    tmp.cleanup()
    secs = time.perf_counter() - t_phase
    print(f"  phase 21: {secs:.1f} s (one card {ref_s:.1f}, four ranks "
          f"{ranks_s:.1f} with spawning; ranks share one card over "
          f"host-staged gloo: not a mesh's speed)")
    return launches, {"models": rows, "seconds": {
        "phase": secs, "one_card": ref_s, "ranks": ranks_s}}


#: phase 22: the example scripts, each with its arguments and the lines
#: and kernels its run must show
EXAMPLES = (
    ("torch_quickstart.py", ("--ranks", "4"),
     ("quickstart OK", "multi-chip (2x2 mesh, strategy=cannon)"),
     ("output_stationary", "fused_chain", "fused_dag")),
    ("torch_serve_lm.py", (), ("serve OK", "decode compiles 1"),
     ("paged_gather", "flash_attention")),
    ("torch_train_lm.py", (), ("DECREASED",),
     ("flash_attention", "flash_attention_backward")),
    ("torch_dse_explore.py", (), ("pareto frontier",
                                  "generated search winner"), ()),
)

_EXAMPLE = r"""
import json, runpy, sys
from repro_torch.kernels import (bsr_gemm, flash_attention, fused_chain,
                                 paged, ssd_scan, stt_gemm)
mods = (stt_gemm, bsr_gemm, fused_chain, paged, flash_attention, ssd_scan)
for m in mods:
    m.reset_launches()
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
print("LAUNCHES " + json.dumps({k: v for m in mods
                                for k, v in m.launches.items()}))
"""


def start_examples(tmp):
    """Phase 22's subprocesses, started together: {script: Popen}."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    for script, argv, _, _ in EXAMPLES:
        extra = (("--ckpt-dir", os.path.join(tmp, "ckpt"))
                 if script == "torch_train_lm.py" else ())
        procs[script] = subprocess.Popen(
            [sys.executable, "-c", _EXAMPLE,
             str(ROOT / "examples" / script), *argv, *extra],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    return procs


def examples_phase(check, procs):
    """Phase 22 (module docstring): wait for ``start_examples``'s runs
    and check them.  Returns ({kernel: launches}, summary)."""
    t0 = time.perf_counter()
    totals, summary = {}, {}
    for script, _, lines, kernels in EXAMPLES:
        p = procs[script]
        out, _ = p.communicate(timeout=900)
        (OUT_DIR / (script + ".log")).write_text(out)
        check(p.returncode == 0, f"phase 22 {script} exited "
              f"{p.returncode}:\n{out[-3000:]}")
        for line in lines:
            check(line in out, f"phase 22 {script}: no {line!r} line")
        got = json.loads(out.rsplit("LAUNCHES ", 1)[1].splitlines()[0])
        for k in kernels:
            check(got.get(k, 0) > 0, f"phase 22 {script}: {k} never "
                  "launched")
        for k, v in got.items():
            totals[k] = totals.get(k, 0) + v
        shown = [ln for ln in out.splitlines()
                 if any(key in ln for key in lines)]
        summary[script] = {"lines": shown, "launches": got}
        print(f"  {script}: {' | '.join(shown)}; launches "
              f"{ {k: v for k, v in got.items() if v} }")
    summary["wait_s"] = time.perf_counter() - t0
    return totals, summary


#: phase 23: serving with parameters placed by the cells' param_shardings,
#: at full width on a 2x2 ("data", "model") mesh of gloo ranks sharing
#: the card (the FSDP gather over "data", and the activations' gathers
#: and the row-parallel reductions over "model", run): (model, fp32
#: depth, fp32 greedy steps, bf16 depth,
#: bf16 steps; no fp32 run where its depth is None).  Every pass gathers
#: every layer through host-staged gloo, about 0.35 GB of weights a
#: second a rank on one card (danube fp32 at 24 layers: 19 s a decode
#: step), so the fp32 runs (against one card) are cut in depth and steps;
#: the bf16 runs (against the dry run) keep danube's and zamba2's full
#: depth, zamba2's with a decode step (danube's prefill alone); mixtral-
#: 8x22b runs 1 of 56 layers, prefill only, in bf16 alone (its fp32
#: prefill gathers 10.8 GB: 35 s)
PLACED_PARAMS = (("h2o-danube-1.8b", 2, 1, 24, 0),
                 ("zamba2-1.2b", 6, 1, 38, 1),
                 ("mixtral-8x22b", None, 0, 1, 0))
PP_MESH = (2, 2)
PP_BATCH, PP_PROMPT = 4, 512
#: danube's slot engine on the mesh, at its fp32 depth: requests (their
#: prompt lengths) and steps
PP_SLOT = dict(capacity=2, max_context=256, page_size=16)
PP_SLOT_LENS, PP_SLOT_STEPS = (100, 180), 2
#: a rank's bf16 peak against the dry run's per_device_total of the same
#: cut cell on a fake 2x2 world standing for gloo
PP_PEAK_BAND = (0.9, 1.3)
#: bf16 logits against one card's, x max|logit| (phase 17 (c)'s bound);
#: a gather of the wrong block moves them by their whole size
PP_BF16_TOL = 5e-2

_PP_DRY = r"""
import json, sys
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import fake_world, make_mesh
out = []
for arch, layers, steps, batch, prompt in json.loads(sys.argv[1]):
    cut = dryrun.depth_cut(arch, layers)
    shapes = [("prefill_32k", prompt)]
    if steps:
        shapes.append(("decode_32k", prompt + steps))
    rec = {}
    for shape, length in shapes:
        r = dryrun.run_cell(arch, shape, overrides=cut, batch=batch,
                            seq_len=length, mesh_shape=(2, 2),
                            backend="gloo")
        rec[shape] = {"memory": r["memory"],
                      "launches": r["kernel_launches"]}
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"))
        cell = specs.input_specs(arch, "decode_32k", mesh, overrides=cut,
                                 batch=batch, seq_len=prompt + 1)
        rec["param_bytes"] = dryrun.block_bytes(
            cell.args[0], cell.in_shardings[0], {"data": 2, "model": 2})
    out.append(rec)
json.dump(out, open(sys.argv[2], "w"))
"""


def _pp_runs():
    """(model, depth, dtype, steps) of every run, fp32 first a model."""
    return [(name, layers, dtype, steps)
            for name, l32, s32, l16, s16 in PLACED_PARAMS
            for layers, dtype, steps in ((l32, "float32", s32),
                                         (l16, "bfloat16", s16))
            if layers is not None]


def _pp_whole(name, layers, dtype, dev):
    """(cfg, the whole seeded parameters on the card): fp32 masters for
    fp32; for bf16 every leaf in bf16, as the serving cells' parameters
    (``launch.specs.params_struct(cfg, dtype=bfloat16)``)."""
    import torch

    from repro_torch.launch.dryrun import depth_cut
    from repro_torch.models import init_params
    cfg = _tp_cfg(name, dtype=dtype, **depth_cut(name, layers))
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    if dtype == "bfloat16":
        params = _map_leaves(lambda t: t.to(torch.bfloat16), params)
    return cfg, params


def _map_leaves(fn, tree):
    return {k: _map_leaves(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _pp_decode(params, tokens, cfg, steps):
    """Prefill (its cache sized for ``steps``), then ``steps`` greedy
    steps: {logits (steps + 1, B, V) fp32 on the host, tokens (B, steps
    + 1): each row's argmax, and per part (``prefill``; ``decode`` when
    ``steps``) the peak of ``max_memory_allocated``, the launches of
    flash and the SSD scan and the seconds}."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan
    from repro_torch.models import decode as dec

    def part(t0):
        torch.cuda.synchronize()
        out = {"peak": torch.cuda.max_memory_allocated(),
               "launches": {"flash_attention": fa.launches["flash_attention"],
                            "ssd_scan": ssd_scan.launches["ssd_scan"]},
               "s": time.perf_counter() - t0}
        fa.reset_launches()
        ssd_scan.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        return out
    part(time.perf_counter())
    t0 = time.perf_counter()
    logits, cache = dec.prefill(params, tokens, cfg,
                                max_len=PP_PROMPT + steps)
    res = {"prefill": part(t0)}
    out = [logits.float().cpu()]
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, cache = dec.decode_step(params, logits.argmax(-1)[:, None],
                                        cache, cfg)
        out.append(logits.float().cpu())
    if steps:
        res["decode"] = part(t0)
    logits = torch.stack(out)
    res.update(logits=logits, tokens=logits.argmax(-1).T)
    return res


def _pp_slots(params, cfg, prompts, dev):
    """Danube's slot engine: the requests inserted, ``PP_SLOT_STEPS``
    steps; (the packed results, step builds, gather launches)."""
    import numpy as np

    from repro_torch.kernels import paged
    from repro_torch.serve import SlotEngine
    eng = SlotEngine(params, cfg, device=dev, **PP_SLOT)
    paged.reset_launches()
    for p in prompts:
        eng.insert(np.asarray(p, np.int64),
                   max_new_tokens=PP_SLOT_STEPS + 1)
    got = [eng.step().data.tolist() for _ in range(PP_SLOT_STEPS)]
    return got, eng.decode_compiles, paged.launches["paged_gather"], eng


def _pp_gather_bound(whole, specs, cfg, mesh):
    """The most gathered bytes a rank may hold at once over a pass,
    from the specs (``models.placed.held_bytes``): the larger of the
    largest layer (a stacked subtree's one layer, the hybrid's shared
    block) gathered over ``data`` alone, each leaf its ``model`` block
    (the SSM mixer whole, declared), and the output projection's vocab
    block (a pass drops its last layer before it gathers the
    projection), plus the unstacked norms; beside it the largest layer
    gathered whole (``whole_layer``), which is above the bound."""
    from repro_torch.models import placed as pp
    proj = "embed" if cfg.tie_embeddings else "unembed"
    layer = whole_layer = norms = 0
    for key, sub in whole.items():
        if not isinstance(sub, dict):
            if key not in ("embed", "unembed"):
                norms += pp.held_bytes(sub, specs[key], mesh)
            continue
        leaves = [t for _, t in _leaves(sub)]
        n_whole = sum(t.numel() * t.element_size() for t in leaves)
        n = pp.held_bytes(sub, specs[key], mesh)
        if key in ("layers", "encoder", "cross_layers"):
            depth = leaves[0].shape[0]
            n, n_whole = n // depth, n_whole // depth
        layer, whole_layer = max(layer, n), max(whole_layer, n_whole)
    vocab = pp.held_bytes(whole[proj], specs[proj], mesh)
    return {"bound": max(layer, vocab) + norms, "layer": layer,
            "vocab": vocab, "whole_layer": whole_layer}


def placed_params_ranks(spec, out_dir):
    """Phase 23 in each of four gloo ranks sharing the card: each run's
    parameters drawn whole by one rank at a time, placed
    (``models.placed.place_params``) and freed, then prefill and greedy
    steps on the 2x2 mesh (fp32 logits to ``out_dir``), danube's slot
    engine on it too; every rank's record on rank 0."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh, set_mesh
    from repro_torch.models import placed as pp
    from repro_torch.models.placed import place_params

    dev = torch.device("cuda")
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = make_mesh(PP_MESH, ("data", "model"), device="cuda",
                     backend="gloo")
    rec = {"rank": rank, "models": {}}
    for name, layers, dtype, steps in _pp_runs():
        t0 = time.perf_counter()
        placed = None
        for r in range(world):             # one whole tree on the card
            if r == rank:
                cfg, whole = _pp_whole(name, layers, dtype, dev)
                placed = place_params(whole, cfg, mesh)
                bound = _pp_gather_bound(whole, placed.specs, cfg, mesh)
                del whole
                gc.collect()
                torch.cuda.empty_cache()
            dist.barrier()
        setup_s = time.perf_counter() - t0
        tokens = torch.as_tensor(spec[name], device=dev)
        pp.GATHERED.reset()
        with torch.no_grad(), set_mesh(mesh):
            res = _pp_decode(placed, tokens, cfg, steps)
        res["gathered"] = dict(bound, peak=pp.GATHERED.peak)
        res["param_bytes"] = dryrun.storage_bytes(placed)
        res["setup_s"] = setup_s
        logits = res.pop("logits")
        torch.save(logits, f"{out_dir}/{name}.{dtype}.{rank}.pt")
        res["tokens"] = res["tokens"].tolist()
        if name == "h2o-danube-1.8b" and dtype == "float32":
            t1 = time.perf_counter()
            with torch.no_grad():
                got, builds, gathers, eng = _pp_slots(placed, cfg,
                                                      spec["slots"], dev)
            res["slots"] = {"results": got, "builds": builds,
                            "gathers": gathers,
                            "param_bytes": dryrun.storage_bytes(eng.params),
                            "s": time.perf_counter() - t1}
            del eng
        rec["models"][f"{name}/{dtype}"] = res
        del placed, tokens, logits
        gc.collect()
        torch.cuda.empty_cache()
    out = [None] * world
    dist.all_gather_object(out, rec)
    return out


def _pp_bf16_agreement(got, want, tag, check):
    """A bf16 run's logits (steps + 1, B, V) against one card's: every
    row at the prefill, a later step's rows only while their tokens so
    far agree (a row fed another token decodes something else).  Within
    ``PP_BF16_TOL`` x max|logit|, and where the greedy tokens differ,
    one card's logits of both tokens within it too (a near tie)."""
    import torch

    scale = want.abs().max().item()
    tok_g, tok_w = got.argmax(-1), want.argmax(-1)
    same = (tok_g == tok_w).cumprod(0).bool()
    alive = torch.cat([torch.ones_like(same[:1]), same[:-1]])
    err = ((got - want).abs().amax(-1)[alive].max().item() / scale)
    check(err <= PP_BF16_TOL, f"{tag}: logits {err:.3e} x max|logit| off "
          f"one card's bf16 (limit {PP_BF16_TOL})")
    parted = alive & ~same
    gap = (want.gather(-1, tok_w[..., None]) - want.gather(
        -1, tok_g[..., None]))[..., 0][parted]
    worst = gap.max().item() / scale if gap.numel() else 0.0
    check(worst <= PP_BF16_TOL, f"{tag}: a greedy token differs from one "
          f"card's where its logit is {worst:.3e} x max|logit| below one "
          f"card's choice: no near tie")
    return {"logit_err": err, "tokens_compared": int(alive.sum()),
            "tokens_equal": int((alive & same).sum())}


def placed_params_phase(check):
    """Phase 23 (module docstring).  Returns ({kernel: launches over the
    ranks}, summary)."""
    import gc
    import os
    import tempfile

    import numpy as np
    import torch

    from repro_torch.dist import spawn

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_params_")
    dry_json = os.path.join(tmp.name, "dry.json")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    dry = subprocess.Popen(
        [sys.executable, "-c", _PP_DRY, json.dumps(
            [[n, l16, s16, PP_BATCH, PP_PROMPT]
             for n, _, _, l16, s16 in PLACED_PARAMS]), dry_json],
        env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    rng = np.random.default_rng(23)
    spec = {name: rng.integers(0, _tp_cfg(name).vocab,
                               (PP_BATCH, PP_PROMPT)).tolist()
            for name, *_ in PLACED_PARAMS}
    spec["slots"] = [rng.integers(0, _tp_cfg(PLACED_PARAMS[0][0]).vocab,
                                  (n,)).tolist() for n in PP_SLOT_LENS]

    # one card, whole parameters: the yardsticks, on the host
    t0 = time.perf_counter()
    want = {}
    for name, layers, dtype, steps in _pp_runs():
        cfg, params = _pp_whole(name, layers, dtype, dev)
        with torch.no_grad():
            want[f"{name}/{dtype}"] = _pp_decode(params, torch.as_tensor(
                spec[name], device=dev), cfg, steps)
            if name == "h2o-danube-1.8b" and dtype == "float32":
                want["slots"], _, _, eng = _pp_slots(params, cfg,
                                                     spec["slots"], dev)
                del eng
        del params
        gc.collect()
        torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    recs = spawn.run_ranks(placed_params_ranks, 4, device="cuda",
                           backend="gloo", args=(spec, tmp.name),
                           timeout=600)
    ranks_s = time.perf_counter() - t0
    out_d, _ = dry.communicate(timeout=600)
    check(dry.returncode == 0, f"phase 23: the cut dry runs exited "
          f"{dry.returncode}:\n{out_d[-3000:]}")
    with open(dry_json) as f:
        dry_rec = dict(zip([n for n, *_ in PLACED_PARAMS], json.load(f)))

    launches = {"flash_attention": 0, "ssd_scan": 0, "paged_gather": 0}
    rows = {}
    lo, hi = PP_PEAK_BAND
    for name, layers, dtype, steps in _pp_runs():
        key = f"{name}/{dtype}"
        parts = ("prefill", "decode") if steps else ("prefill",)
        row = {"layers": layers, "dtype": dtype, "steps": steps,
               "ranks": {}}
        first = None
        for r in recs:
            m = r["models"][key]
            tag = f"phase 23 {key} rank {r['rank']}"
            entry = {k: m[k] for k in ("param_bytes", "setup_s")}
            for p in parts:
                for k, v in m[p]["launches"].items():
                    launches[k] += v
                entry.update({f"{p}_{k}": m[p][k]
                              for k in ("peak", "launches", "s")})
            g = m["gathered"]
            check(0 < g["peak"] <= g["bound"], f"{tag}: {g['peak']} "
                  f"gathered bytes alive at once, above the larger of one "
                  f"layer's {g['layer']} gathered over data alone and the "
                  f"output projection's vocab block {g['vocab']}, plus the "
                  f"norms ({g['bound']})")
            check(g["whole_layer"] > g["bound"], f"{tag}: one layer "
                  f"gathered whole ({g['whole_layer']}) is within the "
                  f"bound {g['bound']}: the gate cannot see a gather over "
                  f"model")
            entry["gathered"] = g
            w = want[key]
            got = torch.load(f"{tmp.name}/{name}.{dtype}.{r['rank']}.pt")
            if first is None:
                first = got
            check(torch.equal(got, first), f"{tag}: the ranks' logits "
                  "differ")
            if dtype == "float32":
                diff = np.asarray(m["tokens"]) != w["tokens"].numpy()
                check(not diff.any(), f"{tag}: greedy tokens differ from "
                      f"one card's at {int(diff.sum())} of {diff.size}")
                scale = w["logits"].abs().max().item()
                err = (got - w["logits"]).abs().max().item() / scale
                check(err <= PD_LOGIT_TOL, f"{tag}: logits {err:.3e} x "
                      f"max|logit| off one card's (limit {PD_LOGIT_TOL})")
                entry["logit_err"] = err
                if "slots" in m:
                    sl = m["slots"]
                    check(sl["results"] == want["slots"], f"{tag}: the slot "
                          "engine's results differ from one card's")
                    check(sl["builds"] == 1, f"{tag}: {sl['builds']} decode "
                          "builds")
                    check(sl["gathers"] > 0, f"{tag}: the paged gather never "
                          "launched")
                    launches["paged_gather"] += sl["gathers"]
                    entry["slots"] = {k: sl[k] for k in (
                        "builds", "gathers", "param_bytes", "s")}
            else:
                entry.update(_pp_bf16_agreement(got, w["logits"], tag,
                                                check))
                d = dry_rec[name]
                check(m["param_bytes"] == d["param_bytes"],
                      f"{tag}: holds {m['param_bytes']} parameter bytes, "
                      f"the cell's param_shardings place {d['param_bytes']}")
                for p in parts:
                    dm = d[f"{p}_32k"]
                    ratio = m[p]["peak"] / dm["memory"]["per_device_total"]
                    entry[f"{p}_ratio"] = ratio
                    check(lo <= ratio <= hi, f"{tag}: {p} peak "
                          f"{m[p]['peak'] / 1e9:.3f} GB, {ratio:.3f}x the "
                          f"dry run's per_device_total (band {lo}-{hi})")
                    got_l = {k: v for k, v in m[p]["launches"].items() if v}
                    check(got_l == dm["launches"], f"{tag}: {p} launches "
                          f"{got_l}, the dry run counts {dm['launches']}")
            row["ranks"][r["rank"]] = entry
        rows[key] = row
        r0 = row["ranks"][0]
        line = (f"  placed params {key} ({layers} layers, batch {PP_BATCH} "
                f"x {PP_PROMPT} + {steps} steps, 2x2): ")
        if dtype == "float32":
            line += (f"tokens equal one card's on every rank, logits "
                     f"{r0['logit_err']:.3e} x max|logit| apart")
            if "slots" in r0:
                line += (f"; slot engine ({len(PP_SLOT_LENS)} requests, "
                         f"{PP_SLOT_STEPS} steps) results equal one card's, "
                         f"{r0['slots']['gathers']} gathers a rank, "
                         f"{r0['slots']['s']:.1f} s")
        else:
            d = dry_rec[name]
            line += (f"{r0['param_bytes'] / 1e6:.3f} MB of parameters a rank "
                     f"= the specs' {d['param_bytes'] / 1e6:.3f}; peak "
                     + "; ".join(
                         f"{p} " + ", ".join(
                             f"{v[f'{p}_peak'] / 1e9:.3f}"
                             for v in row["ranks"].values())
                         + f" GB a rank, {r0[f'{p}_ratio']:.3f}x the dry "
                         f"run's {d[f'{p}_32k']['memory']['per_device_total'] / 1e9:.3f}"
                         for p in parts)
                     + f"; prefill launches {r0['prefill_launches']}; "
                     f"logits {r0['logit_err']:.3e} x max|logit| off one "
                     f"card's bf16, tokens {r0['tokens_equal']} of "
                     f"{r0['tokens_compared']} equal"
                     + ("" if r0["tokens_equal"] == r0["tokens_compared"]
                        else " (the rest near ties)"))
            row["dry_run"] = d
        g0 = r0["gathered"]
        line += (f"; gathered at once {g0['peak'] / 1e6:.1f} MB a rank "
                 f"(bound {g0['bound'] / 1e6:.1f}: the larger of a "
                 f"layer's blocks {g0['layer'] / 1e6:.1f} and the vocab "
                 f"block {g0['vocab'] / 1e6:.1f}, + the norms; one layer "
                 f"whole {g0['whole_layer'] / 1e6:.1f})")
        print(line + f"; prefill {r0['prefill_s']:.2f} s"
              + (f", {steps} steps {r0['decode_s']:.2f} s" if steps else "")
              + f", draw and place {r0['setup_s']:.1f} s (host-staged "
              f"gloo)")
    tmp.cleanup()
    secs = time.perf_counter() - t_phase
    print(f"  phase 23: {secs:.1f} s (one card {ref_s:.1f}, four ranks "
          f"{ranks_s:.1f} with spawning; ranks share one card over "
          f"host-staged gloo: not a mesh's speed)")
    return launches, {"models": rows, "seconds": {
        "phase": secs, "one_card": ref_s, "ranks": ranks_s}}


#: a kernels-line row's last name part -> its launch counter's key, where
#: the two differ
ROW_KEYS = {"bsr_matmul": "bsr", "fused_chain_matmul": "fused_chain"}


def add_launches(kernels, launches, tag):
    """Add a phase's launches to the kernels line's rows (and their
    backward entries), each also under ``launches_<tag>``."""
    for row in kernels:
        name = row["name"].split(".")[-1]
        key = ROW_KEYS.get(name, name)
        if launches.get(key):
            row["launches"] += launches[key]
            row[f"launches_{tag}"] = launches[key]
        back = launches.get(f"{key}_backward")
        if back and "backward" in row:
            row["backward"]["launches"] += back
            row["backward"][f"launches_{tag}"] = back


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

    # -- 13. MoE, encdec and vlm serving -------------------------------------
    family_launches, family_flash, family_summary = family_serve_phase(check)
    for row in kernels:
        name = row["name"].split(".")[-1]
        if name in family_launches:
            row["launches"] += family_launches[name]
            row["launches_family_serve"] = family_launches[name]
        if name == "flash_attention":
            row["family_shapes"] = family_flash
    phase("family serve")

    # -- 14. training ---------------------------------------------------------
    backward_entry, train_forward, train_summary = train_phase(check)
    for row in kernels:
        if row["name"].split(".")[-1] == "flash_attention":
            row["launches"] += train_forward
            row["launches_training"] = train_forward
            row["backward"] = backward_entry
    phase("training")

    # -- 15. ssm and hybrid training ----------------------------------------
    ssd_entry, ssd_train, flash_train, ssm_train_summary = \
        ssm_train_phase(check)
    for row in kernels:
        name = row["name"].split(".")[-1]
        if name == "ssd_scan":
            row["launches"] += ssd_train
            row["launches_training"] = ssd_train
            row["backward"] = ssd_entry
        if name == "flash_attention":
            row["launches"] += flash_train["flash_attention"]
            row["launches_training"] += flash_train["flash_attention"]
            row["backward"]["launches"] += \
                flash_train["flash_attention_backward"]
    phase("ssm training")

    # -- 16. the generator's mesh --------------------------------------------
    mesh_summary = mesh_phase(check)
    phase("mesh")

    # -- 17. serving on a model mesh -------------------------------------------
    tp_launches, tp_summary = model_mesh_phase(check)
    add_launches(kernels, tp_launches, "model_mesh")
    phase("model mesh")

    # -- 18. a sharded train step on a model mesh ----------------------------
    # (phase 19's rank part runs in the same four ranks, after phase 18's)
    el_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_elastic_")
    tm_launches, tm_offset_rows, tm_summary, el_recs = train_mesh_phase(
        check, el_dir.name)
    for row in kernels:
        if row["name"].split(".")[-1] == "flash_attention":
            row["launches"] += tm_launches["flash_attention"]
            row["launches_train_mesh"] = tm_launches["flash_attention"]
            row["backward"]["launches"] += \
                tm_launches["flash_attention_backward"]
            row["backward"]["launches_train_mesh"] = \
                tm_launches["flash_attention_backward"]
            row["backward"]["q_offset_shapes"] = tm_offset_rows
    phase("train mesh")

    # -- 19. elastic training on a model mesh ---------------------------------
    el_launches, el_summary = elastic_phase(check, el_recs, el_dir.name)
    el_dir.cleanup()
    for row in kernels:
        if row["name"].split(".")[-1] == "flash_attention":
            row["launches"] += el_launches["flash_attention"]
            row["launches_elastic"] = el_launches["flash_attention"]
            row["backward"]["launches"] += \
                el_launches["flash_attention_backward"]
            row["backward"]["launches_elastic"] = \
                el_launches["flash_attention_backward"]
    phase("elastic")
    # the ranks' part of phase 19 ran inside phase 18's timer
    phase_s["train mesh"] = round(
        phase_s["train mesh"] - el_summary["seconds"]["ranks"], 1)
    phase_s["elastic"] = round(el_summary["seconds"]["phase"], 1)

    # -- 20. the dry run against the card, timed with the card to itself ----
    dry_launches, dry_summary = dryrun_phase(check)
    add_launches(kernels, dry_launches, "dryrun")
    phase("dry run")

    # -- 22. the examples, started beside 21 and 23 (their subprocesses
    # count their own launches and hold little of the card) ----------------
    ex_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_examples_")
    ex_procs = start_examples(ex_dir.name)

    # -- 21. decode on a placed cache ------------------------------------------
    pd_launches, pd_summary = placed_decode_phase(check)
    add_launches(kernels, pd_launches, "placed_decode")
    phase("placed decode")

    # -- 23. serving with placed parameters -----------------------------------
    pp_launches, pp_summary = placed_params_phase(check)
    add_launches(kernels, pp_launches, "placed_params")
    phase("placed params")
    ex_launches, ex_summary = examples_phase(check, ex_procs)
    ex_dir.cleanup()
    add_launches(kernels, ex_launches, "examples")
    phase("examples")
    (OUT_DIR / "chip_smoke_cases.json").write_text(json.dumps(
        {"device": smi, "cases": cases, "kernels": kernels,
         "tune": tune_summary, "serve": serve_summary,
         "ssm_serve": ssm_summary, "family_serve": family_summary,
         "training": train_summary, "ssm_training": ssm_train_summary,
         "mesh": mesh_summary, "model_mesh": tp_summary,
         "train_mesh": tm_summary, "elastic": el_summary,
         "dryrun": dry_summary, "placed_decode": pd_summary,
         "examples": ex_summary, "placed_params": pp_summary,
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
