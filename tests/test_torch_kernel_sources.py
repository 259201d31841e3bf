"""The kernels' sources against the Python side that launches and times
them: every kernel is named where chip_smoke.py finds it in a trace, the
output-stationary scratch path and the reduction tree run the SIMT tile
and streaming kernels (never the first version's tile_product), the BSR
kernel runs the same SIMT tile mainloop over its block-rows and sums as
the output-stationary tile does, without atomics, tile constants
are defined once, the operand-stationary chunk depth is defined once,
the fused megakernel's dot stages run the SIMT tile mainloop and sum
their k splits without atomics, the bf16 attention path has a
tensor-core kernel for every head dim, the
plain version of the bf16 kernel's one numeric departure (P rounded to
bf16 before P V) stays inside the reference's stated tolerance, and the
row error that holds the kernel to it catches a dropped kv block, the
SSD scan and its backward form C B^T once per CTA and walk the chunks in
one kernel each, and the backward's chunk kernel fits two CTAs an SM,
and the paged gather stays one launch.  CPU only: nothing here compiles
or launches a kernel."""
import pathlib
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref, stt_gemm  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"


def _functions(*names):
    """name -> (header, body) of every function defined at namespace
    scope in the given csrc files, comments and preprocessor lines
    stripped (a later file's definition of a name wins)."""
    out = {}
    for fname in names:
        src = re.sub(r"//[^\n]*", "", (CSRC / fname).read_text())
        src = re.sub(r"^\s*#[^\n]*", "", src, flags=re.M)
        i, start = 0, 0
        while i < len(src):
            ch = src[i]
            if ch in ";}":
                start = i + 1
            elif ch == "{":
                header = src[start:i]
                if re.fullmatch(r"\s*namespace\s*", header):
                    start = i + 1
                    i += 1
                    continue
                depth, j = 1, i + 1
                while depth:
                    depth += {"{": 1, "}": -1}.get(src[j], 0)
                    j += 1
                plain = re.sub(r"__launch_bounds__\((?:[^()]|\([^()]*\))*\)",
                               "", header)
                m = re.search(r"(\w+)\s*\(", plain)
                if m:
                    out[m.group(1)] = (header, src[i + 1:j - 1])
                i, start = j, j
                continue
            i += 1
    return out


def _reachable(text, funcs):
    """Names of the functions in ``funcs`` that ``text`` reaches through
    calls (or mentions, as a kernel in a launch), transitively."""
    seen, todo = set(), [text]
    while todo:
        body = todo.pop()
        for name in funcs:
            if name not in seen and re.search(rf"\b{name}\b", body):
                seen.add(name)
                todo.append(funcs[name][1])
    return seen


def _block_after(body, opener):
    """The brace block that follows ``opener`` in ``body``."""
    i = body.index(opener) + len(opener)
    i = body.index("{", i)
    depth, j = 1, i + 1
    while depth:
        depth += {"{": 1, "}": -1}.get(body[j], 0)
        j += 1
    return body[i:j]


GEMM_SOURCES = ("common.cuh", "simt_tile.cuh", "stt_gemm.cu")


@pytest.mark.parametrize("source",
                         sorted(p.name for p in CSRC.glob("*.cu")))
def test_every_kernel_is_named_in_chip_smoke(source):
    # chip_smoke.py and the A/B script find the port's kernels in a trace
    # by name: a kernel missing from OUR_KERNELS is timed as "other"
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    kernels = {name for name, (header, _) in _functions(source).items()
               if "__global__" in header}
    assert kernels
    assert kernels <= {k.rstrip("<") for k in chip_smoke.OUR_KERNELS}


def test_output_stationary_scratch_path_never_reaches_tile_product():
    funcs = _functions(*GEMM_SOURCES)
    os_body = funcs["os_dispatch"][1]
    inplace = _block_after(os_body, "if (inplace)")
    scratch = os_body.replace(inplace, "")
    first_version = {"tile_product", "load_tile", "fma_slab"}
    for text, kernels in ((scratch, {"stt_tile_kernel", "os_stream_kernel"}),
                          (funcs["rt_dispatch"][1],
                           {"stt_tile_kernel", "rt_tree_kernel"})):
        reach = _reachable(text, funcs)
        assert kernels <= reach
        assert not reach & first_version
        assert "fma_quads" in reach
    # only accum="inplace" stays on the first version's tile
    assert "tile_product" in _reachable(inplace, funcs)
    users = {name for name, (_, body) in funcs.items()
             if re.search(r"\btile_product\b", body)}
    assert users == {"inplace_body"}


def test_fused_stages_run_the_simt_tile_mainloop():
    # dot stages stage slabs and add float4 fragments as stt_tile_kernel
    # does, never through the first version's element-by-element tile
    funcs = _functions("common.cuh", "simt_tile.cuh", "fused_chain.cu")
    reach = _reachable(funcs["stages_kernel"][1], funcs)
    assert {"dot_item", "fma_quads", "reduce_phase", "row_phase",
            "batched_stage"} <= reach
    assert not reach & {"tile_product", "load_tile", "fma_slab"}
    # split partials are summed in split order, one thread an output,
    # never with atomics
    text = (CSRC / "fused_chain.cu").read_text()
    assert "atomic" not in re.sub(r"//[^\n]*", "", text)
    assert "for (int s = 1; s < d.split; ++s) acc += p[s * pl + e];" \
        in funcs["reduce_phase"][1]


def test_bsr_sums_as_the_output_stationary_tile_does():
    # BSR at density 1.0 is bit-identical to output stationary: both keep
    # one fp32 accumulator a output, from 0, one fmaf a product, ascending k
    # -- the same SIMT tile mainloop, without split-k or atomics
    funcs = _functions("common.cuh", "simt_tile.cuh", "stt_gemm.cu",
                       "bsr_gemm.cu")
    assert "bsr_kernel" not in funcs
    bsr = funcs["bsr_tile_kernel"][1]
    assert "acc[i][j] = 0.0f" in bsr
    assert re.search(r"Slab<T, BM, true> \w+;", bsr)
    assert re.search(r"Slab<T, BN, true> \w+;", bsr)
    assert "fma_quads<BM, BN, TM, TN, LDB, true>(" in bsr
    assert "for (int s = 0; s < nsl; ++s)" in bsr
    reach = _reachable(bsr, funcs)
    assert "fma_quads" in reach
    assert not reach & {"fma_slab", "load_tile", "tile_product"}
    text = re.sub(r"//[^\n]*", "", (CSRC / "bsr_gemm.cu").read_text())
    assert "atomic" not in text
    quads = funcs["fma_quads"][1]
    assert "for (int kq = 0; kq < SLAB_K; ++kq)" in quads
    assert "acc[i][j] = fmaf(a[i], bv[j], acc[i][j])" in quads
    tile = funcs["stt_tile_kernel"][1]
    assert "acc[i][j] = 0.0f" in tile
    assert "for (int s = 0; s < nsl; ++s)" in tile
    # the streaming path: ascending k, one fmaf a product, from 0
    stream = funcs["stream_fma"][1]
    assert "for (int u = 0; u < STREAM_UK; ++u)" in stream
    assert "acc[r][j] = fmaf(a[r], bv, acc[r][j])" in stream


@pytest.mark.parametrize("name", ["SLAB_K", "TILE_THREADS", "SKINNY_M",
                                  "STREAM_COLS", "STREAM_UK", "STREAM_AK",
                                  "STREAM_WARPS", "TREE_WARPS", "WS_KC"])
def test_tile_constant_defined_once(name):
    text = "".join(p.read_text() for p in sorted(CSRC.glob("*.cu*")))
    assert len(re.findall(rf"\bconstexpr int {name} = \d+;", text)) == 1


def test_both_templates_share_one_skinny_threshold_and_staging():
    funcs = _functions(*GEMM_SOURCES)
    for d in ("os_dispatch", "rt_dispatch"):
        assert "m <= SKINNY_M" in funcs[d][1]
    text = "".join(p.read_text() for p in sorted(CSRC.glob("*.cu*")))
    assert len(re.findall(r"\bint stage_mode\(", text)) == 1
    assert not re.search(r"\b(WS_BK|WS_THREADS|ASlab)\b", text)


def test_ws_chunk_depth_is_the_kernels_kc():
    src = (CSRC / "stt_gemm.cu").read_text()
    (kc,) = re.findall(r"constexpr int WS_KC = (\d+);", src)
    assert int(kc) == stt_gemm.WS_CHUNK_K
    # every operand-stationary configuration takes its depth from WS_KC
    assert re.findall(r"\bKC = (\w+)", src) == ["WS_KC"]
    assert "WS_KC * C::BN" in src


def test_chip_smoke_reads_the_ws_chunk_depth():
    src = (ROOT / "chip_smoke.py").read_text()
    assert not re.search(r"^WS_CHUNK_K\s*=", src, re.M)
    assert "stt_gemm.WS_CHUNK_K" in src


def test_flash_bf16_runs_on_tensor_cores_for_every_head_dim():
    src = (CSRC / "flash_attention.cu").read_text()
    cases = tuple(int(d) for d in re.findall(r"FLASH_CASE\((\d+)\)", src))
    assert cases == fa.HEAD_DIMS
    assert all(d % 16 == 0 for d in fa.HEAD_DIMS)   # the mma's k depth
    # bf16 (dtype 1) dispatches to the mma kernel, fp32 to the SIMT one
    assert "dispatch_d<__nv_bfloat16>" in src
    assert re.search(r"if constexpr \(tc\)\s+kernel = flash_mma_kernel<D>;"
                     r"\s+else\s+kernel = flash_kernel<D>;", src)
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src


def test_flash_backward_covers_every_head_dim_without_atomics():
    # dK/dV CTAs own their kv block and loop over the GQA group, so the
    # backward sums in a fixed order; both forwards write the log-sum-exp
    src = (CSRC / "flash_attention.cu").read_text()
    cases = tuple(int(d) for d in re.findall(r"FLASH_BWD_CASE\((\d+)\)",
                                             src))
    assert cases == fa.HEAD_DIMS
    funcs = _functions("flash_attention.cu")
    for name in ("flash_bwd_prep_kernel", "flash_bwd_dkdv_kernel",
                 "flash_bwd_dq_kernel", "flash_bwd_dkdv_mma_kernel",
                 "flash_bwd_dq_mma_kernel"):
        header, body = funcs[name]
        assert "__global__" in header and "atomic" not in body
    assert "for (int hg = 0; hg < group; ++hg)" in funcs[
        "flash_bwd_dkdv_kernel"][1]
    assert "hk * group + it / nq" in funcs["flash_bwd_dkdv_mma_kernel"][1]
    # bf16 runs the tensor-core pair, fp32 the SIMT pair
    assert re.search(r"if constexpr \(tc\) \{\s+kv_kernel = "
                     r"flash_bwd_dkdv_mma_kernel<D>;\s+q_kernel = "
                     r"flash_bwd_dq_mma_kernel<D>;", src)
    for name in ("flash_bwd_dkdv_mma_kernel", "flash_bwd_dq_mma_kernel"):
        assert "mma_bf16(" in funcs[name][1]
    for name in ("flash_kernel", "flash_mma_kernel"):
        assert "row_lse(" in funcs[name][1]


@pytest.mark.parametrize("layout", ["contiguous", "heads_of_bldh"])
def test_bf16_alignment_check_accepts_the_models_views(layout):
    x = torch.zeros((2, 70, 12, 80), dtype=torch.bfloat16)
    if layout == "contiguous":
        views = dict(q=x[:, :, :8].transpose(1, 2).contiguous())
    else:   # (B, L, H, D) storage viewed as (B, H, L, D), as the models do
        views = dict(q=x[:, :, 0:8].transpose(1, 2),
                     k=x[:, :, 8:10].transpose(1, 2),
                     v=x[:, :, 10:12].transpose(1, 2))
    fa._check_aligned(**views)


@pytest.mark.parametrize("how", ["pointer", "row_stride", "head_stride"])
def test_bf16_alignment_check_names_the_operand(how):
    if how == "pointer":
        flat = torch.zeros(2 * 64 * 64 + 1, dtype=torch.bfloat16)
        view = flat[1:].view(1, 2, 64, 64)
    elif how == "row_stride":
        view = torch.zeros((1, 2, 64, 68), dtype=torch.bfloat16)[..., :64]
    else:
        view = torch.zeros((1, 2, 64 * 64 + 4), dtype=torch.bfloat16
                           )[:, :, :64 * 64].view(1, 2, 64, 64)
    with pytest.raises(ValueError, match="k 16-byte aligned"):
        fa._check_aligned(q=torch.zeros((1, 2, 64, 64),
                                        dtype=torch.bfloat16), k=view)
    if how != "pointer":    # a length-1 axis's stride is never read
        fa._check_aligned(k=view[:, :1, :1])


def _bf16(rng, *shapes):
    return [torch.as_tensor(rng.standard_normal(s).astype(np.float32)
                            ).bfloat16() for s in shapes]


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None)])
@pytest.mark.parametrize("hq,hkv,d", [(4, 1, 80), (2, 2, 64)])
def test_bf16_probability_rounding_within_tolerance(hq, hkv, d, causal,
                                                    window):
    # the plain version with P rounded to bf16 (the bf16 kernel's
    # arithmetic) stays inside the reference's bf16 tolerance, and rounds
    rng = np.random.default_rng(d + hq)
    q, k, v = _bf16(rng, (1, hq, 150, d), (1, hkv, 150, d),
                    (1, hkv, 150, d))
    got = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                   round_p=True).float()
    want = ref.attention_ref(q, k, v, causal=causal, window=window).float()
    plain = fa.flash_attention_plain(q, k, v, causal=causal,
                                     window=window).float()
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 2e-2 * scale
    assert (plain - want).abs().max().item() <= 2e-2 * scale
    assert 0.0 < fa.row_error(got, plain) <= fa.BF16_ROW_TOL


def test_row_error_holds_masked_rows_and_catches_a_dropped_block():
    rng = np.random.default_rng(0)
    q, k, v = _bf16(rng, (1, 4, 300, 64), (1, 2, 300, 64), (1, 2, 300, 64))
    want = fa.flash_attention_plain(q, k, v, causal=True, round_p=True)
    # the same attention with kv block 2 hidden from the last 64 rows
    kf, vf = (x.float().repeat_interleave(2, dim=1) for x in (k, v))
    mask = ref.attention_mask(300, 300, causal=True, window=None)
    mask[236:, 128:192] = False
    scores = (q.float() @ kf.transpose(-1, -2)) / 8.0
    fault = torch.softmax(scores.masked_fill(~mask, float("-inf")),
                          dim=-1) @ vf
    assert fa.row_error(fault, want) > 10 * fa.BF16_ROW_TOL
    assert fa.row_error(want, want) == 0.0
    # a row of want that is all 0 (fully masked) holds got to 0 itself
    zero = torch.zeros((1, 2, 3, 8))
    off = zero.clone()
    off[0, 1, 2, 5] = 1e-3
    assert fa.row_error(zero, zero) == 0.0
    assert fa.row_error(off, zero) == pytest.approx(1e-3)


def test_ssd_forms_cb_once_per_block_of_heads():
    # the chunk-output kernel sums C B^T before its loop over the block's
    # heads and never inside it; no kernel of the old chunk loop is left
    funcs = _functions("ssd_scan.cu")
    body = funcs["ssd_chunk_scan_kernel"][1]
    head_loop = _block_after(body, "for (int it = 0; it < items; ++it)")
    cb_sum = "cb[r][u] = fmaf(cv[r], bv[u], cb[r][u])"
    assert body.count(cb_sum) == 1 and cb_sum not in head_loop
    assert body.index(cb_sum) < body.index(head_loop)
    assert "ssd_kernel" not in funcs
    kernels = {n for n, (h, _) in funcs.items() if "__global__" in h}
    assert kernels == {"ssd_chunk_state_kernel", "ssd_state_pass_kernel",
                       "ssd_chunk_scan_kernel"} | set(SSD_BACKWARD)


def test_ssd_backward_forms_cb_once_per_block_of_heads():
    # the backward's chunk kernel sums C B^T once, before the first of its
    # walks over the block's heads, and inside none of them
    body = _functions("ssd_scan.cu")["ssd_bwd_chunk_kernel"][1]
    walk = "for (int it = 0; it < items; ++it)"
    assert body.count(walk) == 3                  # passes A, B and C
    cb_sum = "cb[r][u] = fmaf(cv[r], bv[u], cb[r][u])"
    assert body.count(cb_sum) == 1
    assert body.index(cb_sum) < body.index(walk)
    i = 0
    for _ in range(3):
        i = body.index(walk, i)
        assert cb_sum not in _block_after(body[i:], walk)
        i += len(walk)


def test_ssd_only_the_state_pass_walks_the_chunks():
    # every other kernel works on the chunk of its blockIdx.x; the
    # backward walks them once, in reverse; both backward chunk kernels
    # take a (group, block of heads) from blockIdx.y and walk the block's
    # heads
    funcs = _functions("ssd_scan.cu")
    walkers = {n for n, (_, body) in funcs.items()
               if re.search(r"for \(int \w+ = 0; \w+ < s\.nc", body)}
    assert walkers == {"ssd_state_pass_kernel", "ssd_bwd_state_pass_kernel"}
    assert "s.nc - 1 - k0 - k" in funcs["ssd_bwd_state_pass_kernel"][1]
    for name in ("ssd_chunk_state_kernel", "ssd_chunk_scan_kernel",
                 "ssd_bwd_dstate_kernel", "ssd_bwd_chunk_kernel"):
        assert "ci = blockIdx.x" in funcs[name][1]
    assert "blockIdx.y / nblk" in funcs["head_block"][1]
    for name in ("ssd_bwd_dstate_kernel", "ssd_bwd_chunk_kernel"):
        body = funcs[name][1]
        assert "head_block(s)" in body and "it < items" in body
        assert "blockIdx.y" not in body


#: the SSD backward's kernels, in launch order
SSD_BACKWARD = ("ssd_bwd_dstate_kernel", "ssd_bwd_state_pass_kernel",
                "ssd_bwd_chunk_kernel", "ssd_bwd_sum_kernel")


def test_ssd_backward_sums_without_atomics_in_launch_order():
    # determinism: no kernel of the file uses an atomic, the sums over a
    # group's blocks of heads and over chunks are fixed-order loops, and
    # the entry point launches the chunk kernels (launch_backward) and
    # then the sum kernel (always: it writes da)
    funcs = _functions("ssd_scan.cu")
    for name, (header, body) in funcs.items():
        assert "atomic" not in body, name

    def launched(body):
        return [m.group(1)
                for m in re.finditer(r"(\w+)(?:<\w+>)?\s*<<<", body)]
    entry = funcs["ssd_scan_backward_launch"][1]
    assert launched(entry) == ["ssd_bwd_sum_kernel"]
    assert entry.index("launch_backward") < entry.index("<<<")
    order = launched(funcs["launch_backward"][1]) + launched(entry)
    assert order == list(SSD_BACKWARD)
    sums = funcs["ssd_bwd_sum_kernel"][1]
    assert "for (int k = 0; k < nblk; ++k)" in sums
    assert "k < (long long)batch * s.nc" in sums


def test_ssd_backward_shared_memory_fits_one_block():
    # bwd_smem / dstate_smem in floats, as the source defines them, for
    # the two state widths: equal to the launch plan's bytes, within the
    # H100's 227 KB a block, and two chunk-kernel CTAs (16 warps) an SM
    # (228 KB, 1 KB reserved a block), as the kernel's launch bounds ask
    from repro_torch.kernels import ssd_scan
    src = (CSRC / "ssd_scan.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", src)}
    qmax, threads = consts["QMAX"], consts["THREADS"]
    hbmax, vec = consts["HBMAX"], consts["VEC"]
    assert "constexpr int TS = QMAX + 4;" in src
    assert "return 64 * nr + 4;" in src
    ts = qmax + 4
    assert (qmax, ts, vec, threads // 32, hbmax) == (
        ssd_scan._QMAX, ssd_scan._TS, ssd_scan._VEC, ssd_scan._WARPS,
        ssd_scan.HEAD_BLOCK)
    for n, nr in ((64, 1), (128, 2)):
        ns = 64 * nr + 4
        wide = max(64 * nr * ts, qmax * ns)
        bwd = 2 * wide + 2 * qmax * ts + hbmax * (vec * qmax + threads // 32)
        dstate = qmax * ns + qmax * ts + hbmax * qmax
        assert ssd_scan._bwd_smem(n) == (4 * dstate, 4 * bwd)
        assert 4 * bwd <= 232_448 and 4 * dstate <= 232_448
        assert 2 * (4 * bwd + 1024) <= 233_472
    header = _functions("ssd_scan.cu")["ssd_bwd_chunk_kernel"][0]
    assert "__launch_bounds__(THREADS, 2)" in header


def test_paged_gather_is_one_launch():
    funcs = _functions("paged.cu")
    launches = [n for n, (_, body) in funcs.items() if "<<<" in body]
    assert launches == ["launch"]
    assert funcs["launch"][1].count("<<<") == 1
