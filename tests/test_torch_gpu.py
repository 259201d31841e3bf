"""The port's CUDA kernels against their plain versions, on the card.

Every case is marked ``gpu`` and skips without a CUDA card.  The file
imports neither JAX nor the reference package, so on a machine with the
card and without JAX it runs on its own:

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu \
        tests/test_torch_gpu.py

Tolerances: integer-valued fp32 operands without an epilogue compare
exactly (every sum stays below 2^24); fp32 epilogues to rtol 1e-5 and
1e-5 of the largest output (the card's ``expf``/``tanhf`` against
PyTorch's); bf16 to 2e-2 of the largest output, compared in fp32, but
the BSR kernel's bf16 outputs on integer operands exactly (it and its
plain version round the same exact fp32 sums once).  The
flash-attention kernel is held to its plain version within 1e-4 x
max|out| in fp32 (other sum order, the card's ``expf``); in bf16 within
2e-2 x max|out| of it, and within ``BF16_ROW_TOL`` of each row's norm of
the plain version that rounds P to bf16 as the kernel does; the paged
gather, a copy, exactly; the SSD scan's y and final state within 1e-4 x
max|.| of its plain version in fp32 (other sum order and scan
association, the card's ``expf``), and its backward's gradients the
same.  A model's prefill and decode step on
the card are held to the same calls on the CPU within 1e-4 x
max|logit| (reduced configs, fp32).  The generator's mesh runs on a
one-rank NCCL mesh and on two gloo ranks sharing the card (NCCL allows
one rank a device), each output equal to the reference loop nest and to
the rank's single-card accelerator exactly (integer operands).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.kernels import stt_gemm  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _isolated_tune_cache(tmp_path, monkeypatch):
    """A fresh, empty tuning cache for every case: ``lower()`` reads the
    cache before the analytical choice, and on the card this file runs
    without the conftest fixture that does the same for the CPU suite."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "repro-tune"))
    from repro_torch.tune import cache
    cache.cache_clear(counters_only=True)
    yield
    cache.cache_clear(counters_only=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


#: name -> (lhs shape, rhs shape, plan blocks (bm, bn, bk)); CTA tiles
#: do not divide these shapes, so every kernel masks a ragged edge
SHAPES = {
    "square": ((3, 160, 192), (192, 96), (32, 96, 64)),
    "skinny_m": ((8, 1, 256), (8, 256, 136), (1, 8, 32)),
    "narrow_n": ((2, 200, 128), (2, 128, 1), (8, 1, 16)),
    "rank2": ((136, 264), (264, 72), (8, 72, 24)),
}


def _operands(shape, dtype, seed, integer=True):
    rng = np.random.default_rng(seed)
    out = []
    for s in SHAPES[shape][:2]:
        if integer and dtype == torch.float32:
            x = rng.integers(-4, 5, size=s).astype(np.float32)
        else:
            x = rng.standard_normal(s).astype(np.float32)
        out.append(torch.as_tensor(x).to(dtype))
    return out


def _compare(got, want, dtype, exact):
    got, want = got.cpu().float(), want.float()
    assert got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    if dtype == torch.float32 and exact:
        assert torch.equal(got, want), (got - want).abs().max()
    elif dtype == torch.float32:
        atol = 1e-5 * max(1.0, want.abs().max().item())
        torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)
    else:
        assert (got - want).abs().max().item() <= \
            2e-2 * max(1.0, want.abs().max().item())


def _run(fn, a, b, cuda, **kw):
    bias = kw.pop("bias", None)
    stt_gemm.reset_launches()
    got = fn(a.to(cuda), b.to(cuda), bias=None if bias is None
             else bias.to(cuda), **kw)
    torch.cuda.synchronize()
    assert sum(stt_gemm.launches.values()) == 1
    want = fn(a, b, bias=bias, **kw)
    assert sum(stt_gemm.launches.values()) == 1   # the CPU never launches
    return got, want


DTYPES = [torch.float32, torch.bfloat16]
OS_KNOBS = [("scratch", "mnk"), ("scratch", "nmk"), ("inplace", "kmn"),
            ("inplace", "knm")]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("accum,order", OS_KNOBS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_output_stationary_kernel(cuda, shape, accum, order, dtype):
    a, b = _operands(shape, dtype, seed=1)
    bm, bn, bk = SHAPES[shape][2]
    got, want = _run(stt_gemm.matmul_output_stationary, a, b, cuda, bm=bm,
                     bn=bn, bk=bk, accum=accum, grid_order=order)
    _compare(got, want, dtype, exact=True)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("stationary", ["A", "B"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_operand_stationary_kernel(cuda, shape, stationary, dtype):
    a, b = _operands(shape, dtype, seed=2)
    bm, bn, bk = SHAPES[shape][2]
    got, want = _run(stt_gemm.matmul_operand_stationary, a, b, cuda, bm=bm,
                     bn=bn, bk=bk, stationary=stationary)
    _compare(got, want, dtype, exact=True)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("order", ["mn", "nm"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_reduction_tree_kernel(cuda, shape, order, dtype):
    a, b = _operands(shape, dtype, seed=3)
    bm, bn, _ = SHAPES[shape][2]
    got, want = _run(stt_gemm.matmul_reduction_tree, a, b, cuda, bm=bm,
                     bn=bn, grid_order=order)
    _compare(got, want, dtype, exact=True)


EPILOGUES = [("bias", "gelu"), ("scale:0.05", "softmax"), ("relu",),
             ("silu", "tanh"), ("scale:0.01", "exp"),
             ("bias", "softmax", "scale:2.0")]
TEMPLATES = {"os": stt_gemm.matmul_output_stationary,
             "ws": stt_gemm.matmul_operand_stationary,
             "rt": stt_gemm.matmul_reduction_tree}


@pytest.mark.parametrize("spec", EPILOGUES, ids="+".join)
@pytest.mark.parametrize("template", list(TEMPLATES))
@pytest.mark.parametrize("shape", ["square", "skinny_m", "rank2"])
def test_epilogue_flush(cuda, shape, template, spec):
    a, b = _operands(shape, torch.float32, seed=4)
    bm, bn, bk = SHAPES[shape][2]
    n = b.shape[-1]
    kw = dict(bm=bm, bn=n, epilogue=spec)   # softmax needs bn == n
    if template != "rt":
        kw["bk"] = bk
    if "bias" in spec:
        kw["bias"] = torch.linspace(-3, 3, n)
    got, want = _run(TEMPLATES[template], a, b, cuda, **kw)
    _compare(got, want, torch.float32, exact=False)


def test_inplace_rounding_step_on_card(cuda):
    a, b = _operands("square", torch.bfloat16, seed=5, integer=False)
    outs = {}
    for bk in (16, 192):
        got, want = _run(stt_gemm.matmul_output_stationary, a, b, cuda,
                         bm=32, bn=96, bk=bk, accum="inplace")
        _compare(got, want, torch.bfloat16, exact=False)
        outs[bk] = got
    assert not torch.equal(outs[16], outs[192])


def test_transposed_view_operand(cuda):
    # gemm feeds B.T: a strided view, read through its strides
    a, bt = _operands("rank2", torch.float32, seed=6)
    b = bt.t().contiguous()                      # (n, k) storage
    view = b.to(cuda).t()
    assert not view.is_contiguous()
    stt_gemm.reset_launches()
    got = stt_gemm.matmul_output_stationary(a.to(cuda), view, bm=8, bn=72,
                                            bk=24)
    want = stt_gemm.matmul_output_stationary(a, bt, bm=8, bn=72, bk=24)
    _compare(got, want, torch.float32, exact=True)


def _ws_view(x, layout):
    """``x`` (.., rows, cols) as the view the staging mode under test
    reads: "row" contiguous, "t" stored transposed (unit stride on rows),
    "step" every other column of wider storage (no unit stride),
    "offset" one element past an aligned start (misaligned)."""
    if layout == "row":
        return x.contiguous()
    if layout == "t":
        return x.transpose(-1, -2).contiguous().transpose(-1, -2)
    if layout == "step":
        wide = torch.zeros(*x.shape[:-1], 2 * x.shape[-1], dtype=x.dtype,
                           device=x.device)
        wide[..., ::2] = x
        return wide[..., ::2]
    flat = torch.zeros(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    return view


#: (A shape, B shape, A layout, B layout): both operand-stationary tiles
#: (128 wide where they fill one wave of the card, else 64), k not a
#: multiple of the chunk, ragged m and n, n % 4 != 0 (scalar strip), the
#: staging modes (k-contiguous, m/n-contiguous, strided, misaligned) and
#: batch broadcast
WS_CASES = {
    "wide_k_contig": ((1536, 520), (520, 1536), "row", "t"),
    "wide_n_contig": ((1536, 300), (300, 1600), "row", "row"),
    "conv_like_mn": ((196, 700), (700, 256), "t", "t"),
    "strided": ((200, 260), (260, 136), "step", "step"),
    "misaligned": ((130, 520), (520, 72), "offset", "offset"),
    "ragged_n": ((150, 270), (270, 130), "row", "t"),
    "broadcast_b": ((3, 160, 264), (264, 96), "row", "t"),
    "narrow_n": ((200, 300), (300, 5), "row", "t"),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", list(WS_CASES))
def test_operand_stationary_tile_kernel_exact(cuda, case, dtype):
    sa, sb, la, lb = WS_CASES[case]
    rng = np.random.default_rng(len(case))
    a, b = (torch.as_tensor(rng.integers(-4, 5, size=s).astype(np.float32)
                            ).to(dtype) for s in (sa, sb))
    m, n, k = sa[-2], sb[-1], sa[-1]
    kw = dict(bm=m, bn=n, bk=k)
    ga, gb = _ws_view(a.to(cuda), la), _ws_view(b.to(cuda), lb)
    stt_gemm.reset_launches()
    got = stt_gemm.matmul_operand_stationary(ga, gb, **kw)
    torch.cuda.synchronize()
    assert stt_gemm.launches["operand_stationary"] == 1
    want = stt_gemm.matmul_operand_stationary(a, b, **kw)
    assert torch.equal(got.cpu().float(), want.float())
    # two calls give the same bits
    assert torch.equal(stt_gemm.matmul_operand_stationary(ga, gb, **kw), got)


@pytest.mark.parametrize("m", [300, 132 * 128])
def test_operand_stationary_row_mode_softmax(cuda, m):
    # a softmax epilogue makes each CTA cover whole rows (row mode); at
    # 132 x 128 rows the 128-wide tile fills one wave
    rng = np.random.default_rng(m)
    a = torch.as_tensor(rng.integers(-4, 5, size=(m, 300)).astype(
        np.float32))
    b = torch.as_tensor(rng.integers(-4, 5, size=(300, 136)).astype(
        np.float32))
    kw = dict(bm=m, bn=136, bk=300, epilogue=("scale:0.05", "softmax"))
    got = stt_gemm.matmul_operand_stationary(a.to(cuda), b.to(cuda).T.
                                             contiguous().T, **kw)
    _compare(got, stt_gemm.matmul_operand_stationary(a, b, **kw),
             torch.float32, exact=False)


#: (A shape, B shape, A layout, B layout) for the output-stationary and
#: reduction-tree kernels: the tile kernel at 128 wide (at least 132 CTAs)
#: and 64 wide, the streaming kernels (m <= 8 a batch slice: m = 1 and
#: m = 5), ragged m, n and k, k not a multiple of the 32-deep slab and k
#: under it, gemm's B.T view ("t"), views with no unit stride ("step",
#: scalar staging), misaligned views and operands broadcast over the batch
TILE_CASES = {
    "wide_bt": ((1536, 520), (520, 1412), "row", "t"),
    "wide_n_contig": ((1600, 200), (200, 1536), "row", "row"),
    "narrow_ragged": ((150, 270), (270, 130), "row", "t"),
    "k_under_slab": ((100, 19), (19, 72), "row", "row"),
    "k_ragged_mn": ((72, 75), (75, 66), "t", "t"),
    "strided": ((200, 260), (260, 136), "step", "step"),
    "misaligned": ((130, 90), (90, 72), "offset", "offset"),
    "broadcast_b": ((3, 160, 264), (264, 96), "row", "t"),
    "broadcast_a": ((160, 100), (3, 100, 96), "row", "row"),
    "skinny_m1": ((64, 1, 600), (64, 600, 520), "row", "row"),
    "skinny_m5_bt": ((4, 5, 300), (4, 300, 136), "row", "t"),
    "skinny_k_under": ((6, 1, 9), (6, 9, 196), "row", "row"),
    "skinny_strided": ((3, 2, 70), (3, 70, 50), "step", "step"),
    "skinny_misaligned": ((5, 1, 41), (5, 41, 67), "offset", "offset"),
    "skinny_broadcast": ((8, 1, 130), (130, 260), "row", "row"),
}
OS_RT = {"os": stt_gemm.matmul_output_stationary,
         "rt": stt_gemm.matmul_reduction_tree}


def _os_rt_kw(template, a, b, **kw):
    """Plan blocks spanning the whole problem (they divide it)."""
    m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
    kw = dict(bm=m, bn=n, **kw)
    if template == "os":
        kw.setdefault("bk", k)
    return kw


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("template", list(OS_RT))
@pytest.mark.parametrize("case", list(TILE_CASES))
def test_tile_and_streaming_kernels_exact(cuda, case, template, dtype):
    # integer operands: every fp32 sum is exact, so any sum order gives
    # the plain version's bits, in bf16 too (one rounding of an exact sum)
    sa, sb, la, lb = TILE_CASES[case]
    rng = np.random.default_rng(len(case) + 7)
    a, b = (torch.as_tensor(rng.integers(-4, 5, size=s).astype(np.float32)
                            ).to(dtype) for s in (sa, sb))
    kw = _os_rt_kw(template, a, b)
    ga, gb = _ws_view(a.to(cuda), la), _ws_view(b.to(cuda), lb)
    stt_gemm.reset_launches()
    got = OS_RT[template](ga, gb, **kw)
    torch.cuda.synchronize()
    assert sum(stt_gemm.launches.values()) == 1
    want = OS_RT[template](a, b, **kw)
    assert torch.equal(got.cpu().float(), want.float())
    # two calls give the same bits
    assert torch.equal(OS_RT[template](ga, gb, **kw), got)


@pytest.mark.parametrize("template", list(OS_RT))
@pytest.mark.parametrize("case", ["wide_bt", "narrow_ragged", "skinny_m1",
                                  "skinny_m5_bt"])
def test_repeat_calls_bit_identical(cuda, case, template):
    # random-normal operands: the sum order shows in the bits, and it is
    # fixed (ascending k, or the reduction tree's fixed shape)
    sa, sb, la, lb = TILE_CASES[case]
    rng = np.random.default_rng(11)
    a, b = (torch.as_tensor(rng.standard_normal(s).astype(np.float32))
            for s in (sa, sb))
    kw = _os_rt_kw(template, a, b)
    ga, gb = _ws_view(a.to(cuda), la), _ws_view(b.to(cuda), lb)
    first = OS_RT[template](ga, gb, **kw)
    for _ in range(2):
        assert torch.equal(OS_RT[template](ga, gb, **kw), first)
    _compare(first, OS_RT[template](a, b, **kw), torch.float32, exact=False)


@pytest.mark.parametrize("template", list(OS_RT))
@pytest.mark.parametrize("shapes", [((300, 100), (100, 136)),
                                    ((132 * 128, 40), (40, 72)),
                                    ((5, 1, 80), (5, 80, 300)),
                                    ((3, 6, 33), (3, 33, 200))],
                         ids=["narrow_tile", "wide_tile", "stream_m1",
                              "stream_m6"])
def test_softmax_row_mode(cuda, shapes, template):
    # a softmax epilogue makes each CTA cover whole rows: the tile kernel
    # at both widths (132 x 128 rows fill one wave of 128-wide tiles) and
    # the streaming kernels
    rng = np.random.default_rng(len(shapes[0]))
    a, b = (torch.as_tensor(rng.integers(-4, 5, size=s).astype(np.float32))
            for s in shapes)
    kw = _os_rt_kw(template, a, b, epilogue=("scale:0.05", "softmax"))
    got = OS_RT[template](a.to(cuda), b.to(cuda), **kw)
    _compare(got, OS_RT[template](a, b, **kw), torch.float32, exact=False)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("bk", [16, 24, 192])
@pytest.mark.parametrize("shapes", [((3, 160, 192), (192, 96)),
                                    ((4, 1, 192), (4, 192, 136))],
                         ids=["tile", "skinny"])
def test_inplace_step_boundaries(cuda, shapes, bk, dtype):
    # accum="inplace" rounds at every plan k-step of bk, whatever the
    # kernel's own slab depth
    rng = np.random.default_rng(bk)
    integer = dtype == torch.float32
    a, b = (torch.as_tensor((rng.integers(-4, 5, size=s) if integer else
                             rng.standard_normal(s)).astype(np.float32)
                            ).to(dtype) for s in shapes)
    kw = _os_rt_kw("os", a, b, bk=bk, accum="inplace")
    got, want = _run(stt_gemm.matmul_output_stationary, a, b, cuda, **kw)
    _compare(got, want, dtype, exact=True)


def test_launch_checks_raise(cuda):
    a = torch.ones(16, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        stt_gemm.matmul_output_stationary(a, a, bm=16, bn=16, bk=16)
    f = torch.ones(16, 16, device=cuda)
    with pytest.raises(ValueError, match="input dtype"):
        stt_gemm.matmul_reduction_tree(f, f, bm=16, bn=16,
                                       out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="different devices"):
        stt_gemm.matmul_reduction_tree(f, f.cpu(), bm=16, bn=16)


SMALL = {
    "gemm": dict(m=40, n=24, k=72),
    "batched_gemv": dict(m=6, n=40, k=20),
    "conv2d": dict(k=12, c=5, y=9, x=7, p=3, q=2),
    "depthwise_conv": dict(k=10, y=7, x=9, p=2, q=3),
    "mttkrp": dict(i=28, j=20, k=6, l=10),
    "ttmc": dict(i=12, j=10, k=6, l=8, m=5),
}


@pytest.mark.parametrize("kind", ["identity", "output_stationary",
                                  "weight_stationary", "input_stationary"])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_generate_on_card_matches_cpu(cuda, name, kind):
    acc = repro_torch.generate(name, kind, bounds=SMALL[name])
    assert acc.device.type == "cuda"
    ops = acc.algebra.random_operands(seed=7)
    cpu = repro_torch.generate(name, kind, bounds=SMALL[name], device="cpu",
                               validate=False)
    got = acc(ops)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), cpu(ops))
    assert acc.validate() == 0.0


# ---------------------------------------------------------------------------
# the block-sparse kernel (csrc/bsr_gemm.cu)
# ---------------------------------------------------------------------------

from repro_torch.core.algebra import Sparsity  # noqa: E402
from repro_torch.kernels import bsr_gemm, fused_chain, ops  # noqa: E402

#: (m, k, n, (bm, bk), density): the plan's 64 tile does not divide
#: these, block-rows of 4 run it with rows masked, 0.3 leaves rows empty
BSR_CASES = [(64, 48, 40, (16, 8), 0.5), (256, 256, 200, (128, 128), 1.0),
             (32, 64, 24, (4, 16), 0.3), (384, 256, 130, (128, 64), 0.25),
             (96, 90, 70, (32, 18), 0.6)]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", range(len(BSR_CASES)))
def test_bsr_kernel(cuda, case, dtype):
    m, k, n, (bm, bk), density = BSR_CASES[case]
    sp = Sparsity.random((m, k), (bm, bk), density, seed=case)
    rng = np.random.default_rng(case)
    a = torch.as_tensor(rng.integers(-4, 5, size=(m, k)).astype(
        np.float32)).to(dtype)
    b = torch.as_tensor(rng.integers(-4, 5, size=(k, n)).astype(
        np.float32)).to(dtype)
    bsr_gemm.reset_launches()
    got = bsr_gemm.bsr_matmul(a.to(cuda), b.to(cuda), coords=sp.coords,
                              bm=bm, bk=bk, bn=128)
    torch.cuda.synchronize()
    assert bsr_gemm.launches["bsr"] == 1
    want = bsr_gemm.bsr_matmul(a, b, coords=sp.coords, bm=bm, bk=bk, bn=128)
    assert bsr_gemm.launches["bsr"] == 1
    _compare(got, want, dtype, exact=True)


def test_bsr_rhs_side_and_non_finite_outside_pattern(cuda):
    sp = Sparsity.random((96, 64), (32, 16), 0.5, seed=3)
    rng = np.random.default_rng(3)
    sparse = torch.as_tensor(rng.integers(-4, 5, size=(96, 64)).astype(
        np.float32))
    sparse[~torch.as_tensor(sp.element_mask((96, 64)))] = float("nan")
    dense = torch.as_tensor(rng.integers(-4, 5, size=(40, 96)).astype(
        np.float32))
    got = ops.bsr_matmul(sparse.to(cuda), dense.to(cuda), coords=sp.coords,
                         block=(32, 16), side="rhs")
    want = ops.bsr_matmul(sparse, dense, coords=sp.coords, block=(32, 16),
                          side="rhs")
    _compare(got, want, torch.float32, exact=True)


def test_bsr_density_one_bit_identical_to_output_stationary(cuda):
    rng = np.random.default_rng(4)
    a = torch.as_tensor(rng.standard_normal((256, 384)).astype(np.float32),
                        device=cuda)
    b = torch.as_tensor(rng.standard_normal((384, 200)).astype(np.float32),
                        device=cuda)
    sp = Sparsity.random((256, 384), (128, 128), 1.0)
    got = bsr_gemm.bsr_matmul(a, b, coords=sp.coords, bm=128, bk=128,
                              bn=128)
    want = stt_gemm.matmul_output_stationary(a, b, bm=128, bn=200, bk=128)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["gemm_A", "gemm_B", "conv2d_B",
                                  "mttkrp_A"])
def test_sparse_generate_on_card_matches_cpu(cuda, kind):
    name, bounds, tensor, shape, block = {
        "gemm_A": ("gemm", dict(m=64, n=40, k=48), "A", (64, 48), (16, 8)),
        "gemm_B": ("gemm", dict(m=40, n=64, k=48), "B", (64, 48), (16, 8)),
        "conv2d_B": ("conv2d", dict(k=16, c=8, y=6, x=5, p=3, q=3), "B",
                     (16, 8, 3, 3), (8, 2, 3, 3)),
        "mttkrp_A": ("mttkrp", dict(i=32, j=20, k=6, l=5), "A",
                     (32, 6, 5), (8, 2, 5)),
    }[kind]
    sp = Sparsity.random(shape, block, 0.5, seed=2)
    acc = repro_torch.generate(name, bounds=bounds, sparsity={tensor: sp})
    cpu = repro_torch.generate(name, bounds=bounds, sparsity={tensor: sp},
                               device="cpu", validate=False)
    assert acc.kernel.sparse_mode == "bsr"
    ops_ = acc.algebra.random_sparse_inputs(seed=3)
    bsr_gemm.reset_launches()
    got = acc(ops_)
    assert bsr_gemm.launches["bsr"] == 1
    assert torch.equal(got.cpu(), cpu(ops_))
    assert acc.validate() == 0.0


def _int_tensor(rng, shape, dtype=torch.float32):
    return torch.as_tensor(rng.integers(-4, 5, size=shape).astype(
        np.float32)).to(dtype)


def _bsr_exact(cuda, sparse, dense, coords, bm, bk):
    """The kernel on the card against the plain version on the CPU, bit
    for bit, with one launch; returns the card's output."""
    bsr_gemm.reset_launches()
    got = bsr_gemm.bsr_matmul(sparse.to(cuda), dense.to(cuda), coords=coords,
                              bm=bm, bk=bk, bn=128)
    torch.cuda.synchronize()
    assert bsr_gemm.launches["bsr"] == 1
    want = bsr_gemm.bsr_matmul_plain(sparse, dense, coords=coords, bm=bm,
                                     bk=bk, out_dtype=sparse.dtype)
    assert torch.equal(got.cpu(), want), (got.cpu().float()
                                          - want.float()).abs().max()
    return got


#: (m, k, n, (bm, bk)) giving each tile of the plan: 12 block-rows x 11
#: n tiles fill the card's 132 SMs at 128; 3 x 2 do not (64, 2 sub-tiles)
BSR_TILE_CASES = {128: (1536, 384, 1400, (128, 64)),
                  64: (384, 384, 200, (128, 64))}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("tile", sorted(BSR_TILE_CASES))
def test_bsr_tile_widths_exact(cuda, tile, dtype):
    # integer operands: fp32 sums are exact, and both sides round them to
    # bf16 once
    m, k, n, (bm, bk) = BSR_TILE_CASES[tile]
    sp = Sparsity.random((m, k), (bm, bk), 0.5, seed=tile)
    assert bsr_gemm.launch_plan(sp.coords, bm, bk, m, n).tile == tile
    rng = np.random.default_rng(tile)
    _bsr_exact(cuda, _int_tensor(rng, (m, k), dtype),
               _int_tensor(rng, (k, n), dtype), sp.coords, bm, bk)


@pytest.mark.parametrize("d_layout", ["n-contiguous", "k-contiguous"])
@pytest.mark.parametrize("bk", [144, 18])
def test_bsr_block_depth_off_the_slab(cuda, bk, d_layout):
    # 144 ends a block half-way through a slab; 18 also starts slabs off
    # 16-byte boundaries, so k-contiguous operands stage element by element
    m, k, n, bm = 256, bk * 6, 136, 64
    sp = Sparsity.random((m, k), (bm, bk), 0.5, seed=bk)
    plan = bsr_gemm.launch_plan(sp.coords, bm, bk, m, n)
    assert plan.k_vec == (bk % 4 == 0)
    rng = np.random.default_rng(bk)
    dense = _int_tensor(rng, (k, n))
    if d_layout == "k-contiguous":
        dense = dense.T.contiguous().T
    _bsr_exact(cuda, _int_tensor(rng, (m, k)), dense, sp.coords, bm, bk)


@pytest.mark.parametrize("bm", [4, 6])
def test_bsr_rhs_side_row_staging(cuda, bm):
    # the rhs side hands the kernel sparse.T, unit-stride along its rows:
    # 4-row blocks stage 16 bytes along m, 6-row blocks element by element
    k, n = 64, 48
    sp = Sparsity.random((k, n), (16, bm), 0.5, seed=bm)
    assert bsr_gemm.launch_plan(bsr_gemm.transpose_coords(sp.coords), bm,
                                16, n, 40).m_vec == (bm % 4 == 0)
    rng = np.random.default_rng(bm)
    sparse = _int_tensor(rng, (k, n))
    dense = _int_tensor(rng, (40, k))
    bsr_gemm.reset_launches()
    got = ops.bsr_matmul(sparse.to(cuda), dense.to(cuda), coords=sp.coords,
                         block=(16, bm), side="rhs")
    torch.cuda.synchronize()
    assert bsr_gemm.launches["bsr"] == 1
    want = ops.bsr_matmul(sparse, dense, coords=sp.coords, block=(16, bm),
                          side="rhs")
    assert torch.equal(got.cpu(), want)


def test_bsr_empty_block_rows_and_heaviest_first(cuda):
    # rows 0, 2 and 5 empty; row 3 holds every block and runs first
    m, k, n, bm, bk = 768, 512, 264, 128, 64
    cols = k // bk
    coords = bsr_gemm.sort_coords(
        [(3, c) for c in range(cols)] + [(1, 2), (4, 0), (4, 7)])
    plan = bsr_gemm.launch_plan(coords, bm, bk, m, n)
    assert plan.order[0] // plan.subtiles == 3
    assert {i // plan.subtiles for i in plan.order[-3 * plan.subtiles:]} \
        == {0, 2, 5}
    rng = np.random.default_rng(5)
    sparse = _int_tensor(rng, (m, k))
    got = _bsr_exact(cuda, sparse, _int_tensor(rng, (k, n)), coords, bm, bk)
    for r in (0, 2, 5):
        assert not got[r * bm:(r + 1) * bm].any()


@pytest.mark.parametrize("side", ["lhs", "rhs"])
def test_bsr_non_finite_outside_pattern_at_the_wide_tile(cuda, side):
    # the kernel's view: S (1536, 256) in (128, 64) blocks, n = 1408, the
    # 128 tile; the sparse operand is nan outside its pattern's blocks
    shape, block = ((1536, 256), (128, 64)) if side == "lhs" else \
        ((256, 1536), (64, 128))
    sp = Sparsity.random(shape, block, 0.4, seed=7)
    rng = np.random.default_rng(7)
    sparse = _int_tensor(rng, shape)
    sparse[~torch.as_tensor(sp.element_mask(shape))] = float("nan")
    dense = _int_tensor(rng, (256, 1408) if side == "lhs" else (1408, 256))
    plan_coords = sp.coords if side == "lhs" else \
        bsr_gemm.transpose_coords(sp.coords)
    assert bsr_gemm.launch_plan(plan_coords, 128, 64, 1536, 1408).tile == 128
    got = ops.bsr_matmul(sparse.to(cuda), dense.to(cuda), coords=sp.coords,
                         block=block, side=side)
    want = ops.bsr_matmul(sparse, dense, coords=sp.coords, block=block,
                          side=side)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("shape", ["gemm", "conv2d"])
def test_bsr_density_one_bit_identical_at_main_path_blocks(cuda, shape):
    # random normals: only the same fmaf sequence gives the same bits
    (m, k, n), (bm, bk) = {"gemm": ((4096, 4096, 4096), (128, 128)),
                           "conv2d": ((256, 2304, 196), (64, 144))}[shape]
    gen = torch.Generator(device=cuda).manual_seed(11)
    a = torch.randn((m, k), generator=gen, device=cuda)
    b = torch.randn((k, n), generator=gen, device=cuda)
    sp = Sparsity.random((m, k), (bm, bk), 1.0)
    got = bsr_gemm.bsr_matmul(a, b, coords=sp.coords, bm=bm, bk=bk, bn=128)
    want = stt_gemm.matmul_output_stationary(a, b, bm=128, bn=n, bk=128)
    assert torch.equal(got, want)


def test_bsr_two_calls_same_bits(cuda):
    m, k, n, (bm, bk) = BSR_TILE_CASES[128]
    gen = torch.Generator(device=cuda).manual_seed(12)
    a = torch.randn((m, k), generator=gen, device=cuda)
    b = torch.randn((k, n), generator=gen, device=cuda)
    sp = Sparsity.random((m, k), (bm, bk), 0.5, seed=12)
    csr = bsr_gemm.csr_arrays(sp.coords, m // bm, cuda)
    first = bsr_gemm.bsr_matmul(a, b, coords=sp.coords, bm=bm, bk=bk, bn=128,
                                csr=csr)
    assert torch.equal(bsr_gemm.bsr_matmul(a, b, coords=sp.coords, bm=bm,
                                           bk=bk, bn=128, csr=csr), first)


#: chip_smoke.py's sparse cases: (algebra, its bounds, sparse tensor, its
#: shape, block, density)
BSR_MAIN_PATH = {
    "gemm A d=0.25": ("gemm", dict(m=4096, n=4096, k=4096), "A",
                      (4096, 4096), (128, 128), 0.25),
    "gemm A d=1.0": ("gemm", dict(m=4096, n=4096, k=4096), "A",
                     (4096, 4096), (128, 128), 1.0),
    "gemm B d=0.25": ("gemm", dict(m=4096, n=4096, k=4096), "B",
                      (4096, 4096), (128, 128), 0.25),
    "conv2d B d=0.25": ("conv2d", dict(k=256, c=256, y=14, x=14, p=3, q=3),
                        "B", (256, 256, 3, 3), (64, 16, 3, 3), 0.25),
    "mttkrp A d=0.25": ("mttkrp", dict(i=1024, j=1024, k=64, l=64), "A",
                        (1024, 64, 64), (128, 8, 64), 0.25),
}


@pytest.mark.parametrize("label", sorted(BSR_MAIN_PATH))
def test_bsr_main_path_shapes_against_plain(cuda, label):
    name, bounds, tensor, shape, block, density = BSR_MAIN_PATH[label]
    sp = Sparsity.random(shape, block, density, seed=0)
    acc = repro_torch.generate(name, "output_stationary", bounds=bounds,
                               sparsity={tensor: sp}, validate=False)
    k = acc.kernel
    lhs, rhs = k.form.prepare(k.cast_operands(
        acc.algebra.random_sparse_inputs(seed=1)))
    s = k.sparse
    sparse, dense = (lhs, rhs) if s.side == "lhs" else (rhs.T, lhs.T)
    coords, (bm, bk) = s.coords, s.block
    if s.side == "rhs":
        coords, bm, bk = bsr_gemm.transpose_coords(coords), bk, bm
    bsr_gemm.reset_launches()
    got = bsr_gemm.bsr_matmul(sparse, dense, coords=coords, bm=bm, bk=bk,
                              bn=128)
    want = bsr_gemm.bsr_matmul_plain(sparse, dense, coords=coords, bm=bm,
                                     bk=bk, out_dtype=sparse.dtype)
    assert bsr_gemm.launches["bsr"] == 1
    assert torch.equal(got, want), (got - want).abs().max()


# ---------------------------------------------------------------------------
# the fused megakernels (csrc/fused_chain.cu)
# ---------------------------------------------------------------------------

CHAIN = (fused_chain.ChainStage(96, 160, ("bias", "gelu"), True),
         fused_chain.ChainStage(160, 72, ("scale:0.1", "softmax")),
         fused_chain.ChainStage(72, 130, ("relu",)))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("interleave", ["chain", "stage"])
def test_fused_chain_kernel(cuda, interleave, dtype):
    rng = np.random.default_rng(5)
    lhs = torch.as_tensor(rng.integers(-2, 3, size=(200, 96)).astype(
        np.float32)).to(dtype)
    # (n, k) storage fed as its transposed view, as the graph path does
    rhss = [torch.as_tensor(rng.integers(-2, 3, size=(st.n, st.k)).astype(
        np.float32)).to(dtype).T for st in CHAIN]
    bias = [torch.linspace(-2, 2, 160)]
    fused_chain.reset_launches()
    got = fused_chain.fused_chain_matmul(
        lhs.to(cuda), [r.to(cuda) for r in rhss], [b.to(cuda) for b in bias],
        stages=CHAIN, bm=64, interleave=interleave)
    torch.cuda.synchronize()
    assert fused_chain.launches["fused_chain"] == 1
    want = fused_chain.fused_chain_matmul(lhs, rhss, bias, stages=CHAIN,
                                          bm=64, interleave=interleave)
    _compare(got, want, dtype, exact=False)


def _graph(name):
    from repro_torch.core.algebra import get_algebra
    from repro_torch.graph import AlgebraGraph, GraphNode, from_model
    if name == "layer":
        return from_model.transformer_layer_graph(l=96, d=64, dv=48, f=160)
    g = lambda m, n, k: get_algebra("gemm", m=m, n=n, k=k)  # noqa: E731
    if name == "batched":
        return AlgebraGraph(nodes=(
            GraphNode(name="bv", inputs=("A3", "v"), output="t",
                      algebra=get_algebra("batched_gemv", m=40, k=24,
                                          n=36)),
            GraphNode(name="c1", inputs=("t", "w"), output="y",
                      algebra=g(40, 20, 36))),
            inputs=("A3", "v", "w"), output="y")
    return AlgebraGraph(nodes=(         # rhs landing + residual + tap
        GraphNode(name="p", inputs=("x", "w0"), output="t",
                  algebra=g(40, 40, 24)),
        GraphNode(name="c1", inputs=("t", "w1"), output="y1",
                  algebra=g(40, 40, 40)),
        GraphNode(name="c2", inputs=("y1", "t"), output="y2",
                  algebra=g(40, 40, 40)),
        GraphNode(name="fin", inputs=("y2", "t"), output="out", op="add")),
        inputs=("x", "w0", "w1"), output="out")


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name", ["layer", "batched", "tapped"])
def test_fused_dag_kernel_through_the_graph(cuda, name, dtype):
    from repro_torch.graph import executor
    g = _graph(name)
    acc = executor.build(g, dtype=dtype, validate=False)
    assert acc.group_kernels
    assert all(gk.kind == "dag" for gk in acc.group_kernels.values())
    cpu = executor.build(g, dtype=dtype, validate=False, device="cpu")
    ops_ = {k: v.astype(np.float32) / 4
            for k, v in g.random_operands(1).items()}
    fused_chain.reset_launches()
    got = acc(ops_)
    torch.cuda.synchronize()
    assert fused_chain.launches["fused_dag"] == len(acc.group_kernels)
    _compare(got, cpu(ops_), dtype, exact=False)
    seq = executor.build(g, dtype=dtype, validate=False, merge=False)
    _compare(got, seq(ops_).cpu(), dtype, exact=False)


def test_graph_validate_on_card(cuda):
    # small: validate() runs the pure-python loop-nest oracle
    from repro_torch.graph import executor, from_model
    g = from_model.transformer_layer_graph(l=24, d=16, dv=16, f=32)
    acc = executor.build(g)
    assert acc.group_kernels
    assert acc.validate() <= 1e-3 + 1e-5 * np.abs(
        g.reference(g.random_operands(0))).max()


# The launch plan's paths, each held to the plain version: exactly on
# integer operands (both dtypes: every partial sum is an exact integer
# below 2^24, checked by _sum_bound, so the sum order and the split do
# not show and both versions round at the same casts), within the gates
# of chip_smoke.py on random-normal ones (fp32 1e-4, bf16 2e-2 x
# max|out|: other sum order, the card's expf/tanhf); a second call must
# give the same bits.

def _fused_operand(rng, shape, integer, nz=None, scale=1.0):
    """Integers in [-1, 1] (with ``nz``: ``nz`` nonzeros a row, so that
    sums stay small through a deep DAG), or N(0, scale^2)."""
    if not integer:
        return torch.as_tensor(
            (rng.standard_normal(shape) * scale).astype(np.float32))
    if nz is None:
        return torch.as_tensor(rng.integers(-1, 2, size=shape).astype(
            np.float32))
    x = np.zeros(shape, np.float32)
    for row in x:
        row[rng.choice(shape[-1], nz, replace=False)] = rng.choice(
            [-1.0, 1.0], nz)
    return torch.as_tensor(x)


def _sum_bound(exts, stages):
    """The largest magnitude any partial sum of any stage can reach on
    these operands, in any order: the stages on |operands|, with the
    bias and scale epilogues by magnitude (relu only shrinks)."""
    vals = []

    def get(src, transpose=False):
        buf = exts[src[1]] if src[0] == "ext" else vals[src[1]]
        buf = buf.double().abs()
        return buf.T if transpose else buf
    for st in stages:
        acc = get(st.lhs) @ get(st.rhs, transpose=st.rhs[0] == "scr")
        for op in st.epilogue:
            if op == "bias":
                acc = acc + get(("ext", st.bias)).reshape(1, -1)
            elif op.startswith("scale:"):
                acc = acc * abs(float(op[6:]))
        if st.res is not None:
            acc = acc + get(st.res)
        vals.append(acc)
    return max(v.max().item() for v in vals)


def _fused_compare(got, want, integer):
    for g, w in zip(got, want):
        g, w = g.cpu().float(), w.float()
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        if integer:
            assert torch.equal(g, w), (g - w).abs().max()
        else:
            tol = 1e-4 if want[0].dtype == torch.float32 else 2e-2
            assert (g - w).abs().max().item() <= tol * w.abs().max().item()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("operands", ["integer", "normal"])
@pytest.mark.parametrize("entry", ["chain", "dag"])
def test_fused_wide_tiles_then_a_k_split(cuda, entry, operands, dtype):
    # stage 0's 128-wide tiles fill a wave of the grid and flush from
    # registers (the DAG writes its tap there too); stage 1 (n = 72) has
    # 4 of them over a deep k and splits it: a plain epilogue summed
    # after a grid sync (integer; the DAG adds an fp32 residual there),
    # or a softmax summed in its row phase (normal)
    integer = operands == "integer"
    grid = fused_chain.card_plan(fused_chain.chain_as_dag(CHAIN, 8), dtype,
                                 cuda).grid
    m, k0, n0, n1 = 512, 96, 128 * -(-grid // 4), 72
    rng = np.random.default_rng(11)
    lhs = _fused_operand(rng, (m, k0), integer).to(dtype)
    w0, w1 = (_fused_operand(rng, shape, integer, scale=shape[1] ** -0.5)
              .to(dtype) for shape in ((n0, k0), (n1, n0)))
    b0 = _fused_operand(rng, (1, n0), integer, scale=0.1)
    res = _fused_operand(rng, (m, n1), integer)
    exts = [lhs, w0.T, b0, w1.T, res]
    dag = (fused_chain.DagStage(
               m, k0, n0, lhs=("ext", 0), rhs=("ext", 1), has_bias=True,
               bias=2, epilogue=("bias", "relu"),
               tap=0 if entry == "dag" else -1),
           fused_chain.DagStage(
               m, n0, n1, lhs=("scr", 0), rhs=("ext", 3),
               res=("ext", 4) if entry == "dag" else None,
               epilogue=("scale:2",) if integer
               else ("scale:0.5", "softmax")))
    plan = fused_chain.card_plan(dag, dtype, cuda)
    assert (plan.stages[0].tile, plan.stages[0].split) == (128, 1)
    assert plan.stages[1].split > 1
    assert plan.stages[1].k_chunk % fused_chain.SLAB_K == 0
    if integer:
        assert _sum_bound(exts, dag) < 2 ** 24
    if entry == "chain":
        chain = tuple(fused_chain.ChainStage(st.k, st.n, st.epilogue,
                                             st.has_bias) for st in dag)
        want = [fused_chain.chain_reference(lhs, w0.T, w1.T, b0.reshape(-1),
                                            stages=chain)]

        def run():
            return [fused_chain.fused_chain_matmul(
                lhs.to(cuda), [w0.T.to(cuda), w1.T.to(cuda)],
                [b0.reshape(-1).to(cuda)], stages=chain)]
    else:
        want = fused_chain.dag_reference(exts, stages=dag)

        def run():
            return fused_chain.fused_dag([e.to(cuda) for e in exts],
                                         stages=dag)
    fused_chain.reset_launches()
    got = run()
    torch.cuda.synchronize()
    assert fused_chain.launches == {"fused_chain": int(entry == "chain"),
                                    "fused_dag": int(entry == "dag")}
    _fused_compare(got, want, integer)
    assert all(torch.equal(a, b) for a, b in zip(run(), got))


def _dag_case(rng, integer, dtype, l=72, d=136, f=130):
    """A DAG of the danube layer's shape at small widths: level 0 holds
    three stages, one tapped and one reading an unaligned view of x;
    scores read a scratch rhs transposed (softmax on random operands);
    attend adds an fp32 residual; up has n % 4 != 0 (unaligned rows
    downstream); down adds a chain-dtype residual from scratch."""
    D = fused_chain.DagStage
    x = _fused_operand(rng, (l, d), integer).to(dtype)
    flat = torch.empty(l * d + 1, dtype=dtype)
    flat[1:] = x.flatten()
    xu = flat[1:].view(l, d)                  # x, 2 or 4 bytes off 16
    w = {name: _fused_operand(rng, shape, integer, nz=3,
                              scale=shape[1] ** -0.5).to(dtype)
         for name, shape in (("wq", (d, d)), ("wk", (d, d)),
                             ("wv", (d, d)), ("w1", (f, d)),
                             ("w2", (d, f)))}
    res = _fused_operand(rng, (l, d), integer)
    b1 = _fused_operand(rng, (1, f), integer, scale=0.1)
    exts = [x, w["wq"].T, xu, w["wk"].T, w["wv"], x.T, res, w["w1"].T, b1,
            w["w2"].T]
    scores = ("scale:2",) if integer else (f"scale:{d ** -0.5}", "softmax")
    stages = (
        D(l, d, d, lhs=("ext", 0), rhs=("ext", 1), tap=0),
        D(l, d, d, lhs=("ext", 2), rhs=("ext", 3)),
        D(d, d, l, lhs=("ext", 4), rhs=("ext", 5)),
        D(l, d, l, lhs=("scr", 0), rhs=("scr", 1), epilogue=scores),
        D(l, l, d, lhs=("scr", 3), rhs=("scr", 2), res=("ext", 6)),
        D(l, d, f, lhs=("scr", 4), rhs=("ext", 7), has_bias=True, bias=8,
          epilogue=("bias", "relu" if integer else "gelu")),
        D(l, f, d, lhs=("scr", 5), rhs=("ext", 9), res=("scr", 4)))
    return exts, stages


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("operands", ["integer", "normal"])
def test_fused_dag_shared_level_taps_and_residuals(cuda, operands, dtype):
    integer = operands == "integer"
    exts, stages = _dag_case(np.random.default_rng(12), integer, dtype)
    plan = fused_chain.card_plan(stages, dtype, cuda)
    assert [sp.level for sp in plan.stages] == [0, 0, 0, 1, 2, 3, 4]
    assert len(plan.phases) == 5
    # every stage on 64-wide tiles; the tapped stage and scores split k,
    # so the tap is written by the split sum and the softmax row phase
    # sums its row's partials
    assert {sp.tile for sp in plan.stages} == {64}
    assert plan.stages[0].split > 1 and plan.stages[3].split > 1
    if integer:
        assert _sum_bound(exts, stages) < 2 ** 24
    want = fused_chain.dag_reference(exts, stages=stages)

    def run():
        return fused_chain.fused_dag([e.to(cuda) for e in exts],
                                     stages=stages)
    fused_chain.reset_launches()
    got = run()
    torch.cuda.synchronize()
    assert fused_chain.launches["fused_dag"] == 1
    assert len(got) == 2                      # the result and one tap
    _fused_compare(got, want, integer)
    assert all(torch.equal(a, b) for a, b in zip(run(), got))


# ---------------------------------------------------------------------------
# the serving path's kernels (csrc/flash_attention.cu, csrc/paged.cu)
# ---------------------------------------------------------------------------

MASKS = {"causal": (True, None), "swa16": (True, 16), "cross": (False, None)}


def _attn_inputs(b, hq, hkv, lq, lkv, d, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(s).astype(np.float32)
                            ).to(dtype)
            for s in ((b, hq, lq, d), (b, hkv, lkv, d), (b, hkv, lkv, d))]


def _attn_compare(got, want, dtype, qkv=None, causal=True, window=None):
    """``got`` against ``want``; in bf16 also against the plain version
    on ``qkv`` that rounds P to bf16, row by row."""
    from repro_torch.kernels import flash_attention as fa
    got, want = got.cpu().float(), want.cpu().float()
    assert got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    err = (got - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), err
    if dtype == torch.bfloat16:
        rounded = fa.flash_attention_plain(*qkv, causal=causal,
                                           window=window, round_p=True)
        row = fa.row_error(got, rounded)
        assert row <= fa.BF16_ROW_TOL, row


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", [16, 64, 80, 128])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("mask", list(MASKS))
def test_flash_attention_kernel(cuda, mask, hq, hkv, d, dtype):
    from repro_torch.kernels import flash_attention as fa
    causal, window = MASKS[mask]
    q, k, v = _attn_inputs(2, hq, hkv, 96, 96, d, dtype, seed=d + hq)
    fa.reset_launches()
    got = fa.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                             causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches["flash_attention"] == 1
    want = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.launches["flash_attention"] == 1    # the CPU never launches
    _attn_compare(got, want, dtype, (q, k, v), causal, window)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("off", [0, 40, 128, 200])
@pytest.mark.parametrize("mask", ["causal", "swa16"])
def test_flash_attention_q_offset(cuda, mask, off, dtype):
    # a block of 72 query rows placed at position ``off`` of 272 keys,
    # against the plain version with the same offset (bf16: the one that
    # rounds P, row by row), and ops.attention's padded path
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    causal, window = MASKS[mask]
    q, k, v = _attn_inputs(2, 8, 2, 72, 272, 80, dtype, seed=off)
    got = fa.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                             causal=causal, window=window, q_offset=off)
    bf16 = dtype == torch.bfloat16
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    q_offset=off, round_p=bf16)
    if bf16:
        assert fa.row_error(got.cpu(), want) <= fa.BF16_ROW_TOL
    else:
        err = (got.cpu() - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), err
    padded = ops.attention(q.to(cuda), k.to(cuda), v.to(cuda),
                           causal=causal, window=window, q_offset=off)
    assert torch.equal(padded[:, :, :72], got)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("off", [0, 40, 128, 200])
@pytest.mark.parametrize("mask", ["causal", "swa16"])
def test_flash_backward_q_offset(cuda, mask, off, dtype):
    # the backward kernels at a block of 72 query rows placed at ``off``
    # of 272 keys, against the plain backward with the same offset; then
    # the Function on the card (forward and backward kernels, never the
    # plain version) against autograd through the plain forward
    from repro_torch.kernels import flash_attention as fa
    causal, window = MASKS[mask]
    _, got, want = _backward_case(cuda, 2, 8, 2, 72, 272, 80, dtype,
                                  causal, window, seed=off + 7, q_offset=off)
    _backward_compare(got, want, dtype)
    q, k, v = _attn_inputs(1, 8, 2, 72, 272, 80, torch.float32, seed=off)
    g = torch.randn(1, 8, 72, 80, generator=torch.Generator().manual_seed(3))
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        leaves = [x.to(dev).requires_grad_() for x in (q, k, v)]
        fa.reset_launches()
        out = fa.flash_attention(*leaves, causal=causal, window=window,
                                 q_offset=off)
        grads[dev.type] = torch.autograd.grad(out, leaves, g.to(dev))
        torch.cuda.synchronize()
        if dev.type == "cuda":
            assert fa.launches == {"flash_attention": 1,
                                   "flash_attention_backward": 1}
    _backward_compare(grads["cuda"], grads["cpu"], torch.float32)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_attention_ragged_q_and_masked_rows_on_card(cuda, dtype):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    q, k, v = _attn_inputs(1, 2, 2, 50, 64, 16, dtype, seed=0)
    got = ops.attention(q.to(cuda), k.to(cuda), v.to(cuda), causal=True,
                        bq=16, bkv=16)
    assert got.shape == (1, 2, 50, 16)
    _attn_compare(got, ref.attention_ref(q, k, v, causal=True), dtype,
                  (q, k, v))
    # a window of 4 hides whole 64-column kv blocks from later q blocks
    q, k, v = _attn_inputs(1, 1, 1, 200, 200, 80, dtype, seed=1)
    got = fa.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                             causal=True, window=4)
    _attn_compare(got, ref.attention_ref(q, k, v, causal=True, window=4),
                  dtype, (q, k, v), window=4)


#: bf16 at the serve shapes: h2o-danube-1.8b (32 q heads over 8 kv
#: heads, D = 80) and zamba2-1.2b's shared block (32 / 32, D = 64), the
#: longest prefill of the serve traffic, unpadded
@pytest.mark.parametrize("hq,hkv,d", [(32, 8, 80), (32, 32, 64)])
def test_flash_attention_bf16_serve_shapes(cuda, hq, hkv, d):
    from repro_torch.kernels import flash_attention as fa
    q, k, v = (t.to(cuda) for t in _attn_inputs(1, hq, hkv, 1495, 1495, d,
                                                  torch.bfloat16, seed=d))
    fa.reset_launches()
    got = fa.flash_attention(q, k, v, causal=True)
    assert fa.launches["flash_attention"] == 1
    want = fa.flash_attention_plain(q, k, v, causal=True)
    _attn_compare(got, want, torch.bfloat16, (q, k, v))


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("d", [16, 32, 64, 80, 96, 128])
def test_flash_attention_bf16_every_head_dim(cuda, d, mask):
    from repro_torch.kernels import flash_attention as fa
    assert d in fa.HEAD_DIMS
    causal, window = MASKS[mask]
    q, k, v = _attn_inputs(2, 4, 2, 150, 150, d, torch.bfloat16, seed=d)
    got = fa.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                             causal=causal, window=window)
    _attn_compare(got, fa.flash_attention(q, k, v, causal=causal,
                                          window=window), torch.bfloat16,
                  (q, k, v), causal, window)


@pytest.mark.parametrize("window", [None, 40])
def test_flash_attention_bf16_rows_ignore_kv_padding(cuda, window):
    # a row's output must not depend on how far Lq and Lkv are padded past
    # it (the slot engine and DecodeEngine prefill at different pads), and
    # two calls give the same bits
    from repro_torch.kernels import flash_attention as fa
    q, k, v = (t.to(cuda) for t in _attn_inputs(1, 4, 2, 256, 320, 80,
                                                  torch.bfloat16, seed=7))
    base = fa.flash_attention(q[:, :, :100], k[:, :, :100], v[:, :, :100],
                              causal=True, window=window)
    for lq, lkv in ((128, 128), (256, 192), (100, 320)):
        out = fa.flash_attention(q[:, :, :lq], k[:, :, :lkv],
                                 v[:, :, :lkv], causal=True, window=window)
        assert torch.equal(out[:, :, :100], base), (lq, lkv)
    assert torch.equal(fa.flash_attention(
        q[:, :, :100], k[:, :, :100], v[:, :, :100], causal=True,
        window=window), base)


def test_flash_attention_bf16_misaligned_view_raises(cuda):
    from repro_torch.kernels import flash_attention as fa
    q, k, v = (t.to(cuda) for t in _attn_inputs(1, 2, 2, 64, 64, 64,
                                                  torch.bfloat16, seed=0))
    flat = torch.zeros(q.numel() + 1, dtype=q.dtype, device=cuda)
    shifted = flat[1:].view(q.shape)
    with pytest.raises(ValueError, match="q 16-byte aligned"):
        fa.flash_attention(shifted, k, v)
    wide = torch.zeros((1, 2, 64, 68), dtype=q.dtype, device=cuda)
    with pytest.raises(ValueError, match="v 16-byte aligned"):
        fa.flash_attention(q, k, wide[..., :64])
    # fp32 runs the SIMT kernel, which reads any row stride
    wide32 = torch.zeros((1, 2, 64, 68), device=cuda)
    fa.flash_attention(q.float(), k.float(), wide32[..., :64])


def test_flash_attention_reads_strided_heads(cuda):
    # the models hand over (B, L, H, D) storage viewed as (B, H, L, D)
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.standard_normal((2, 70, 12, 80)).astype(
        np.float32))
    q, k, v = (x[:, :, 0:8].transpose(1, 2), x[:, :, 8:10].transpose(1, 2),
               x[:, :, 10:12].transpose(1, 2))
    got = fa.flash_attention(*(t.to(cuda) for t in (q, k, v)))
    _attn_compare(got, fa.flash_attention(q, k, v), torch.float32)


#: non-causal attention at ragged kv lengths: whisper's 1500 frames (12
#: heads of 64), the vision model's 1601 patches (32 q heads over 8 kv
#: heads of 128) and a small odd length
RAGGED_KV = {1500: (12, 12, 64), 1601: (32, 8, 128), 37: (4, 2, 16)}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("form", ["self", "cross"])
@pytest.mark.parametrize("lkv", sorted(RAGGED_KV))
def test_flash_attention_noncausal_ragged_kv(cuda, lkv, form, dtype):
    """An encoder's self-attention (Lq = Lkv) and cross-attention (Lq 45
    against Lkv): the kernel masks the kv columns past Lkv itself (no
    block of 64 divides these lengths)."""
    from repro_torch.kernels import flash_attention as fa
    hq, hkv, d = RAGGED_KV[lkv]
    lq = lkv if form == "self" else 45
    q, k, v = _attn_inputs(1, hq, hkv, lq, lkv, d, dtype, seed=lkv)
    fa.reset_launches()
    got = fa.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                             causal=False)
    torch.cuda.synchronize()
    assert fa.launches["flash_attention"] == 1
    want = fa.flash_attention_plain(q, k, v, causal=False)
    _attn_compare(got, want, dtype, (q, k, v), causal=False)


def _backward_compare(got, want, dtype):
    """The backward kernels' (dq, dk, dv) against the plain version's:
    fp32 within 1e-4 x max|.| (other sum order, the card's ``expf``),
    bf16 within 2e-2 x max|.| (its outputs rounded to bf16)."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for x, w in zip(got, want):
        x, w = x.cpu().float(), w.cpu().float()
        assert x.shape == w.shape and bool(torch.isfinite(x).all())
        err = (x - w).abs().max().item()
        assert err <= tol * w.abs().max().item(), err


def _backward_case(cuda, b, hq, hkv, lq, lkv, d, dtype, causal, window,
                   seed, q_offset=0):
    """The kernel forward's (out, lse) and both backwards on one input, q
    row i at position ``q_offset + i``."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = (t.to(cuda) for t in _attn_inputs(b, hq, hkv, lq, lkv, d,
                                                  dtype, seed))
    dout = torch.as_tensor(np.random.default_rng(seed + 1).standard_normal(
        (b, hq, lq, d)).astype(np.float32)).to(dtype).to(cuda)
    out, lse = fa._forward(q, k, v, causal, window, with_lse=True,
                           q_offset=q_offset)
    fa.reset_launches()
    got = fa.flash_attention_backward(q, k, v, out, dout, lse,
                                      causal=causal, window=window,
                                      q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa.launches["flash_attention_backward"] == 1
    want = fa.flash_attention_backward_plain(q, k, v, out, dout, lse,
                                             causal=causal, window=window,
                                             q_offset=q_offset)
    return (q, k, v, out, dout, lse), got, want


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", [16, 64, 80, 128])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("mask", list(MASKS))
def test_flash_backward_kernel(cuda, mask, hq, hkv, d, dtype):
    causal, window = MASKS[mask]
    _, got, want = _backward_case(cuda, 2, hq, hkv, 96, 96, d, dtype,
                                  causal, window, seed=d + hq)
    _backward_compare(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("mask", list(MASKS))
def test_flash_forward_writes_the_log_sum_exp(cuda, mask, dtype):
    from repro_torch.kernels import flash_attention as fa
    causal, window = MASKS[mask]
    q, k, v = (t.to(cuda) for t in _attn_inputs(1, 4, 2, 130, 130, 64,
                                                  dtype, seed=5))
    out, lse = fa._forward(q, k, v, causal, window, with_lse=True)
    want_out, want = fa.flash_attention_plain(q, k, v, causal=causal,
                                              window=window, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (1, 4, 130)
    # scores in fp32 either way; bf16 products summed on the tensor cores
    tol = 1e-5 if dtype == torch.float32 else 1e-3
    assert (lse - want).abs().max().item() <= tol * want.abs().max().item()
    # serving (no lse) writes the same output
    assert torch.equal(fa._forward(q, k, v, causal, window,
                                   with_lse=False)[0], out)


@pytest.mark.parametrize("d", [16, 32, 64, 80, 96, 128])
def test_flash_backward_every_head_dim(cuda, d):
    for dtype in DTYPES:
        _, got, want = _backward_case(cuda, 1, 4, 2, 150, 150, d, dtype,
                                      True, 40, seed=d)
        _backward_compare(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(4, 32, 8, 2048, 2048, 80, True, 4096),
                                   (1, 32, 8, 1024, 1024, 80, True, 256),
                                   (1, 12, 12, 57, 1500, 64, False, None),
                                   (1, 4, 2, 45, 37, 16, False, None)])
def test_flash_backward_training_and_ragged_shapes(cuda, shape, dtype):
    """danube's training shape, a window that hides whole kv blocks, and
    ragged non-causal (cross) shapes: no block of 64 divides Lq or Lkv."""
    b, hq, hkv, lq, lkv, d, causal, window = shape
    inputs, got, want = _backward_case(cuda, b, hq, hkv, lq, lkv, d, dtype,
                                       causal, window, seed=lkv)
    _backward_compare(got, want, dtype)
    from repro_torch.kernels import flash_attention as fa
    again = fa.flash_attention_backward(*inputs, causal=causal,
                                        window=window)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_flash_function_trains_through_the_kernels(cuda):
    # autograd on the card: the Function's forward and backward kernels
    # against autograd through the plain version on the CPU (fp32), with
    # q, k and v strided head views as the models hand them over
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 100, 12, 80)).astype(np.float32)
    g = rng.standard_normal((2, 8, 100, 80)).astype(np.float32)
    grads, launched = [], {}
    for dev in (cuda, torch.device("cpu")):
        xt = torch.as_tensor(x, device=dev).requires_grad_()
        q, k, v = (xt[:, :, 0:8].transpose(1, 2),
                   xt[:, :, 8:10].transpose(1, 2),
                   xt[:, :, 10:12].transpose(1, 2))
        fa.reset_launches()
        out = fa.flash_attention(q, k, v, causal=True, window=30)
        (gx,) = torch.autograd.grad(out, xt, torch.as_tensor(g, device=dev))
        torch.cuda.synchronize()
        grads.append(gx.cpu())
        launched[dev.type] = dict(fa.launches)
    assert launched == {
        "cuda": {"flash_attention": 1, "flash_attention_backward": 1},
        "cpu": {"flash_attention": 0, "flash_attention_backward": 0}}
    err = (grads[0] - grads[1]).abs().max().item()
    assert err <= 1e-4 * grads[1].abs().max().item(), err


def test_train_step_on_the_card_matches_the_cpu(cuda):
    # the reduced dense model in fp32 (remat on): one step's loss and
    # gradients on the card (flash forward and backward kernels) against
    # the CPU's plain path
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, _batch_numpy
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import init_params
    from repro_torch.train import trainer
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b").reduced(),
                              remat=True)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    batch = _batch_numpy(DataConfig(vocab=cfg.vocab, seq_len=64,
                                    global_batch=2), 0)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        fa.reset_launches()
        p = _to(params, dev)
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        out[dev.type] = trainer.value_and_grad(p, b, cfg)
        if dev.type == "cuda":
            assert fa.launches["flash_attention"] == 2 * cfg.n_layers
            assert fa.launches["flash_attention_backward"] == cfg.n_layers
    (lc, _, gc), (lp, _, gp) = out["cuda"], out["cpu"]
    assert abs(float(lc) - float(lp)) <= 1e-5 * abs(float(lp))
    for key, g in _flat(gc).items():
        w = _flat(gp)[key]
        err = (g.cpu() - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item(), (key, err)


def test_bf16_train_step_kernels_against_the_plain_attention(cuda,
                                                             monkeypatch):
    # check (d) of chip_smoke.py at a small width: bf16 compute, remat on;
    # the flash kernels against autograd through the plain version that
    # rounds P as the forward kernel does, within the bf16 tolerance
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, _batch_numpy
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import init_params
    from repro_torch.train import trainer
    cfg = dataclasses.replace(
        get_config("h2o-danube-1.8b"), n_layers=2, d_model=512, n_heads=8,
        n_kv_heads=2, head_dim=64, d_ff=1024, vocab=4000)
    params = init_params(torch.Generator(device=cuda).manual_seed(1), cfg)
    batch = {k: torch.as_tensor(v, device=cuda) for k, v in _batch_numpy(
        DataConfig(vocab=cfg.vocab, seq_len=256, global_batch=2), 0).items()}
    kernel = trainer.value_and_grad(params, batch, cfg)
    monkeypatch.setattr(fa, "flash_attention",
                        lambda q, k, v, *, causal=True, window=None,
                        q_offset=0:
                        fa.flash_attention_plain(q, k, v, causal=causal,
                                                 window=window, round_p=True,
                                                 q_offset=q_offset))
    plain = trainer.value_and_grad(params, batch, cfg)
    assert abs(float(kernel[0]) - float(plain[0])) <= 2e-2 * abs(
        float(plain[0]))
    for key, g in _flat(kernel[2]).items():
        w = _flat(plain[2])[key].float()
        err = (g.float() - w).abs().max().item()
        assert err <= 2e-2 * w.abs().max().item(), (key, err)


def test_ssd_under_autograd_runs_the_backward_kernels(cuda):
    # under grad the call goes through SSDScanFn: one forward and, on
    # backward, one backward launch; its gradients equal autograd through
    # the plain version; without grad no Function is recorded
    from repro_torch.kernels import ref, ssd_scan
    ops_ = [t.to(cuda) for t in _ssd_operands(2, 48, 4, 8, 2, 16, seed=7)]
    ins = [t.clone().requires_grad_() for t in ops_]
    dy = torch.randn(2, 48, 4, 8, device=cuda)
    ssd_scan.reset_launches()
    y, _ = ssd_scan.ssd_scan(*ins, chunk=16)
    assert "SSDScanFn" in type(y.grad_fn).__name__
    got = torch.autograd.grad((y * dy).sum(), ins)
    assert ssd_scan.launches == {"ssd_scan": 1, "ssd_scan_backward": 1}
    ins2 = [t.clone().requires_grad_() for t in ops_]
    y2, _ = ref.ssd_chunked_ref(*ins2, chunk=16)
    _ssd_compare(got, torch.autograd.grad((y2 * dy).sum(), ins2))
    with torch.no_grad():
        y, _ = ssd_scan.ssd_scan(*ins, chunk=16)
    assert y.grad_fn is None and ssd_scan.launches["ssd_scan"] == 2


def _ssd_backward_inputs(b, L, h, p, g, n, seed, final):
    rng = np.random.default_rng(seed + 1)
    dy = torch.as_tensor(rng.standard_normal((b, L, h, p)).astype(np.float32))
    dh = torch.as_tensor(rng.standard_normal((b, h, n, p)).astype(
        np.float32)) if final else None
    return _ssd_operands(b, L, h, p, g, n, seed), dy, dh


@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("g,r,hb", [(1, 4, None), (2, 2, None), (4, 1, 4),
                                    (1, 3, 4), (2, 6, 4)])
@pytest.mark.parametrize("p", [16, 24, 64, 80])
@pytest.mark.parametrize("n", [16, 64, 128])
@pytest.mark.parametrize("q", [8, 37, 64])
def test_ssd_backward_kernel(cuda, monkeypatch, q, n, p, g, r, hb, final):
    # every gradient within 1e-4 x max|.| of the plain version, ragged
    # chunks, both state widths, more than one column tile (P = 80); r
    # heads a group: the plan's block (one head a CTA at these sizes, the
    # blocks' dB and dC summed by the sum kernel) and 4 heads a CTA (one
    # head a group, a partial block of 3, blocks of 4 and 2); with and
    # without a final-state gradient; a second call gives the same bits
    import functools

    from repro_torch.kernels import ssd_scan
    if hb is not None:
        monkeypatch.setattr(ssd_scan, "backward_plan", functools.partial(
            ssd_scan.backward_plan, head_block=hb))
    ops_, dy, dh = _ssd_backward_inputs(2, 3 * q, g * r, p, g, n,
                                        seed=q + n + p + g + r, final=final)
    want = ssd_scan.ssd_scan_backward_plain(*ops_, dy, dh, chunk=q)
    dev = [t.to(cuda) for t in ops_]
    dyc, dhc = dy.to(cuda), None if dh is None else dh.to(cuda)
    ssd_scan.reset_launches()
    got = ssd_scan.ssd_scan_backward(*dev, dyc, dhc, chunk=q)
    assert ssd_scan.launches == {"ssd_scan": 1, "ssd_scan_backward": 1}
    _ssd_compare(got, want)
    again = ssd_scan.ssd_scan_backward(*dev, dyc, dhc, chunk=q)
    assert all(torch.equal(u, v) for u, v in zip(got, again))


@pytest.mark.parametrize("n", [64, 128])
def test_ssd_backward_kernels_as_built(cuda, n):
    # the chunk kernels' shared bytes are the plan's; the runtime keeps two
    # chunk-kernel CTAs (16 warps) an SM, registers included, and neither
    # kernel spills to local memory
    import ctypes

    from repro_torch.kernels import _build, ssd_scan
    out = (ctypes.c_int * 8)()
    assert _build.library("ssd_scan").ssd_scan_backward_info(n, out) == 0
    plan = ssd_scan.backward_plan(4, 2048, 32, 1, n, 64, 64)
    assert (out[0], out[4]) == (plan.chunk_smem, plan.dstate_smem)
    assert out[1] >= 2 and out[5] >= 2
    assert out[2] <= 128 and out[3] == 0 and out[7] == 0


@pytest.mark.parametrize("model", ["mamba2-370m", "zamba2-1.2b"])
def test_ssd_backward_at_the_training_shape(cuda, model):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan
    lm = get_config(model)
    ops_, dy, _ = _ssd_backward_inputs(
        4, 2048, lm.ssm_heads, lm.ssm_head_dim, lm.ssm_groups, lm.ssm_state,
        seed=3, final=False)
    dev = [t.to(cuda) for t in ops_]
    got = ssd_scan.ssd_scan_backward(*dev, dy.to(cuda), chunk=lm.ssm_chunk)
    want = ssd_scan.ssd_scan_backward_plain(*dev, dy.to(cuda),
                                            chunk=lm.ssm_chunk)
    _ssd_compare(got, want)


def test_ssd_backward_reads_the_models_strided_views(cuda):
    # x, B and C as views of one conv output, dt of another tensor, bf16
    # dy: the Function's gradients against autograd through the plain
    # version, each in its input's dtype
    from repro_torch.kernels import ref, ssd_scan
    rng = np.random.default_rng(11)
    h, p, g, n, L = 4, 16, 1, 32, 74
    conv = torch.as_tensor(rng.standard_normal(
        (2, L, h * p + 2 * g * n)).astype(np.float32), device=cuda)
    dt = torch.as_tensor((0.1 + 0.9 * rng.random((2, L, h))).astype(
        np.float32), device=cuda)
    a = torch.as_tensor((-0.5 - rng.random(h)).astype(np.float32),
                        device=cuda)
    dy = torch.as_tensor(rng.standard_normal((2, L, h, p)).astype(
        np.float32), device=cuda)
    grads = []
    for fn in (ssd_scan.ssd_scan, ref.ssd_chunked_ref):
        cv, dtv, av = (t.clone().requires_grad_() for t in (conv, dt, a))
        x = cv[..., :h * p].reshape(2, L, h, p)
        b = cv[..., h * p:h * p + g * n].reshape(2, L, g, n)
        c = cv[..., h * p + g * n:].reshape(2, L, g, n)
        y, _ = fn(x, dtv, av, b, c, chunk=37)
        grads.append(torch.autograd.grad((y * dy).sum(), (cv, dtv, av)))
    _ssd_compare(*grads)


@pytest.mark.parametrize("model", ["mamba2-370m", "zamba2-1.2b"])
def test_ssm_train_step_on_the_card_matches_the_cpu(cuda, model):
    # the reduced model in fp32 (remat on, a padded length): one step's
    # loss and gradients on the card (SSD forward and backward kernels,
    # zamba2's flash kernels) against the CPU's plain path
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, _batch_numpy
    from repro_torch.kernels import ssd_scan
    from repro_torch.models import init_params
    from repro_torch.train import trainer
    cfg = dataclasses.replace(get_config(model).reduced(), remat=True)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    batch = _batch_numpy(DataConfig(vocab=cfg.vocab, seq_len=60,
                                    global_batch=2), 0)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        ssd_scan.reset_launches()
        p = _to(params, dev)
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        out[dev.type] = trainer.value_and_grad(p, b, cfg)
        if dev.type == "cuda":
            assert ssd_scan.launches == {"ssd_scan": 2 * cfg.n_layers,
                                         "ssd_scan_backward": cfg.n_layers}
    (lc, _, gc), (lp, _, gp) = out["cuda"], out["cpu"]
    assert abs(float(lc) - float(lp)) <= 1e-5 * abs(float(lp))
    for key, g in _flat(gc).items():
        w = _flat(gp)[key]
        err = (g.cpu() - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item(), (key, err)


def _to(tree, dev):
    return {k: (_to(v, dev) if isinstance(v, dict) else v.to(dev))
            for k, v in tree.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


@pytest.mark.parametrize("f", [15360, 48, 7])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_paged_gather_kernel_exact(cuda, dtype, f):
    from repro_torch.kernels import paged
    rng = np.random.default_rng(f)
    pool = torch.as_tensor(rng.standard_normal((9, 4, f)).astype(
        np.float32)).to(dtype)
    table = torch.as_tensor(rng.integers(0, 8, (3, 5)).astype(np.int32))
    table[1, 3:] = 8                       # unmapped: the scratch page
    paged.reset_launches()
    got = paged.paged_gather(pool.to(cuda), table.to(cuda))
    torch.cuda.synchronize()
    assert paged.launches["paged_gather"] == 1
    want = paged.paged_gather(pool, table)
    assert paged.launches["paged_gather"] == 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("model,f", [("h2o-danube-1.8b", 15360),
                                     ("zamba2-1.2b", 12288)])
def test_paged_gather_serve_shape_exact(cuda, model, f):
    # the serve phase's pool and table shape: 8 slots of 128 pages of 16
    # rows, each slot holding 9..100 pages (the traffic's range) drawn from
    # a permutation of the pool, the rest on the scratch page
    from repro_torch.kernels import paged
    rng = np.random.default_rng(0)
    pool = torch.randn((513, 16, f), device=cuda).to(torch.bfloat16)
    table = np.full((8, 128), 512, np.int32)
    free = rng.permutation(512).tolist()
    for c, need in enumerate(rng.integers(9, 101, 8)):
        table[c, :need] = [free.pop() for _ in range(need)]
    table = torch.as_tensor(table, device=cuda)
    got = paged.paged_gather(pool, table)
    assert torch.equal(got, paged.paged_gather_plain(pool, table))
    assert torch.equal(got.view(8 * 128, 16, f),
                       pool.index_select(0, table.flatten().long()))


@pytest.mark.parametrize("offset", [1, 3, 8])
@pytest.mark.parametrize("f", [15360, 7])
def test_paged_gather_misaligned_pool_exact(cuda, f, offset):
    # a pool whose base is not 16-byte aligned (offset bf16 elements into
    # its storage; 8 elements keep it aligned): every page takes the
    # element path, or the vector path with an element tail
    from repro_torch.kernels import paged
    flat = torch.randn(9 * 4 * f + offset, device=cuda).to(torch.bfloat16)
    pool = flat[offset:].view(9, 4, f)
    table = torch.as_tensor(np.random.default_rng(f).integers(
        0, 9, (3, 5)).astype(np.int32), device=cuda)
    got = paged.paged_gather(pool, table)
    assert torch.equal(got, paged.paged_gather_plain(pool, table))


def _ssd_operands(b, L, h, p, g, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, L, h, p)).astype(np.float32)
    dt = (0.1 + 0.9 * rng.random((b, L, h))).astype(np.float32)
    a = (-0.5 - rng.random(h)).astype(np.float32)
    bm = rng.standard_normal((b, L, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, L, g, n)).astype(np.float32)
    return [torch.as_tensor(v) for v in (x, dt, a, bm, cm)]


def _ssd_compare(got, want):
    for g_, w_ in zip(got, want):
        g_, w_ = g_.cpu(), w_.cpu()
        assert bool(torch.isfinite(g_).all())
        scale = w_.abs().max().item()
        assert (g_ - w_).abs().max().item() <= 1e-4 * scale


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("p", [16, 24, 64])
@pytest.mark.parametrize("n", [16, 64, 128])
@pytest.mark.parametrize("q", [8, 37, 64])
def test_ssd_scan_kernel(cuda, q, n, p, g):
    from repro_torch.kernels import ssd_scan
    ops_ = _ssd_operands(2, 3 * q, 4, p, g, n, seed=q + n + p + g)
    ssd_scan.reset_launches()
    got = ssd_scan.ssd_scan(*(t.to(cuda) for t in ops_), chunk=q)
    torch.cuda.synchronize()
    assert ssd_scan.launches["ssd_scan"] == 1
    want = ssd_scan.ssd_scan(*ops_, chunk=q)
    assert ssd_scan.launches["ssd_scan"] == 1     # the CPU never launches
    assert got[1].shape == (2, 4, n, p)
    _ssd_compare(got, want)


@pytest.mark.parametrize("model", ["zamba2-1.2b", "mamba2-370m"])
def test_ssd_full_width_longest_prefill(cuda, model):
    # the serve phase's longest prefill at the model's heads and state;
    # the plain version runs on the card in fp32 (TF32 off)
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ref, ssd_scan
    lm = get_config(model)
    length = {"zamba2-1.2b": 1536, "mamba2-370m": 1472}[model]
    ops_ = [t.to(cuda) for t in _ssd_operands(
        1, length, lm.ssm_heads, lm.ssm_head_dim, lm.ssm_groups,
        lm.ssm_state, seed=length)]
    got = ssd_scan.ssd_scan(*ops_, chunk=lm.ssm_chunk)
    _ssd_compare(got, ref.ssd_chunked_ref(*ops_, chunk=lm.ssm_chunk))
    again = ssd_scan.ssd_scan(*ops_, chunk=lm.ssm_chunk)
    assert all(torch.equal(u, v) for u, v in zip(got, again))


@pytest.mark.parametrize("g,h,p,q", [(1, 42, 24, 32), (2, 42, 64, 16),
                                     (1, 42, 64, 37)])
def test_ssd_many_chunks_and_a_partial_head_block(cuda, g, h, p, q):
    # 24 chunks; the plan's head block (4) does not divide the heads of a
    # group, so the last block of each group is partial
    from repro_torch.kernels import ref, ssd_scan
    plan = ssd_scan.launch_plan(2, 24 * q, h, g, 64, p, q)
    assert plan.n_chunks >= 24 and (h // g) % plan.head_block
    ops_ = [t.to(cuda) for t in _ssd_operands(2, 24 * q, h, p, g, 64,
                                               seed=h + p + q)]
    got = ssd_scan.ssd_scan(*ops_, chunk=q)
    _ssd_compare(got, ref.ssd_chunked_ref(*ops_, chunk=q))


def test_ssd_empty_sequence_gives_a_zero_state(cuda):
    from repro_torch.kernels import ssd_scan
    x, dt, a, b, c = (t.to(cuda) for t in _ssd_operands(2, 0, 4, 24, 2, 16,
                                                         seed=0))
    ssd_scan.reset_launches()
    y, h = ssd_scan.ssd_scan(x, dt, a, b, c, chunk=16)
    torch.cuda.synchronize()
    assert y.shape == (2, 0, 4, 24)
    assert torch.equal(h, torch.zeros((2, 4, 16, 24), device=cuda))
    assert ssd_scan.launches["ssd_scan"] == 1


def test_ssd_reads_the_models_strided_views(cuda):
    # the models pass x, B and C as views of one projection (row stride
    # the projection's width) and dt as its own tensor; a misaligned
    # start takes the scalar loads
    from repro_torch.kernels import ref, ssd_scan
    rng = np.random.default_rng(4)
    h, p, g, n, L = 6, 24, 2, 20, 3 * 37
    for off in (0, 1):
        proj = torch.as_tensor(rng.standard_normal(
            (2, L, off + h * p + 2 * g * n)).astype(np.float32)).to(cuda)
        x = proj[..., off:off + h * p].reshape(2, L, h, p)
        b = proj[..., off + h * p:off + h * p + g * n].reshape(2, L, g, n)
        c = proj[..., off + h * p + g * n:].reshape(2, L, g, n)
        dt = torch.as_tensor((0.1 + 0.9 * rng.random((2, L, 2 * h))).astype(
            np.float32)).to(cuda)[..., ::2]
        a = torch.as_tensor((-0.5 - rng.random(h)).astype(np.float32)
                            ).to(cuda)
        got = ssd_scan.ssd_scan(x, dt, a, b, c, chunk=37)
        _ssd_compare(got, ref.ssd_chunked_ref(x, dt, a, b, c, chunk=37))


def test_ssd_on_card_matches_the_oracle_and_rejects_shapes(cuda):
    from repro_torch.kernels import ops, ref, ssd_scan
    x, dt, a, b, c = _ssd_operands(1, 96, 8, 16, 2, 32, seed=5)
    got = ssd_scan.ssd_scan(*(t.to(cuda) for t in (x, dt, a, b, c)),
                            chunk=32)
    _ssd_compare(got, ref.ssd_chunked_ref(x, dt, a, b, c, chunk=32))
    y = ops.ssd(*(t.to(cuda) for t in (x, dt, a, b, c)), chunk=32)
    _ssd_compare([y], [got[0]])
    yb, hb = ssd_scan.ssd_scan(x.bfloat16().to(cuda),
                               *(t.to(cuda) for t in (dt, a, b, c)),
                               chunk=32)
    assert yb.dtype == torch.bfloat16 and hb.dtype == torch.float32
    x, dt, a, bm, cm = (t.to(cuda) for t in _ssd_operands(1, 128, 2, 16, 1,
                                                           16, seed=0))
    with pytest.raises(ValueError, match="chunks up to 64"):
        ssd_scan.ssd_scan(x, dt, a, bm, cm, chunk=128)
    wide = torch.zeros((1, 128, 1, 256), device=cuda)
    with pytest.raises(ValueError, match="state widths"):
        ssd_scan.ssd_scan(x, dt, a, wide, wide, chunk=64)


def test_slot_engine_on_card_continuous_equals_one_at_a_time(cuda):
    _slot_engine_on_card("h2o-danube-1.8b", cuda)


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_slot_engine_on_card_ssm_families(cuda, arch):
    _slot_engine_on_card(arch, cuda)


#: the families that route to experts or take a frontend
NEW_FAMILIES = ["mixtral-8x22b", "whisper-small", "llama-3.2-vision-11b"]


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_slot_engine_on_card_new_families(cuda, arch):
    _slot_engine_on_card(arch, cuda)


def _family_setup(arch):
    """Reduced config, fp32 params drawn on the CPU (vlm gates opened to
    0.5), and a (2, F, D) frontend or None."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config(arch).reduced()
    params = init_params(torch.Generator().manual_seed(0), cfg)
    if cfg.family == "vlm":
        params["cross_layers"]["gate"].fill_(0.5)
    fe = None
    if cfg.frontend_tokens:
        fe = 0.1 * torch.randn((2, cfg.frontend_tokens, cfg.d_model),
                               generator=torch.Generator().manual_seed(1))
    return cfg, params, fe


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_family_prefill_and_decode_step_on_card_match_cpu(cuda, arch):
    """One prefill (flash attention on the card: causal self-attention,
    and for whisper its non-causal encoder and cross-attention) and one
    decode step, within 1e-4 x max|logit| of the same calls on the CPU;
    the cross caches within one bf16 unit in the last place."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import decode
    from repro_torch.serve.engine import to_device
    cfg, params, fe = _family_setup(arch)
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 13)))
    runs = {}
    fa.reset_launches()
    for dev in ("cpu", cuda):
        p = to_device(params, torch.device(dev))
        f = None if fe is None else fe.to(dev)
        logits, cache = decode.prefill(p, toks.to(dev), cfg, frontend=f,
                                       max_len=24)
        step, cache = decode.decode_step(p, toks[:, -1:].to(dev), cache, cfg)
        runs[str(dev)] = (logits.cpu(), step.cpu(),
                          {k: v.cpu() for k, v in cache.get("cross",
                                                            {}).items()})
    assert fa.launches["flash_attention"] > 0
    (lc, sc, xc), (lg, sg, xg) = runs["cpu"], runs["cuda"]
    for got, want in ((lg, lc), (sg, sc)):
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    for leaf in xc:
        torch.testing.assert_close(xg[leaf].float(), xc[leaf].float(),
                                   rtol=2.0 ** -7, atol=1e-6)


def _slot_engine_on_card(arch, cuda):
    """Continuous tokens equal each request served alone, and the path
    launched the kernels the family runs."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged, ssd_scan
    from repro_torch.models import init_params
    from repro_torch.serve import SlotEngine
    cfg = get_config(arch).reduced()
    params = init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    reqs = [(8, 6), (12, 4), (5, 8), (9, 3), (11, 6), (20, 10)]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (s,)).astype(np.int32)
               for s, _ in reqs]
    if cfg.family == "vlm":
        params["cross_layers"]["gate"].fill_(0.5)
    fes = [None] * len(reqs)
    if cfg.frontend_tokens:
        fes = [(0.1 * rng.standard_normal((cfg.frontend_tokens,
                                           cfg.d_model))).astype(np.float32)
               for _ in reqs]
    eng = SlotEngine(params, cfg, capacity=3, max_context=32, page_size=8,
                     total_pages=8)
    fa.reset_launches()
    paged.reset_launches()
    ssd_scan.reset_launches()
    got = _drive(eng, prompts, reqs, fes)
    attention = cfg.family != "ssm"
    assert (fa.launches["flash_attention"] > 0) == attention
    assert (paged.launches["paged_gather"] > 0) == attention
    assert (ssd_scan.launches["ssd_scan"] > 0) == (
        cfg.family in ("ssm", "hybrid"))
    for i, (p, (_, t)) in enumerate(zip(prompts, reqs)):
        alone = _drive(eng, [p], [(len(p), t)], fes[i:i + 1])[0]
        np.testing.assert_array_equal(got[i], alone)
    assert eng.decode_compiles == 1


def _drive(eng, prompts, reqs, frontends=None):
    """Queue -> insert/step/evict until every request finished."""
    frontends = frontends or [None] * len(reqs)
    got, queue, resident, left = {}, list(range(len(reqs))), {}, {}
    while queue or resident:
        while queue and eng.free_slots():
            i = queue[0]
            res = eng.insert(prompts[i], max_new_tokens=reqs[i][1],
                             frontend=frontends[i])
            if res is None:
                break
            queue.pop(0)
            slot, tok = res
            got[i] = [tok]
            resident[slot], left[slot] = i, reqs[i][1] - 1
        r = eng.step()
        for slot, i in list(resident.items()):
            if r.valid_at(slot):
                got[i].append(r.token_at(slot))
                left[slot] -= 1
            if left[slot] == 0:
                eng.evict(slot)
                del resident[slot], left[slot]
    return [np.asarray(got[i], np.int32) for i in range(len(reqs))]


# ---------------------------------------------------------------------------
# measured autotuning (repro_torch.tune) on the card
# ---------------------------------------------------------------------------

def _traced_kernel_s(fn):
    """Device time of the kernels one call of ``fn`` runs, traced."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
             for ev in prof.key_averages()
             if str(getattr(ev, "device_type", "")).endswith("CUDA"))
    return us / 1e6


def test_measure_waits_for_the_card(cuda):
    from repro_torch.tune.measure import measure
    acc = repro_torch.generate("gemm", "output_stationary",
                               bounds=dict(m=4096, n=4096, k=4096),
                               validate=False)
    g = torch.Generator(device=cuda).manual_seed(0)
    ops = {t.name: torch.randint(-4, 5, acc.algebra.tensor_shape(t),
                                 generator=g, device=cuda,
                                 dtype=torch.float32)
           for t in acc.algebra.inputs}
    m = measure(acc, ops, warmup=1, repeats=5)
    kernel_s = _traced_kernel_s(lambda: acc(ops))
    if kernel_s == 0.0:
        pytest.skip("the profiler traced no device time on this card")
    # the host clock around a synchronized call holds the whole kernel;
    # a launch-only clock would read a few microseconds
    assert m.median_s >= kernel_s, (m.median_s, kernel_s)


def test_tune_mid_size_winner_exact(cuda):
    from repro_torch.kernels import ref
    from repro_torch.tune import cache
    stt_gemm.reset_launches()
    acc = repro_torch.generate("gemm", bounds=dict(m=512, n=512, k=512),
                               tune=4, validate=False)
    tr = acc.tune_result
    assert not tr.cache_hit and len(tr.trials) > 1
    assert acc.device.type == "cuda" and acc.kernel.source == "tuned"
    assert tr.tuned_s <= tr.untuned_s
    assert all(t.error.startswith("ValueError") for t in tr.trials
               if not t.ok)
    assert sum(stt_gemm.launches.values()) > 0
    g = torch.Generator(device=cuda).manual_seed(1)
    ops = {t.name: torch.randint(-4, 5, acc.algebra.tensor_shape(t),
                                 generator=g, device=cuda,
                                 dtype=torch.float32)
           for t in acc.algebra.inputs}
    k = acc.kernel
    lhs, rhs = k.form.prepare(k.cast_operands(ops))
    want = k.form.finish(ref.matmul_ref(lhs, rhs, out_dtype=k.dtype))
    assert torch.equal(acc(ops), want)
    again = repro_torch.generate("gemm", bounds=dict(m=512, n=512, k=512),
                                 tune=4, validate=False)
    assert again.tune_result.cache_hit and again.tune_result.trials == ()
    assert cache.cache_path().parent.name == "torch"


def test_tune_propagates_a_launch_error(cuda, monkeypatch):
    # a CUDA error at launch inside a trial is not a bad knob: the tune
    # call raises instead of recording a failed trial and going on
    from repro_torch.compile import pipeline
    from repro_torch.core.algebra import get_algebra
    from repro_torch.kernels import _build
    from repro_torch.tune import tuner
    lib = _build.library("stt_gemm")
    real = lib.stt_os_launch
    inplace = 16        # stt_os_launch's in-place accumulation flag

    def fail_inplace(*args):
        return 9 if args[inplace] else real(*args)

    monkeypatch.setattr(lib, "stt_os_launch", fail_inplace)
    alg = get_algebra("gemm", m=256, n=256, k=256)
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        tuner.tune(alg, pipeline.default_dataflow(alg), validate=False,
                   force=True)


# -- the generator's mesh on the card ------------------------------------

MESH_GPU_CASES = ("gemm", "batched_gemv", "depthwise_conv")


def _mesh_cases(shape):
    from repro_torch.dist.cases import case
    from repro_torch.dist.comm_selftest import SMALL_BOUNDS
    out = [case(f"{name}-{df}", name, SMALL_BOUNDS[name], df, shape)
           for name in MESH_GPU_CASES
           for df in ("identity", "output_stationary", "weight_stationary")]
    sp = (("random", "A", (16, 16), (4, 4), 0.5, 7),)
    out += [case(f"gemm-A-{mode}", "gemm", SMALL_BOUNDS["gemm"],
                 "output_stationary", shape, sparsity=sp, sparse=mode)
            for mode in ("auto", "dense")]
    return out


def _check_mesh_records(recs, cases, device_prefix):
    assert set(recs) == {c.label for c in cases}
    for c in cases:
        rec = recs[c.label]
        alg = c.build_algebra()
        want = alg.reference(c.build_operands(alg))
        np.testing.assert_array_equal(rec["out"], want, err_msg=c.label)
        assert rec["equal_single"] and rec["agree"], c.label
        assert all(d.startswith(device_prefix) for d in rec["devices"])


def test_one_rank_nccl_mesh_on_card(cuda):
    from repro_torch.dist import cases as cases_mod
    from repro_torch.dist import spawn
    cases = _mesh_cases((1, 1))
    with spawn.single_rank(device="cuda"):
        recs = cases_mod.run_cases(cases, "cuda", single=True, repeat=2)
    _check_mesh_records(recs, cases, "cuda")
    assert all(r["repeat_same"] for r in recs.values())


def test_two_gloo_ranks_share_the_card(cuda):
    from repro_torch.dist import cases as cases_mod
    from repro_torch.dist import spawn
    cases = _mesh_cases((1, 2)) + _mesh_cases((2, 1))
    cases = [dataclasses.replace(c, label=f"{c.label}-{c.mesh}")
             for c in cases]
    # run_cases(cases, device, backend, keep_out, repeat, single)
    recs = spawn.run_ranks(cases_mod.run_cases, 2, device="cuda",
                           backend="gloo",
                           args=(cases, "cuda", "gloo", True, 1, True),
                           timeout=300)
    _check_mesh_records(recs, cases, "cuda")


def test_two_gloo_ranks_reshard_a_checkpoint_on_the_card(cuda, tmp_path):
    # a reduced granite state (seeded moments, fp32 and 8-bit) placed on a
    # 1x2 mesh of two ranks sharing the card, saved, and restored onto
    # 2x1: every block bit for bit the checkpoint's, on the card
    from repro_torch.dist import spawn
    from repro_torch.dist import train_cases as tc
    for bits in (32, 8):
        case = tc.TrainCase("reshard", "granite-8b", bits=bits)
        recs = spawn.run_ranks(
            tc.reshard, 2, device="cuda", backend="gloo",
            args=(case, str(tmp_path / str(bits)), (1, 2), (2, 1), "cuda",
                  "gloo"), timeout=300)
        for bad, devices in recs:
            assert bad == [] and all(d.startswith("cuda") for d in devices)


def _like(real, meta):
    """Each meta output has its kernel output's shape and dtype."""
    assert len(real) == len(meta)
    for r, m in zip(real, meta):
        if isinstance(r, torch.Tensor):
            assert m.is_meta and m.shape == r.shape and m.dtype == r.dtype
        else:
            _like(r, m)


def test_meta_branches_give_the_kernels_outputs(cuda):
    # the dry run's meta branches against the kernels' real outputs:
    # flash forward (with the log-sum-exp) and backward, the SSD forward
    # (y, final state, scratch) and backward, the paged gather; each
    # meta call counts one launch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged, ssd_scan

    g = torch.Generator(device=cuda).manual_seed(0)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)

    def meta(xs):
        return [x.to("meta") if isinstance(x, torch.Tensor) else x
                for x in xs]
    bf = torch.bfloat16
    q, k, v = rnd(2, 8, 96, 64, dtype=bf), rnd(2, 2, 96, 64, dtype=bf), \
        rnd(2, 2, 96, 64, dtype=bf)
    real = fa._forward(q, k, v, True, 32, with_lse=True, q_offset=16)
    before = fa.launches["flash_attention"]
    _like(real, fa._forward(*meta((q, k, v)), True, 32, with_lse=True,
                            q_offset=16))
    assert fa.launches["flash_attention"] == before + 1
    dout = rnd(2, 8, 96, 64, dtype=bf)
    bargs = (q, k, v, real[0], dout, real[1])
    _like(fa.flash_attention_backward(*bargs, window=32, q_offset=16),
          fa.flash_attention_backward(*meta(bargs), window=32, q_offset=16))

    x, dt = rnd(2, 128, 8, 16), rnd(2, 128, 8).abs() * 0.1
    a, b, c = -rnd(8).abs(), rnd(2, 128, 2, 32), rnd(2, 128, 2, 32)
    fwd = ssd_scan._forward(x, dt, a, b, c, 32)
    mfwd = ssd_scan._forward(*meta((x, dt, a, b, c)), 32)
    _like(fwd[:3], mfwd[:3])
    dy, dh = rnd(2, 128, 8, 16), rnd(2, 8, 32, 16)
    got = ssd_scan._backward(*fwd[3], dy, dh, fwd[2], 32)
    before = ssd_scan.launches["ssd_scan_backward"]
    _like(got, ssd_scan._backward(*meta(mfwd[3]), *meta((dy, dh, mfwd[2])),
                                  32))
    assert ssd_scan.launches["ssd_scan_backward"] == before + 1

    pool = rnd(9, 16, 64, dtype=bf)
    table = torch.randint(0, 9, (3, 4), generator=g, device=cuda,
                          dtype=torch.int32)
    _like([paged.paged_gather(pool, table)],
          [paged.paged_gather(*meta((pool, table)))])
