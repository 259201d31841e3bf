"""The port's training slice against the reference, on the CPU: AdamW
(fp32 and 8-bit state), the data pipeline, cross-entropy, the flash and
SSD backwards' plain versions and autograd ``Function``s (and their
routing on the card), the train step on a reduced model of every family
the reference trains (dense h2o-danube-1.8b and granite-8b, ssm
mamba2-370m, hybrid zamba2-1.2b, moe mixtral-8x22b, encdec whisper-small
and vlm llama-3.2-vision-11b, the last two with ``TrainDriver``'s frontend
stub) started from one state, remat, gradient coverage, and the kernel
wrappers without a backward, which raise under autograd.

Tolerances: the pipeline's batches and the 8-bit codes exactly (pure
numpy / the same fp32 ops on the same numbers, ``round`` half to even in
both); AdamW on the same parameters and gradients within 1e-6 x max|.|;
the flash backward within 1e-5 x max|.| (fp32; sum orders differ); the
SSD backward's plain version within 1e-10 x max|.| of autograd in
float64 and 1e-4 x max|.| of ``jax.grad`` in fp32;
losses within 1e-5 x |loss|, gradients within 1e-4 x max|g| and
parameters after 3 steps within 1e-5 x max|p| per leaf (XLA and PyTorch
sum in other orders).  The train-step parity runs AdamW's default lr
(3e-4): Adam divides by ``sqrt(v) + eps``, so a gradient near ``eps``
turns a last-bit gradient difference into an update difference of about
``lr * |dg| / eps``, which grows with lr (at lr 1e-2 the same two
packages differ by 6e-5 x max|p| after 3 steps).  The test checks that
the parameters moved by far more than the tolerance.  For the families
after the dense ones the parameters are held to the larger of 1e-5 x
max|p| and ``UPDATE_TOL`` x the summed lr of the 3 steps: Adam moves an
element by at most about lr a step, so the bound allows 2% of the
largest move (the five families read at most 0.7% of it, zamba2-1.2b's
1.17e-5 x max|p| the largest).  Fed the reference's gradients, the two
AdamWs agree within 1e-6 x max|p| on zamba2-1.2b
(``test_adamw_fed_the_references_gradients_matches_it``): the drift is
last-bit gradient differences amplified by eps, not a fault.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.kernels import ref as ref_kernels  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.train import trainer as ref_trainer  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

#: the dense cases, held to 1e-5 x max|p| after 3 steps
ARCHS = ["h2o-danube-1.8b", "granite-8b"]
#: every other family the reference trains, held to the update-scaled
#: bound (module docstring)
FAMILY_ARCHS = ["mamba2-370m", "zamba2-1.2b", "mixtral-8x22b",
                "whisper-small", "llama-3.2-vision-11b"]
UPDATE_TOL = 2e-2


def randn(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def leaves(tree, prefix=""):
    """(path, leaf) of a nested dict in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _tree(seed):
    return {"w": randn(3, 130, seed=seed),
            "nest": {"b": randn(7, seed=seed + 1, scale=0.1)}}


@pytest.mark.parametrize("bits", [32, 8])
@pytest.mark.parametrize("clip", [1.0, None, 1e-3])
def test_adamw_matches_reference_over_three_steps(bits, clip):
    cfg = dict(lr=0.05, warmup_steps=2, total_steps=5, clip_norm=clip,
               state_bits=bits)
    rcfg, pcfg = ref_adamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    rp = jax.tree.map(jnp.asarray, _tree(0))
    pp = jax.tree.map(torch.as_tensor, _tree(0))
    rs, ps = ref_adamw.init(rp, rcfg), adamw.init(pp, pcfg)
    for i in range(3):
        g = _tree(10 + i)
        rp, rs, rm = ref_adamw.apply_updates(
            rp, jax.tree.map(jnp.asarray, g), rs, rcfg)
        pp, ps, pm = adamw.apply_updates(
            pp, jax.tree.map(torch.as_tensor, g), ps, pcfg)
        assert rel(pm["grad_norm"], rm["grad_norm"]) <= 1e-6
        assert rel(pm["lr"], rm["lr"]) <= 1e-6
        assert int(ps.step) == int(rs.step) == i + 1
    for (path, got), (_, want) in zip(leaves(pp), leaves(
            jax.tree.map(np.asarray, rp))):
        assert rel(got, want) <= 1e-6, path
    is_q8 = lambda x: isinstance(x, ref_adamw.Q8)  # noqa: E731
    for rm_, pm_ in ((rs.m, ps.m), (rs.v, ps.v)):
        rl = jax.tree.leaves(rm_, is_leaf=is_q8)
        pl = [x for _, x in leaves(pm_)]
        for r, p in zip(rl, pl):
            if bits == 8:
                assert p.shape == tuple(r.shape)
                np.testing.assert_array_equal(p.q.numpy(), np.asarray(r.q))
                assert rel(p.scale, r.scale) <= 1e-6
            else:
                assert rel(p, r) <= 1e-6


def test_q8_codec_matches_reference_bit_for_bit():
    # values on the half-way points of the code grid exercise the
    # half-to-even rounding of both packages
    x = randn(5, 77, seed=3)
    x[0, :5] = [0.5, 1.5, -2.5, 127.0, -127.0]
    rq, rs = ref_adamw._q8_encode(jnp.asarray(x))
    pq, ps = adamw._q8_encode(torch.as_tensor(x))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(
        adamw._q8_decode(pq, ps, x.shape).numpy(),
        np.asarray(ref_adamw._q8_decode(rq, rs, x.shape)))


@pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 5000, 10_000, 20_000])
def test_schedule_matches_reference(step):
    cfg = dict(lr=3e-4, warmup_steps=100, total_steps=10_000)
    want = ref_adamw.schedule(ref_adamw.AdamWConfig(**cfg),
                              jnp.asarray(step, jnp.int32))
    got = adamw.schedule(adamw.AdamWConfig(**cfg),
                         torch.tensor(step, dtype=torch.int32))
    assert rel(got, want) <= 1e-6


def test_adamw_converges_on_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1,
                            total_steps=200)
    params = {"w": torch.tensor([1.0, -2.0, 3.0]),
              "b": torch.tensor([0.5])}
    state = adamw.init(params, cfg)
    for _ in range(200):
        grads = adamw.tree_map(lambda p: 2 * p, params)
        params, state, _ = adamw.apply_updates(params, grads, state, cfg)
    assert sum(float((p ** 2).sum()) for p in params.values()) < 1e-2


def test_adamw_writes_new_tensors_under_no_grad():
    cfg = adamw.AdamWConfig()
    p = {"w": torch.ones(4, requires_grad=True)}
    new, _, _ = adamw.apply_updates(p, {"w": torch.ones(4)},
                                    adamw.init(p, cfg), cfg)
    assert new["w"] is not p["w"] and not new["w"].requires_grad
    assert torch.equal(p["w"].detach(), torch.ones(4))


def test_8bit_state_is_a_quarter_of_fp32():
    params = {"w": torch.zeros(1024, 512)}
    s8 = adamw.init(params, adamw.AdamWConfig(state_bits=8))
    s32 = adamw.init(params, adamw.AdamWConfig(state_bits=32))
    b8 = s8.m["w"].q.numel() + 4 * s8.m["w"].scale.numel()
    b32 = 4 * s32.m["w"].numel()
    assert b8 < b32 / 3.5


# ---------------------------------------------------------------------------
# data and loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(seed=3, noise=0.3),
                                dict(n_shards=2, shard=1)])
@pytest.mark.parametrize("step", [0, 7])
def test_batches_equal_reference_bit_for_bit(kw, step):
    cfg = dict(vocab=97, seq_len=33, global_batch=4, **kw)
    want = ref_pipeline._batch_numpy(ref_pipeline.DataConfig(**cfg), step)
    got = pipeline._batch_numpy(pipeline.DataConfig(**cfg), step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(
        pipeline.frontend_stub(2, 5, 8, step=step, seed=1),
        ref_pipeline.frontend_stub(2, 5, 8, step=step, seed=1))


def test_pipeline_restart_replays_the_stream():
    cfg = pipeline.DataConfig(vocab=50, seq_len=8, global_batch=2)
    a = pipeline.SyntheticPipeline(cfg)
    first = [a.next() for _ in range(3)]
    b = pipeline.SyntheticPipeline(cfg)
    b.restore({"step": 1})
    np.testing.assert_array_equal(b.next()["tokens"], first[1]["tokens"])
    np.testing.assert_array_equal(first[0]["targets"][:, :-1],
                                  first[0]["tokens"][:, 1:])


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    logits = randn(3, 5, 11, seed=4, scale=3.0)
    targets = np.random.default_rng(5).integers(0, 11, (3, 5)).astype(
        np.int32)
    mask = (np.random.default_rng(6).random((3, 5)) < 0.6).astype(
        np.float32) if masked else None
    want = ref_common.cross_entropy(
        jnp.asarray(logits), jnp.asarray(targets),
        None if mask is None else jnp.asarray(mask))
    got = common.cross_entropy(
        torch.as_tensor(logits), torch.as_tensor(targets),
        None if mask is None else torch.as_tensor(mask))
    assert rel(got, want) <= 1e-6


# ---------------------------------------------------------------------------
# the flash backward's plain version and Function
# ---------------------------------------------------------------------------

#: (B, Hq, Hkv, Lq, Lkv, D, causal, window): causal, window, GQA, and a
#: ragged non-causal (cross) shape
FLASH_CASES = [
    (2, 4, 4, 40, 40, 16, True, None),
    (1, 4, 2, 70, 70, 16, True, 24),
    (1, 6, 2, 130, 130, 32, True, None),
    (2, 4, 1, 9, 75, 16, False, None),
]


def _flash_inputs(case, seed=0):
    b, hq, hkv, lq, lkv, d, _, _ = case
    return (randn(b, hq, lq, d, seed=seed), randn(b, hkv, lkv, d,
                                                    seed=seed + 1),
            randn(b, hkv, lkv, d, seed=seed + 2),
            randn(b, hq, lq, d, seed=seed + 3))


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_backward_plain_matches_autograd_and_jax_grad(case):
    causal, window = case[6], case[7]
    q, k, v, g = _flash_inputs(case)
    qt, kt, vt = (torch.as_tensor(x).requires_grad_() for x in (q, k, v))
    out = fa.flash_attention_plain(qt, kt, vt, causal=causal,
                                   window=window)
    auto = torch.autograd.grad(out, (qt, kt, vt), torch.as_tensor(g))
    out2, lse = fa.flash_attention_plain(
        *(torch.as_tensor(x) for x in (q, k, v)), causal=causal,
        window=window, return_lse=True)
    plain = fa.flash_attention_backward_plain(
        *(torch.as_tensor(x) for x in (q, k, v)), out2, torch.as_tensor(g),
        lse, causal=causal, window=window)

    def f(q_, k_, v_):
        return jnp.sum(ref_kernels.attention_ref(
            q_, k_, v_, causal=causal, window=window) * g)
    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                            for x in (q, k, v)))
    for got_p, got_a, w in zip(plain, auto, want):
        assert got_p.shape == tuple(w.shape)
        assert rel(got_p, w) <= 1e-5
        assert rel(got_a, w) <= 1e-5


def test_flash_lse_is_the_rows_log_sum_exp():
    case = FLASH_CASES[1]
    q, k, v, _ = (torch.as_tensor(x) for x in _flash_inputs(case))
    _, lse = fa.flash_attention_plain(q, k, v, causal=True, window=24,
                                      return_lse=True)
    kf = k.repeat_interleave(2, dim=1)
    s = torch.matmul(q, kf.transpose(-1, -2)) / 4.0
    mask = fa._mask(70, 0, 70, True, 24, "cpu")
    want = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
    assert rel(lse, want) <= 1e-6


def test_flash_lse_of_a_row_that_sees_nothing_is_inf():
    # two keys, causal, window 2: row 1 sees both, row 3 sees neither
    q = torch.randn(1, 1, 4, 16)
    k, v = torch.randn(1, 1, 2, 16), torch.randn(1, 1, 2, 16)
    out, lse = fa.flash_attention_plain(q, k, v, causal=True, window=2,
                                        return_lse=True)
    assert torch.isfinite(lse[0, 0, :3]).all() and torch.isinf(lse[0, 0, 3])
    assert (out[0, 0, 3] == 0).all()
    dq, dk, dv = fa.flash_attention_backward_plain(
        q, k, v, out, torch.randn_like(out), lse, causal=True, window=2)
    assert (dq[0, 0, 3] == 0).all() and dq[0, 0, 1].abs().max() > 0
    assert dk.abs().max() > 0 and dv.abs().max() > 0


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_function_gradients_on_the_cpu_route(case):
    causal, window = case[6], case[7]
    q, k, v, g = _flash_inputs(case, seed=9)
    qt, kt, vt = (torch.as_tensor(x).requires_grad_() for x in (q, k, v))
    out = fa.FlashAttentionFn.apply(qt, kt, vt, causal, window)
    got = torch.autograd.grad(out, (qt, kt, vt), torch.as_tensor(g))
    q2, k2, v2 = (torch.as_tensor(x).requires_grad_() for x in (q, k, v))
    want = torch.autograd.grad(
        fa.flash_attention_plain(q2, k2, v2, causal=causal, window=window),
        (q2, k2, v2), torch.as_tensor(g))
    torch.testing.assert_close(out, fa.flash_attention_plain(
        *(torch.as_tensor(x) for x in (q, k, v)), causal=causal,
        window=window))
    for a, b in zip(got, want):
        assert rel(a, b) <= 1e-5


def test_flash_routes_through_the_function_only_on_the_card(monkeypatch):
    # a CPU tensor is differentiated by autograd through the plain
    # version; a CUDA tensor under grad goes through the Function
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    out = fa.flash_attention(q, q, q)
    assert "FlashAttentionFn" not in type(out.grad_fn).__name__
    calls = []
    monkeypatch.setattr(fa, "_on_cpu", lambda *xs: False)
    monkeypatch.setattr(fa.FlashAttentionFn, "apply",
                        lambda *a: calls.append(a) or a[0])
    monkeypatch.setattr(fa, "_forward",
                        lambda *a, **k: calls.append("forward") or (a[0],
                                                                     None))
    fa.flash_attention(q, q, q)
    with torch.no_grad():
        fa.flash_attention(q, q, q)
    fa.flash_attention(q.detach(), q.detach(), q.detach())
    assert len(calls) == 3 and calls[1:] == ["forward", "forward"]
    assert calls[0][3:] == (True, None)


# ---------------------------------------------------------------------------
# the SSD backward's plain version and Function
# ---------------------------------------------------------------------------

#: (B, L, H, G, N, P, chunk): several chunks, groups of 2 heads, a ragged
#: chunk, one chunk, and G = H
SSD_CASES = [
    (2, 24, 4, 1, 6, 8, 8),
    (2, 32, 4, 2, 16, 5, 16),
    (1, 74, 3, 1, 4, 5, 37),
    (1, 16, 2, 2, 5, 3, 16),
]


def _ssd_inputs(case, seed=0, dtype=np.float32):
    b, l, h, g, n, p, _ = case
    rng = np.random.default_rng(seed)
    return [v.astype(dtype) for v in (
        rng.standard_normal((b, l, h, p)), 0.1 + 0.9 * rng.random((b, l, h)),
        -0.5 - rng.random(h), rng.standard_normal((b, l, g, n)),
        rng.standard_normal((b, l, g, n)), rng.standard_normal((b, l, h, p)),
        rng.standard_normal((b, h, n, p)))]


@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_backward_plain_matches_autograd_in_float64(case, final):
    from repro_torch.kernels import ref, ssd_scan
    x, dt, a, b, c, dy, dh = (torch.as_tensor(v) for v in _ssd_inputs(
        case, seed=sum(case), dtype=np.float64))
    ins = [t.clone().requires_grad_() for t in (x, dt, a, b, c)]
    y, h_fin = ref.ssd_chunked_ref(*ins, chunk=case[-1])
    loss = (y * dy).sum() + ((h_fin * dh).sum() if final else 0.0)
    want = torch.autograd.grad(loss, ins)
    got = ssd_scan.ssd_scan_backward_plain(x, dt, a, b, c, dy,
                                           dh if final else None,
                                           chunk=case[-1])
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape
        assert rel(g, w) <= 1e-10


@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_backward_plain_matches_jax_grad(case, final):
    from repro_torch.kernels import ssd_scan
    x, dt, a, b, c, dy, dh = _ssd_inputs(case, seed=2 * sum(case))

    def f(*ins):
        y, h_fin = ref_kernels.ssd_chunked_ref(*ins, chunk=case[-1])
        return jnp.sum(y * dy) + (jnp.sum(h_fin * dh) if final else 0.0)
    want = jax.grad(f, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(v) for v in (x, dt, a, b, c)))
    got = ssd_scan.ssd_scan_backward_plain(
        *(torch.as_tensor(v) for v in (x, dt, a, b, c, dy)),
        torch.as_tensor(dh) if final else None, chunk=case[-1])
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == tuple(w.shape)
        assert rel(g, w) <= 1e-4


@pytest.mark.parametrize("case", SSD_CASES[:3])
def test_ssd_function_gradients_on_the_cpu_route(case):
    from repro_torch.kernels import ref, ssd_scan
    x, dt, a, b, c, dy, dh = (torch.as_tensor(v) for v in _ssd_inputs(
        case, seed=5))
    ins = [t.clone().requires_grad_() for t in (x, dt, a, b, c)]
    y, h_fin = ssd_scan.SSDScanFn.apply(*ins, case[-1])
    got = torch.autograd.grad((y * dy).sum() + (h_fin * dh).sum(), ins)
    ins2 = [t.clone().requires_grad_() for t in (x, dt, a, b, c)]
    y2, h2 = ref.ssd_chunked_ref(*ins2, chunk=case[-1])
    want = torch.autograd.grad((y2 * dy).sum() + (h2 * dh).sum(), ins2)
    torch.testing.assert_close(y, y2, rtol=0, atol=0)
    torch.testing.assert_close(h_fin, h2, rtol=0, atol=0)
    for g, w in zip(got, want):
        assert rel(g, w) <= 1e-5
    # only y, or only the final state, reaches the loss: the other's
    # gradient is None (zero)
    for pick in (lambda y_, h_: (y_ * dy).sum(),
                 lambda y_, h_: (h_ * dh).sum()):
        got = torch.autograd.grad(
            pick(*ssd_scan.SSDScanFn.apply(*ins, case[-1])), ins)
        want = torch.autograd.grad(
            pick(*ref.ssd_chunked_ref(*ins2, chunk=case[-1])), ins2,
            allow_unused=True)     # C does not reach the final state
        for g, w in zip(got, want):
            if w is None:
                assert not g.abs().max() > 0
            else:
                assert rel(g, w) <= 1e-5


def test_ssd_routes_through_the_function_only_on_the_card(monkeypatch):
    # a CPU tensor is differentiated by autograd through the plain
    # version; a CUDA tensor under grad goes through the Function, and
    # without grad (or with no input requiring it) straight to the kernels
    from repro_torch.kernels import ssd_scan
    x, dt, a, b, c, _, _ = (torch.as_tensor(v) for v in _ssd_inputs(
        SSD_CASES[0]))
    xg = x.clone().requires_grad_()
    y, _ = ssd_scan.ssd_scan(xg, dt, a, b, c, chunk=8)
    assert "SSDScanFn" not in type(y.grad_fn).__name__
    calls = []
    monkeypatch.setattr(ssd_scan, "_on_cpu", lambda *xs: False)
    monkeypatch.setattr(ssd_scan.SSDScanFn, "apply",
                        lambda *args: calls.append(args) or (args[0], None))
    monkeypatch.setattr(ssd_scan, "_forward", lambda *args: calls.append(
        "forward") or (args[0], None, None, None))
    ssd_scan.ssd_scan(xg, dt, a, b, c, chunk=8)
    with torch.no_grad():
        ssd_scan.ssd_scan(xg, dt, a, b, c, chunk=8)
    ssd_scan.ssd_scan(x, dt, a, b, c, chunk=8)
    assert len(calls) == 3 and calls[1:] == ["forward", "forward"]
    assert calls[0][0] is xg and calls[0][5] == 8


def test_ssm_training_on_the_card_runs_the_ssd_function(monkeypatch):
    # a reduced mamba2 trains through SSDScanFn on a card whose kernels
    # are stood in for by the plain versions: one forward per layer and
    # step, one backward per layer, and the step equals the CPU's
    from repro_torch.kernels import ref, ssd_scan
    from repro_torch.models import transformer
    cfg = get_config("mamba2-370m").reduced()
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    batch = {k: torch.as_tensor(v) for k, v in pipeline._batch_numpy(
        pipeline.DataConfig(vocab=cfg.vocab, seq_len=20, global_batch=2),
        0).items()}
    want = trainer.value_and_grad(params, batch, cfg)
    calls = []

    def forward(x, dt, a, b, c, chunk):
        calls.append("forward")
        y, state = ref.ssd_chunked_ref(x, dt, a, b, c, chunk=chunk)
        return y, state, torch.zeros(1), ssd_scan._operands(x, dt, a, b, c)

    def backward(x, dt, a, b, c, dy, dh_final, scratch, chunk):
        calls.append("backward")
        assert dh_final is None and scratch.shape == (1,)
        return ssd_scan.ssd_scan_backward_plain(x, dt, a, b, c, dy, None,
                                                chunk=chunk)
    monkeypatch.setattr(ssd_scan, "_on_cpu", lambda *xs: False)
    monkeypatch.setattr(ssd_scan, "_forward", forward)
    monkeypatch.setattr(ssd_scan, "_backward", backward)
    got = trainer.value_and_grad(params, batch, cfg)
    assert calls == ["forward"] * cfg.n_layers + ["backward"] * cfg.n_layers
    assert abs(float(got[0]) - float(want[0])) <= 1e-6 * abs(float(want[0]))
    for (path, g), (_, w) in zip(leaves(got[2]), leaves(want[2])):
        assert rel(g, w) <= 1e-5, path


# ---------------------------------------------------------------------------
# kernels without a backward refuse autograd on the card
# ---------------------------------------------------------------------------

def _card(monkeypatch, module):
    """``module`` sees CUDA tensors whose library is never reached."""
    from repro_torch.kernels import _build

    def no_library(stem):
        raise AssertionError("the guard must raise before a launch")
    monkeypatch.setattr(_build, "library", no_library)
    monkeypatch.setattr(module, "_on_cpu", lambda *xs: False)


def _guard_cases():
    from repro_torch.kernels import bsr_gemm, fused_chain, paged, stt_gemm
    a = torch.ones(16, 16)
    return {
        "paged_gather": (paged, lambda x: paged.paged_gather(
            x, torch.zeros(2, 2, dtype=torch.int32)), torch.ones(3, 2, 4)),
        "output_stationary": (stt_gemm, lambda x: (
            stt_gemm.matmul_output_stationary(x, a, bm=16, bn=16, bk=16)),
            a),
        "operand_stationary": (stt_gemm, lambda x: (
            stt_gemm.matmul_operand_stationary(x, a, bm=16, bn=16, bk=16)),
            a),
        "reduction_tree": (stt_gemm, lambda x: (
            stt_gemm.matmul_reduction_tree(x, a, bm=16, bn=16)), a),
        "bsr": (bsr_gemm, lambda x: bsr_gemm.bsr_matmul(
            x, a, coords=((0, 0),), bm=16, bk=16, bn=16), a),
        "fused_chain": (fused_chain, lambda x: fused_chain.fused_chain_matmul(
            x[:4, :8], [torch.ones(8, 6)],
            stages=[fused_chain.ChainStage(8, 6)]), a),
        "fused_dag": (fused_chain, lambda x: fused_chain.fused_dag(
            [x[:4, :8], torch.ones(8, 6)],
            stages=[fused_chain.DagStage(4, 8, 6, rhs=("ext", 1))]), a),
    }


@pytest.mark.parametrize("name", ["paged_gather",
                                  "output_stationary", "operand_stationary",
                                  "reduction_tree", "bsr", "fused_chain",
                                  "fused_dag"])
def test_kernels_without_a_backward_raise_under_autograd(monkeypatch, name):
    module, call, x = _guard_cases()[name]
    _card(monkeypatch, module)
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        call(x.clone().requires_grad_())


# ---------------------------------------------------------------------------
# the train step against the reference
# ---------------------------------------------------------------------------

def _open_gates(params):
    """The vlm's cross gates at 0.5: they start at 0, where the image
    changes no logit and the cross layers get no gradient."""
    if "cross_layers" in params:
        cross = dict(params["cross_layers"])
        cross["gate"] = cross["gate"] * 0 + 0.5
        params = {**params, "cross_layers": cross}
    return params


def _states(name, opt_kw):
    rcfg, cfg = ref_config(name).reduced(), get_config(name).reduced()
    rstate, _ = ref_trainer.init_state(
        jax.random.PRNGKey(0), rcfg, ref_adamw.AdamWConfig(**opt_kw))
    rstate = rstate._replace(params=_open_gates(rstate.params))
    pstate = convert.train_state_from_reference(
        jax.tree.map(np.asarray, rstate), device="cpu")
    return rcfg, cfg, rstate, pstate


def _batch(cfg, step, seq=32, batch=4):
    """The synthetic batch of ``step``; encdec and vlm also get the
    ``TrainDriver``'s frontend stub (audio frames / image patches)."""
    out = pipeline._batch_numpy(pipeline.DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch), step)
    if cfg.family in ("encdec", "vlm"):
        out["frontend"] = pipeline.frontend_stub(
            batch, cfg.frontend_tokens, cfg.d_model, step=0, seed=0)
    return out


@pytest.mark.parametrize("name", ARCHS + FAMILY_ARCHS)
def test_train_step_matches_reference_over_three_steps(name):
    opt_kw = dict(warmup_steps=2, total_steps=10)
    rcfg, cfg, rstate, pstate = _states(name, opt_kw)
    start = {p: x.clone() for p, x in leaves(pstate.params)}
    rstep = jax.jit(ref_trainer.make_train_step(
        rcfg, ref_adamw.AdamWConfig(**opt_kw)))
    pstep = trainer.make_train_step(cfg, adamw.AdamWConfig(**opt_kw))
    rgrad = jax.jit(jax.value_and_grad(ref_trainer.loss_fn, has_aux=True),
                    static_argnums=2)
    lr_sum = 0.0
    for i in range(3):
        b = _batch(cfg, i)
        rb = {k: jnp.asarray(v) for k, v in b.items()}
        pb = {k: torch.as_tensor(v) for k, v in b.items()}
        (rloss, _), rgrads = rgrad(rstate.params, rb, rcfg)
        ploss, _, pgrads = trainer.value_and_grad(pstate.params, pb, cfg)
        assert abs(float(ploss) - float(rloss)) <= 1e-5 * abs(float(rloss))
        for (path, g), (_, w) in zip(leaves(pgrads), leaves(
                jax.tree.map(np.asarray, rgrads))):
            assert rel(g, w) <= 1e-4, (i, path)
        rstate, rm = rstep(rstate, rb)
        pstate, pm = pstep(pstate, pb)
        assert abs(float(pm["loss"]) - float(rm["loss"])) <= 1e-5 * abs(
            float(rm["loss"]))
        assert rel(pm["grad_norm"], rm["grad_norm"]) <= 1e-5
        lr_sum += float(pm["lr"])
    for (path, p), (_, w) in zip(leaves(pstate.params), leaves(
            jax.tree.map(np.asarray, rstate.params))):
        scale = np.abs(w).max()
        tol = 1e-5 * scale if name in ARCHS else max(1e-5 * scale,
                                                      UPDATE_TOL * lr_sum)
        assert np.abs(p.numpy() - w).max() <= tol, path
        moved = (p - start[path]).abs().max().item()
        assert moved > 10 * 1e-5 * scale, path


def test_adamw_fed_the_references_gradients_matches_it():
    # the zamba2 drift is Adam's eps at work, not a gradient fault: the
    # same gradients through both optimizers give the same parameters
    opt_kw = dict(warmup_steps=2, total_steps=10)
    rcfg, cfg, rstate, pstate = _states("zamba2-1.2b", opt_kw)
    rparams, ropt = rstate.params, rstate.opt
    params, opt = pstate.params, pstate.opt
    for i in range(3):
        rb = {k: jnp.asarray(v) for k, v in _batch(cfg, i).items()}
        (_, _), rgrads = jax.value_and_grad(
            ref_trainer.loss_fn, has_aux=True)(rparams, rb, rcfg)
        rparams, ropt, _ = ref_adamw.apply_updates(
            rparams, rgrads, ropt, ref_adamw.AdamWConfig(**opt_kw))
        params, opt, _ = adamw.apply_updates(
            params, jax.tree.map(lambda g: torch.as_tensor(np.asarray(g)),
                                 rgrads), opt, adamw.AdamWConfig(**opt_kw))
    for (path, p), (_, w) in zip(leaves(params), leaves(
            jax.tree.map(np.asarray, rparams))):
        assert rel(p, w) <= 1e-6, path


@pytest.mark.parametrize("name", ARCHS + FAMILY_ARCHS)
def test_remat_gives_the_same_loss_and_gradients(name):
    import dataclasses
    cfg = get_config(name).reduced()
    params = convert.params_from_reference(jax.tree.map(
        np.asarray, _open_gates(ref_trainer.init_state(
            jax.random.PRNGKey(1), ref_config(name).reduced(),
            ref_adamw.AdamWConfig())[0].params)), device="cpu")
    b = {k: torch.as_tensor(v) for k, v in _batch(cfg, 0).items()}
    off = trainer.value_and_grad(params, b, cfg)
    on = trainer.value_and_grad(params, b,
                                dataclasses.replace(cfg, remat=True))
    assert float(on[0]) == float(off[0])
    for (path, g), (_, w) in zip(leaves(on[2]), leaves(off[2])):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6 * max(
            w.abs().max().item(), 1e-30), msg=path)


def test_hybrid_shared_block_gradient_sums_its_six_applications():
    # zamba2-1.2b applies its one shared attention+MLP block 6 times (38
    # layers, one after every 6th): at reduced width with 6 layers and a
    # block after each, the shared leaves' gradients (summed over the 6
    # applications by autograd) equal jax.grad's
    import dataclasses
    over = dict(n_layers=6, attn_every=1)
    rcfg = dataclasses.replace(ref_config("zamba2-1.2b").reduced(), **over)
    cfg = dataclasses.replace(get_config("zamba2-1.2b").reduced(), **over)
    assert cfg.n_layers // cfg.attn_every == 6
    rparams = ref_trainer.init_state(jax.random.PRNGKey(3), rcfg,
                                     ref_adamw.AdamWConfig())[0].params
    params = convert.params_from_reference(
        jax.tree.map(np.asarray, rparams), device="cpu")
    b = _batch(cfg, 0)
    (rloss, _), rgrads = jax.jit(jax.value_and_grad(
        ref_trainer.loss_fn, has_aux=True), static_argnums=2)(
        rparams, {k: jnp.asarray(v) for k, v in b.items()}, rcfg)
    loss, _, grads = trainer.value_and_grad(
        params, {k: torch.as_tensor(v) for k, v in b.items()}, cfg)
    assert abs(float(loss) - float(rloss)) <= 1e-5 * abs(float(rloss))
    shared = 0
    for (path, g), (_, w) in zip(leaves(grads), leaves(
            jax.tree.map(np.asarray, rgrads))):
        assert rel(g, w) <= 1e-4, path
        shared += path.startswith("/shared/")
    assert shared > 0


def test_remat_checkpoints_each_layer_only_under_autograd(monkeypatch):
    import dataclasses

    from repro_torch.models import transformer
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b").reduced(),
                              remat=True)
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    calls = []
    real = transformer.checkpoint
    monkeypatch.setattr(transformer, "checkpoint",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    tokens = torch.zeros(1, 8, dtype=torch.long)
    with torch.no_grad():
        transformer.forward(params, tokens, cfg)
    assert calls == []
    transformer.forward(params, tokens, cfg)
    assert len(calls) == cfg.n_layers
    assert all(k["use_reentrant"] is False for k in calls)


@pytest.mark.parametrize("name", ARCHS + FAMILY_ARCHS)
def test_every_parameter_leaf_gets_a_gradient(name):
    cfg = get_config(name).reduced()
    from repro_torch.models import transformer
    params = _open_gates(transformer.init_params(
        torch.Generator().manual_seed(2), cfg))
    b = {k: torch.as_tensor(v) for k, v in _batch(cfg, 0).items()}
    _, _, grads = trainer.value_and_grad(params, b, cfg)
    flat_p, flat_g = dict(leaves(params)), dict(leaves(grads))
    assert flat_p.keys() == flat_g.keys()
    for path, g in flat_g.items():
        assert g.shape == flat_p[path].shape, path
        assert torch.isfinite(g).all() and g.abs().max() > 0, path


def test_sharded_train_step_raises_naming_the_mesh_slice():
    # the model-mesh slice has arrived: the three run.  On a 1x1 mesh (a
    # one-rank gloo world in this process) the specs name every axis
    # whole and the sharded step gives the one-device step's numbers
    # (tests/test_torch_train_mesh.py holds it on 8 ranks)
    from repro_torch.dist import spawn
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer
    cfg = get_config("h2o-danube-1.8b").reduced()
    opt = adamw.AdamWConfig(warmup_steps=2, total_steps=10)
    state = trainer.init_state(torch.Generator().manual_seed(0), cfg, opt)
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg, 0).items()}
    want, wm = trainer.make_train_step(cfg, opt)(state, batch)
    with spawn.single_rank(device="cpu"):
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        axes = transformer.param_axes(cfg)
        st_sh = trainer.state_shardings(state, axes, mesh)
        assert str(st_sh.params["embed"]) == "PartitionSpec('model', 'data')"
        assert trainer.batch_shardings(mesh) == {
            "tokens": ("data", None), "targets": ("data", None)}
        step, st_sh2, b_sh = trainer.make_sharded_train_step(
            cfg, opt, mesh, state, axes, donate=False)
        assert st_sh2 == st_sh and "frontend" not in b_sh
        placed = trainer.place_state(state, st_sh, mesh)
        placed, m = step(placed, batch)
        got = trainer.gather_state(placed, st_sh, mesh)
    for k in ("loss", "ce", "aux", "grad_norm", "lr"):
        assert rel(m[k], wm[k].numpy()) <= 1e-6, k
    for (path, p), (_, w) in zip(leaves(got.params), leaves(want.params)):
        assert rel(p, w.numpy()) <= 1e-6, path
    assert int(got.opt.step) == 1
