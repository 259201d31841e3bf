"""The port's training slice against the reference, on the CPU: AdamW
(fp32 and 8-bit state), the data pipeline, cross-entropy, the flash
backward's plain version and autograd ``Function``, the train step on
reduced h2o-danube-1.8b and granite-8b started from one state, remat,
gradient coverage, and the kernel wrappers without a backward, which
raise under autograd.

Tolerances: the pipeline's batches and the 8-bit codes exactly (pure
numpy / the same fp32 ops on the same numbers, ``round`` half to even in
both); AdamW on the same parameters and gradients within 1e-6 x max|.|;
the flash backward within 1e-5 x max|.| (fp32; sum orders differ);
losses within 1e-5 x |loss|, gradients within 1e-4 x max|g| and
parameters after 3 steps within 1e-5 x max|p| per leaf (XLA and PyTorch
sum in other orders).  The train-step parity runs AdamW's default lr
(3e-4): Adam divides by ``sqrt(v) + eps``, so a gradient near ``eps``
turns a last-bit gradient difference into an update difference of about
``lr * |dg| / eps``, which grows with lr (at lr 1e-2 the same two
packages differ by 6e-5 x max|p| after 3 steps).  The test checks that
the parameters moved by far more than the tolerance.
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

ARCHS = ["h2o-danube-1.8b", "granite-8b"]


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
    from repro_torch.kernels import (bsr_gemm, fused_chain, paged, ssd_scan,
                                     stt_gemm)
    a = torch.ones(16, 16)
    return {
        "ssd_scan": (ssd_scan, lambda x: ssd_scan.ssd_scan(
            x.reshape(1, 16, 2, 8), torch.ones(1, 16, 2), -torch.ones(2),
            torch.ones(1, 16, 1, 4), torch.ones(1, 16, 1, 4), chunk=8),
            torch.ones(1, 16, 2, 8)),
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


@pytest.mark.parametrize("name", ["ssd_scan", "paged_gather",
                                  "output_stationary", "operand_stationary",
                                  "reduction_tree", "bsr", "fused_chain",
                                  "fused_dag"])
def test_kernels_without_a_backward_raise_under_autograd(monkeypatch, name):
    module, call, x = _guard_cases()[name]
    _card(monkeypatch, module)
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        call(x.clone().requires_grad_())


def test_ssm_training_on_the_card_fails_in_its_first_forward(monkeypatch):
    from repro_torch.kernels import ssd_scan
    from repro_torch.models import transformer
    cfg = get_config("mamba2-370m").reduced()
    _card(monkeypatch, ssd_scan)
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    state = trainer.TrainState(params, adamw.init(params,
                                                  adamw.AdamWConfig()))
    batch = {k: torch.as_tensor(v) for k, v in pipeline._batch_numpy(
        pipeline.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2),
        0).items()}
    step = trainer.make_train_step(cfg, adamw.AdamWConfig())
    with pytest.raises(NotImplementedError, match="SSD backward"):
        step(state, batch)


# ---------------------------------------------------------------------------
# the train step against the reference
# ---------------------------------------------------------------------------

def _states(name, opt_kw):
    rcfg, cfg = ref_config(name).reduced(), get_config(name).reduced()
    rstate, _ = ref_trainer.init_state(
        jax.random.PRNGKey(0), rcfg, ref_adamw.AdamWConfig(**opt_kw))
    pstate = convert.train_state_from_reference(
        jax.tree.map(np.asarray, rstate), device="cpu")
    return rcfg, cfg, rstate, pstate


def _batch(cfg, step, seq=32, batch=4):
    return pipeline._batch_numpy(pipeline.DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch), step)


@pytest.mark.parametrize("name", ARCHS)
def test_train_step_matches_reference_over_three_steps(name):
    opt_kw = dict(warmup_steps=2, total_steps=10)
    rcfg, cfg, rstate, pstate = _states(name, opt_kw)
    start = {p: x.clone() for p, x in leaves(pstate.params)}
    rstep = jax.jit(ref_trainer.make_train_step(
        rcfg, ref_adamw.AdamWConfig(**opt_kw)))
    pstep = trainer.make_train_step(cfg, adamw.AdamWConfig(**opt_kw))
    for i in range(3):
        b = _batch(cfg, i)
        rb = {k: jnp.asarray(v) for k, v in b.items()}
        pb = {k: torch.as_tensor(v) for k, v in b.items()}
        (rloss, _), rgrads = jax.value_and_grad(
            ref_trainer.loss_fn, has_aux=True)(rstate.params, rb, rcfg)
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
    for (path, p), (_, w) in zip(leaves(pstate.params), leaves(
            jax.tree.map(np.asarray, rstate.params))):
        assert rel(p, w) <= 1e-5, path
        moved = (p - start[path]).abs().max().item()
        assert moved > 10 * 1e-5 * np.abs(w).max(), path


@pytest.mark.parametrize("name", ARCHS)
def test_remat_gives_the_same_loss_and_gradients(name):
    import dataclasses
    cfg = get_config(name).reduced()
    params = convert.params_from_reference(jax.tree.map(
        np.asarray, ref_trainer.init_state(
            jax.random.PRNGKey(1), ref_config(name).reduced(),
            ref_adamw.AdamWConfig())[0].params), device="cpu")
    b = {k: torch.as_tensor(v) for k, v in _batch(cfg, 0).items()}
    off = trainer.value_and_grad(params, b, cfg)
    on = trainer.value_and_grad(params, b,
                                dataclasses.replace(cfg, remat=True))
    assert float(on[0]) == float(off[0])
    for (path, g), (_, w) in zip(leaves(on[2]), leaves(off[2])):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6 * max(
            w.abs().max().item(), 1e-30), msg=path)


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


@pytest.mark.parametrize("name", ARCHS + ["mixtral-8x22b"])
def test_every_parameter_leaf_gets_a_gradient(name):
    cfg = get_config(name).reduced()
    from repro_torch.models import transformer
    params = transformer.init_params(torch.Generator().manual_seed(2), cfg)
    b = {k: torch.as_tensor(v) for k, v in _batch(cfg, 0).items()}
    _, _, grads = trainer.value_and_grad(params, b, cfg)
    flat_p, flat_g = dict(leaves(params)), dict(leaves(grads))
    assert flat_p.keys() == flat_g.keys()
    for path, g in flat_g.items():
        assert g.shape == flat_p[path].shape, path
        assert torch.isfinite(g).all() and g.abs().max() > 0, path


def test_sharded_train_step_raises_naming_the_mesh_slice():
    for fn in (trainer.make_sharded_train_step, trainer.state_shardings,
               trainer.batch_shardings):
        with pytest.raises(NotImplementedError, match="mesh slice"):
            fn(None)
