"""The port's model path (dense, ssm and hybrid families) and its
kernels' plain versions against the reference, on the CPU.

Inputs are made with numpy from a seed and go through the reference
function and its port counterpart; model parameters come from the
reference's initializer and cross over with
``convert.params_from_reference``.  The reference's Pallas kernels run in
``interpret=True`` mode.  Tolerances: fp32 attention and model outputs
within 1e-4 (absolute for attention, x max|logit| for logits: XLA and
PyTorch sum in other orders and round ``exp``/``pow`` apart by an ulp);
bf16 attention within 6e-2 (the reference's own bf16 tolerance); the
paged gather and scatter, pure copies, exactly.  Reduced configs
(``.reduced()``: 2 layers (the hybrid 4, shared block every 2), d=64,
head_dim 16, SWA 16, SSM state 16, chunk 8); ``zamba2-1.2b:5`` is the
reduced hybrid at 5 layers, whose last SSM layer is a tail after the
last shared application.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import paged as ref_paged  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models import decode as ref_decode  # noqa: E402
from repro.models import mlp as ref_mlp  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.models import split  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, paged, ref  # noqa: E402
from repro_torch.models import attention, common, decode, mlp  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

#: the attention/MLP block tests run the dense archs; the model tests
#: (forward, prefill, decode) run every family the port runs
DENSE_ARCHS = ["granite-8b", "h2o-danube-1.8b"]
ARCHS = DENSE_ARCHS + ["mamba2-370m", "zamba2-1.2b", "zamba2-1.2b:5"]


def randn(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x, np.float32)).to(dtype)


def close(got, want, tol=1e-4):
    got = got.to(torch.float32).numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


_SETUP = {}


def setup_arch(arch):
    """(reference cfg, port cfg, reference params, port params);
    ``name:n`` is the reduced config at ``n`` layers."""
    if arch not in _SETUP:
        import dataclasses
        name, _, layers = arch.partition(":")
        cfg, tcfg = ref_config(name).reduced(), get_config(name).reduced()
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=int(layers))
            tcfg = dataclasses.replace(tcfg, n_layers=int(layers))
        jp = jax.tree.map(np.asarray, split(
            ref_init_params(jax.random.PRNGKey(0), cfg))[0])
        _SETUP[arch] = (cfg, tcfg, jp, params_from_reference(jp,
                                                             device="cpu"))
    return _SETUP[arch]


# ---------------------------------------------------------------------------
# ops.attention (the flash kernel's plain version) vs the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window", [(True, None), (True, 16),
                                           (False, None)])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
def test_attention_masks_and_gqa(causal, window, hq, hkv):
    q, k, v = (randn(2, hq, 64, 32, seed=1), randn(2, hkv, 64, 32, seed=2),
               randn(2, hkv, 64, 32, seed=3))
    want = ref_ops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window, bq=16, bkv=16,
                             interpret=True)
    got = ops.attention(t(q), t(k), t(v), causal=causal, window=window,
                        bq=16, bkv=16)
    close(got, want)


def test_attention_head_dim_80():
    q, k, v = randn(1, 8, 48, 80, seed=4), randn(1, 2, 48, 80, seed=5), \
        randn(1, 2, 48, 80, seed=6)
    want = ref_ops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, bq=16, bkv=16, interpret=True)
    close(ops.attention(t(q), t(k), t(v), causal=True, bq=16, bkv=16), want)


def test_attention_bf16():
    q, k, v = (randn(1, 2, 64, 32, seed=i) for i in (7, 8, 9))
    want = ref_ops.attention(*(jnp.asarray(x).astype(jnp.bfloat16)
                               for x in (q, k, v)),
                             causal=True, bq=32, bkv=32, interpret=True)
    got = ops.attention(*(t(x, torch.bfloat16) for x in (q, k, v)),
                        causal=True, bq=32, bkv=32)
    assert got.dtype == torch.bfloat16
    close(got, want, tol=6e-2)


def test_attention_ragged_q():
    q, k, v = randn(1, 2, 50, 16, seed=10), randn(1, 2, 64, 16, seed=11), \
        randn(1, 2, 64, 16, seed=12)
    want = ref_ops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, bq=16, bkv=16, interpret=True)
    got = ops.attention(t(q), t(k), t(v), causal=True, bq=16, bkv=16)
    assert got.shape == (1, 2, 50, 16)
    close(got, want)


def test_attention_ragged_self_attention_pads_like_the_reference():
    q, k, v = (randn(1, 2, 40, 16, seed=i) for i in (13, 14, 15))
    want = ref_ops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, bq=16, bkv=16, interpret=True)
    close(ops.attention(t(q), t(k), t(v), causal=True, bq=16, bkv=16), want)


def test_attention_fully_masked_rows_are_zero():
    """A window of 4 under 16-row blocks masks whole kv blocks for early
    rows; the online softmax gives no NaN, and rows without a visible
    column are 0."""
    q, k, v = (randn(1, 1, 64, 16, seed=i) for i in (16, 17, 18))
    want = ref_ops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, window=4, bq=16, bkv=16,
                             interpret=True)
    got = ops.attention(t(q), t(k), t(v), causal=True, window=4, bq=16,
                        bkv=16)
    assert bool(torch.isfinite(got).all())
    close(got, want)


def test_attention_rows_that_see_nothing_are_zero():
    """Non-causal with a window of 4 and 16 keys: rows 20.. see no key at
    all (l == 0) and are written as 0, as the reference's kernel does."""
    q, k, v = randn(1, 1, 40, 16, seed=19), randn(1, 1, 16, 16, seed=20), \
        randn(1, 1, 16, 16, seed=21)
    want = ref_ops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=False, window=4, bq=8, bkv=16,
                             interpret=True)
    got = ops.attention(t(q), t(k), t(v), causal=False, window=4, bq=8,
                        bkv=16)
    close(got, want)
    assert bool((got[0, 0, 20:] == 0).all())


def test_attention_cross_requires_whole_kv_blocks():
    q, k = t(randn(1, 1, 16, 16)), t(randn(1, 1, 20, 16))
    with pytest.raises(ValueError, match="cross-attention"):
        ops.attention(q, k, k, causal=False, bq=16, bkv=16)


def test_attention_xla_backend_is_the_oracle():
    q, k, v = (randn(1, 4, 24, 16, seed=i) for i in (21, 22, 23))
    got = ops.attention(t(q), t(k[:, :2]), t(v[:, :2]), causal=True,
                        window=8, backend="xla")
    want = ref_ops.attention(jnp.asarray(q), jnp.asarray(k[:, :2]),
                             jnp.asarray(v[:, :2]), causal=True, window=8,
                             backend="xla")
    close(got, want)
    with pytest.raises(ValueError, match="backend"):
        ops.attention(t(q), t(k), t(v), backend="pallas")


@pytest.mark.parametrize("causal,window,q_offset", [(True, None, 0),
                                                    (True, 5, 3),
                                                    (False, None, 0)])
def test_attention_ref_and_mask_match(causal, window, q_offset):
    q, k = randn(2, 4, 6, 16, seed=24), randn(2, 2, 12, 16, seed=25)
    want = ref.attention_ref.__module__   # the port's oracle module
    assert want.startswith("repro_torch")
    from repro.kernels import ref as jref
    close(ref.attention_ref(t(q), t(k), t(k), causal=causal, window=window,
                            q_offset=q_offset),
          jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                             causal=causal, window=window,
                             q_offset=q_offset))
    np.testing.assert_array_equal(
        ref.attention_mask(6, 12, causal=causal, window=window,
                           q_offset=q_offset).numpy(),
        np.asarray(jref.attention_mask(6, 12, causal=causal, window=window,
                                       q_offset=q_offset)))


def test_flash_attention_rejects_bad_shapes():
    q = t(randn(1, 3, 8, 16))
    k = t(randn(1, 2, 8, 16))
    with pytest.raises(ValueError, match="GQA"):
        fa.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(k, k, k, window=0)


# ---------------------------------------------------------------------------
# paged gather / scatter vs the reference
# ---------------------------------------------------------------------------

def test_paged_gather_matches_pallas_exactly():
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((9, 8, 32)).astype(np.float32)
    table = rng.integers(0, 9, (3, 4)).astype(np.int32)
    want = ref_paged.paged_gather_pallas(jnp.asarray(pool),
                                         jnp.asarray(table), interpret=True)
    got = paged.paged_gather(torch.as_tensor(pool), torch.as_tensor(table))
    assert got.shape == (3, 32, 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_paged.paged_gather(jnp.asarray(pool),
                                                       jnp.asarray(table))))


def test_paged_gather_bf16_exact():
    rng = np.random.default_rng(1)
    pool = torch.as_tensor(rng.standard_normal((5, 4, 6)).astype(
        np.float32)).to(torch.bfloat16)
    table = torch.as_tensor(np.array([[4, 0], [2, 4]], np.int32))
    got = paged.paged_gather(pool, table)
    assert torch.equal(got[0, :4], pool[4]) and torch.equal(got[1, :4],
                                                            pool[2])


def test_paged_scatter_token_matches_reference():
    rng = np.random.default_rng(2)
    pool = rng.standard_normal((4, 8, 16)).astype(np.float32)
    vals = rng.standard_normal((2, 16)).astype(np.float32)
    want = ref_paged.paged_scatter_token(jnp.asarray(pool),
                                         jnp.array([1, 3]),
                                         jnp.array([0, 7]),
                                         jnp.asarray(vals))
    tp = torch.as_tensor(pool.copy())
    got = paged.paged_scatter_token(tp, torch.tensor([1, 3]),
                                    torch.tensor([0, 7]),
                                    torch.as_tensor(vals))
    assert got is tp                        # in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# common, mlp, attention blocks
# ---------------------------------------------------------------------------

def test_rmsnorm():
    x, g = randn(2, 5, 64, seed=1), randn(64, seed=2)
    close(common.rmsnorm(t(x), t(g), 1e-5),
          ref_common.rmsnorm(jnp.asarray(x), jnp.asarray(g), 1e-5))


@pytest.mark.parametrize("positions", ["L", "BL"])
def test_rope(positions):
    x = randn(2, 4, 6, 16, seed=3)
    pos = (np.arange(6) + 3 if positions == "L" else
           np.random.default_rng(4).integers(0, 50, (2, 6)))
    close(common.rope(t(x), torch.as_tensor(pos), 10_000.0),
          ref_common.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0))


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_apply_mlp(arch):
    cfg, tcfg, jp, tp = setup_arch(arch)
    x = randn(2, 5, cfg.d_model, seed=5)
    pj = jax.tree.map(lambda a: a[1], jp["layers"]["ffn"])
    pt = {k: v[1] for k, v in tp["layers"]["ffn"].items()}
    want = jax.jit(ref_mlp.apply_mlp, static_argnums=2)(pj, x, cfg)
    close(mlp.apply_mlp(pt, t(x), tcfg), want)


def _layer_attn(arch, i=0):
    cfg, tcfg, jp, tp = setup_arch(arch)
    return (cfg, tcfg, jax.tree.map(lambda a: a[i], jp["layers"]["attn"]),
            {k: v[i] for k, v in tp["layers"]["attn"].items()})


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_apply_attention_prefill_collects_kv(arch):
    cfg, tcfg, pj, pt = _layer_attn(arch)
    x = randn(2, 24, cfg.d_model, seed=6)
    want, wkv = jax.jit(ref_attn.apply_attention, static_argnums=2,
                        static_argnames="collect_kv")(
        pj, jnp.asarray(x), cfg, collect_kv=True)
    got, gkv = attention.apply_attention(pt, t(x), tcfg, collect_kv=True)
    close(got, want)
    close(gkv["k"], wkv["k"])
    close(gkv["v"], wkv["v"])


@pytest.mark.parametrize("pos_kind", ["scalar", "per_slot"])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_apply_attention_decode(arch, pos_kind):
    """One decode token against a cache: granite's linear 40-slot cache,
    danube's rolling 16-slot (SWA) cache past its wrap-around."""
    cfg, tcfg, pj, pt = _layer_attn(arch)
    s_cache = 40 if cfg.swa_window is None else cfg.swa_window
    rng = np.random.default_rng(7)
    ck = rng.standard_normal((3, s_cache, cfg.kv_dim)).astype(np.float32)
    cv = rng.standard_normal((3, s_cache, cfg.kv_dim)).astype(np.float32)
    x = randn(3, 1, cfg.d_model, seed=8)
    pos = 21 if pos_kind == "scalar" else np.array([3, 21, 37], np.int32)
    want, wc = jax.jit(ref_attn.apply_attention, static_argnums=2)(
        pj, jnp.asarray(x), cfg, cache={"k": jnp.asarray(ck),
                                        "v": jnp.asarray(cv)},
        pos=jnp.asarray(pos))
    cache = {"k": torch.as_tensor(ck.copy()), "v": torch.as_tensor(cv.copy())}
    got, gc = attention.apply_attention(
        pt, t(x), tcfg, cache=cache,
        pos=pos if pos_kind == "scalar" else torch.as_tensor(pos))
    close(got, want)
    assert gc["k"] is cache["k"]            # written in place
    close(gc["k"], wc["k"])
    close(gc["v"], wc["v"])


@pytest.mark.parametrize("window,cache_len", [(None, 32), (8, 32), (8, 8)])
def test_decode_attn_validity(window, cache_len):
    """Linear, linear + SWA and rolling caches, per-slot and scalar."""
    q = randn(3, 4, 1, 16, seed=9)
    k = randn(3, 2, cache_len, 16, seed=10)
    v = randn(3, 2, cache_len, 16, seed=11)
    for pos in (5, np.array([2, 9, 30], np.int32)):
        want = ref_attn._decode_attn(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), pos=jnp.asarray(pos),
                                     window=window, cache_len=cache_len)
        got = attention._decode_attn(
            t(q), t(k), t(v), pos=pos if np.ndim(pos) == 0 else
            torch.as_tensor(pos), window=window, cache_len=cache_len)
        close(got, want)


@pytest.mark.parametrize("window", [None, 24])
def test_chunked_attn_matches_reference(window):
    q, k = randn(1, 4, 64, 16, seed=12), randn(1, 2, 64, 16, seed=13)
    want = ref_attn._chunked_attn(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(k), causal=True, window=window,
                                  bkv=16)
    close(attention._chunked_attn(t(q), t(k), t(k), causal=True,
                                  window=window, bkv=16), want)


def test_make_kv_cache_rolling_and_linear():
    for arch, s in (("granite-8b", 40), ("h2o-danube-1.8b", 16)):
        c = attention.make_kv_cache(get_config(arch).reduced(), 2, 40,
                                    dtype=torch.float32)
        assert c["k"].shape == (2, s, 32) and c["v"].dtype == torch.float32


def test_cross_attention_and_mesh_branches_fall_back():
    """With ``explicit_collectives`` and no mesh every helper of
    ``explicit_tp`` returns None (the reference's ``_mesh_info`` sees no
    axes), so self- and cross-attention, the MLP and the MoE equal the
    flag-off blocks bit for bit, and the reference's flag-on blocks within
    the file's tolerance."""
    import dataclasses
    cfg, tcfg, pj, pt = _layer_attn("granite-8b")
    x = randn(1, 4, cfg.d_model, seed=21)
    kv = randn(1, 6, cfg.d_model, seed=22)
    etp, ertp = (dataclasses.replace(c, explicit_collectives=True,
                                     sequence_parallel=True)
                 for c in (tcfg, cfg))
    for kv_x in (None, kv):
        off = attention.apply_attention(
            pt, t(x), tcfg, kv_x=None if kv_x is None else t(kv_x))[0]
        on = attention.apply_attention(
            pt, t(x), etp, kv_x=None if kv_x is None else t(kv_x))[0]
        assert torch.equal(on, off)
        want = ref_attn.apply_attention(
            pj, jnp.asarray(x), ertp,
            kv_x=None if kv_x is None else jnp.asarray(kv_x))[0]
        close(on, want)
    _, _, jp, tp = setup_arch("granite-8b")
    fj = jax.tree.map(lambda a: a[0], jp["layers"]["ffn"])
    ft = {k: v[0] for k, v in tp["layers"]["ffn"].items()}
    on = mlp.apply_mlp(ft, t(x), etp)
    assert torch.equal(on, mlp.apply_mlp(ft, t(x), tcfg))
    close(on, ref_mlp.apply_mlp(fj, jnp.asarray(x), ertp))
    mcfg, mtcfg, mjp, mtp = setup_arch("mixtral-8x22b")
    mj = jax.tree.map(lambda a: a[0], mjp["layers"]["ffn"])
    mt = {k: v[0] for k, v in mtp["layers"]["ffn"].items()}
    xm = randn(2, 8, mcfg.d_model, seed=23)
    m_on, m_etp = (dataclasses.replace(c, explicit_collectives=True,
                                       sequence_parallel=True)
                   for c in (mtcfg, mcfg))
    got, aux = mlp.apply_moe(mt, t(xm), m_on)
    off, aux_off = mlp.apply_moe(mt, t(xm), mtcfg)
    assert torch.equal(got, off) and torch.equal(aux, aux_off)
    want, waux = ref_mlp.apply_moe(mj, jnp.asarray(xm), m_etp)
    close(got, want)
    close(aux, waux)


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s0,max_len", [(24, 40), (20, 40), (16, 16)])
def test_fit_cache(s0, max_len):
    """Linear pad; rolling with a roll (20 % 16 != 0) and without."""
    kv = randn(2, 1, s0, 8, seed=s0)
    for window in (None, 16):
        want = ref_decode._fit_cache({"k": jnp.asarray(kv)}, window,
                                     max_len, s0)
        got = decode._fit_cache({"k": t(kv)}, window, max_len, s0)
        np.testing.assert_array_equal(got["k"].numpy(),
                                      np.asarray(want["k"]))


def _logit_close(got, want, tol=1e-4):
    want = np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_caches(arch):
    cfg, tcfg, jp, tp = setup_arch(arch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 24))
    wl, waux, wc = ref_tf.forward(jp, jnp.asarray(toks, jnp.int32), cfg,
                                  collect_cache=True)
    gl, gaux, gc = transformer.forward(tp, torch.as_tensor(toks), tcfg,
                                       collect_cache=True)
    assert gl.dtype == torch.float32 and gl.shape == (2, 24, cfg.vocab)
    _logit_close(gl, wl)
    assert float(gaux) == float(waux) == 0.0
    assert set(gc) == set(wc)
    for part in gc:
        assert set(gc[part]) == set(wc[part])
        for leaf in gc[part]:
            close(gc[part][leaf], wc[part][leaf])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_steps(arch):
    """granite's linear cache and danube's rolling one, decoded past the
    16-slot window; the SSM recurrence from a prompt padded to the chunk
    (12 -> 16), and the hybrid's shared K/V."""
    cfg, tcfg, jp, tp = setup_arch(arch)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 12))
    ref_step = jax.jit(ref_decode.decode_step, static_argnums=3)
    wl, wc = jax.jit(ref_decode.prefill, static_argnums=2,
                     static_argnames="max_len")(
        jp, jnp.asarray(toks, jnp.int32), cfg, max_len=32)
    gl, gc = decode.prefill(tp, torch.as_tensor(toks), tcfg, max_len=32)
    _logit_close(gl, wl)
    assert gc["pos"] == 12 and set(gc) == set(wc)
    for part in set(gc) - {"pos"}:
        for leaf in gc[part]:
            assert gc[part][leaf].shape == wc[part][leaf].shape
    for step in range(6):
        nxt = np.asarray(jnp.argmax(wl, -1))[:, None].astype(np.int32)
        wl, wc = ref_step(jp, jnp.asarray(nxt), wc, cfg)
        gl, gc = decode.decode_step(tp, torch.as_tensor(nxt).long(), gc,
                                    tcfg)
        _logit_close(gl, wl)
    assert gc["pos"] == 18
    for part in set(gc) - {"pos"}:
        for leaf in gc[part]:
            close(gc[part][leaf], wc[part][leaf])


def test_init_cache_matches_reference_layout():
    cfg, tcfg, jp, tp = setup_arch("h2o-danube-1.8b")
    want = ref_decode.init_cache(jp, cfg, 3, 40)
    got = decode.init_cache(tp, tcfg, 3, 40)
    assert got["pos"] == 0
    for leaf in ("k", "v"):
        assert tuple(got["self"][leaf].shape) == want["self"][leaf].shape
        assert got["self"][leaf].dtype == torch.bfloat16
    meta = decode.init_cache(tp, tcfg, 3, 40, device="meta")
    assert meta["self"]["k"].is_meta


def test_init_params_keys_shapes_and_scales():
    cfg, tcfg, jp, _ = setup_arch("granite-8b")
    gen = torch.Generator().manual_seed(0)
    got = transformer.init_params(gen, tcfg)

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}
    assert shapes(got) == jax.tree.map(lambda a: tuple(a.shape), jp,
                                       is_leaf=lambda a: hasattr(a, "shape"))
    assert abs(float(got["embed"].std()) - 0.02) < 2e-3
    wq = got["layers"]["attn"]["wq"]
    assert abs(float(wq.std()) - tcfg.d_model ** -0.5) < 0.01
    assert torch.equal(got["layers"]["ln1"], torch.ones_like(
        got["layers"]["ln1"]))


def test_compute_params_casts_once_and_keeps_norms():
    import dataclasses
    _, tcfg, _, tp = setup_arch("granite-8b")
    bcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    cp = transformer.compute_params(tp, bcfg)
    assert cp["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert cp["embed"].dtype == torch.bfloat16
    assert cp["layers"]["ln1"].dtype == torch.float32
    assert cp["final_norm"].dtype == torch.float32
    assert cp["w_out"].dtype == torch.float32
    assert torch.equal(cp["w_out"], tp["embed"].T.to(torch.bfloat16).float())
    assert tp["layers"]["attn"]["wq"].dtype == torch.float32   # masters
    # a second pass changes nothing, and the logits agree with the masters
    cp2 = transformer.compute_params(cp, bcfg)
    assert cp2["w_out"] is cp["w_out"]
    toks = torch.arange(6)[None] % tcfg.vocab
    la = transformer.forward(tp, toks, bcfg)[0]
    lb = transformer.forward(cp, toks, bcfg)[0]
    assert torch.equal(la, lb)


def test_unknown_family_raises():
    import dataclasses
    tcfg = dataclasses.replace(get_config("granite-8b").reduced(),
                               family="rnn")
    with pytest.raises(ValueError, match="rnn"):
        transformer.init_params(torch.Generator(), tcfg)
    with pytest.raises(ValueError, match="rnn"):
        transformer.forward({"embed": torch.zeros((4, 2))},
                            torch.zeros((1, 2), dtype=torch.long), tcfg)


def test_params_from_reference_copies_leaves():
    cfg, _, jp, tp = setup_arch("granite-8b")
    assert set(tp) == set(jp)
    np.testing.assert_array_equal(tp["layers"]["ffn"]["wd"].numpy(),
                                  jp["layers"]["ffn"]["wd"])
    assert tp["embed"].dtype == torch.float32
