"""The port's encdec and vlm families (cross-attention, the encoder, the
gated cross layers, static cross caches) against the reference, on the
CPU.

Inputs are made with numpy from a seed; model parameters come from the
reference's initializer and cross over with
``convert.params_from_reference``, with the vlm's cross gates opened to
0.5 (they start at 0, where the image changes no logit), as the
reference's own image test does.  Reduced ``whisper-small`` (2 encoder
and 2 decoder layers, 16 frames) and ``llama-3.2-vision-11b`` (4 layers,
a cross layer every 2, 16 patches): d=64, head_dim 16.  Tolerances:
attention and encoder outputs within 1e-4 x max|.|, logits within 1e-4 x
max|logit| (XLA and PyTorch sum in other orders); cross caches, stored
bf16, within one bf16 unit in the last place (2^-7 relative).  The bf16
vlm case holds the residual's dtype to the reference's (fp32 from the
first cross layer on) and the logits within 5e-2 x max|logit|.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models import decode as ref_decode  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.models import split  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.models import attention, decode, transformer  # noqa: E402

ARCHS = ["whisper-small", "llama-3.2-vision-11b"]
_SETUP = {}


def setup_arch(arch, **over):
    """(reference cfg, port cfg, reference params, port params) of the
    reduced config with ``over`` replaced; vlm gates at 0.5."""
    key = (arch, tuple(sorted(over.items())))
    if key not in _SETUP:
        cfg = dataclasses.replace(ref_config(arch).reduced(), **over)
        tcfg = dataclasses.replace(get_config(arch).reduced(), **over)
        jp = jax.tree.map(np.asarray, split(
            ref_init_params(jax.random.PRNGKey(0), cfg))[0])
        if cfg.family == "vlm":
            jp["cross_layers"]["gate"] = np.full_like(
                jp["cross_layers"]["gate"], 0.5)
        _SETUP[key] = (cfg, tcfg, jp, params_from_reference(jp,
                                                            device="cpu"))
    return _SETUP[key]


def randn(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def frontend(cfg, b, seed=9):
    return randn(b, cfg.frontend_tokens, cfg.d_model, seed=seed, scale=0.1)


def rel_close(got, want, tol):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.to(torch.float32).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def bf16_close(got, want):
    """Within one bf16 unit in the last place (at most 2^-7 of the
    value): an fp32 sum that differs in its last bits may round to the
    neighbouring bf16 value."""
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want,
                               rtol=2.0 ** -7, atol=1e-6)


def cross_params(arch, i=1):
    """Layer ``i``'s cross-attention params: whisper's decoder
    ``cross``, the vlm's ``cross_layers.attn``."""
    cfg, tcfg, jp, tp = setup_arch(arch)
    if cfg.family == "encdec":
        pj, pt = jp["layers"]["cross"], tp["layers"]["cross"]
    else:
        pj, pt = jp["cross_layers"]["attn"], tp["cross_layers"]["attn"]
    return (cfg, tcfg, jax.tree.map(lambda a: a[i], pj),
            {k: v[i] for k, v in pt.items()})


# ---------------------------------------------------------------------------
# cross-attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lkv", [16, 13])
@pytest.mark.parametrize("arch", ARCHS)
def test_cross_attention_prefill_matches_reference(arch, lkv):
    """Lq 5 against Lkv 16 and a ragged 13: no rope, no mask."""
    cfg, tcfg, pj, pt = cross_params(arch)
    x, kv = randn(2, 5, cfg.d_model, seed=1), randn(2, lkv, cfg.d_model,
                                                    seed=2)
    want, wc = ref_attn.apply_attention(pj, jnp.asarray(x), cfg,
                                        kv_x=jnp.asarray(kv), causal=False)
    got, gc = attention.apply_attention(pt, torch.as_tensor(x), tcfg,
                                        kv_x=torch.as_tensor(kv),
                                        causal=False)
    assert wc is None and gc is None
    rel_close(got, want, 1e-4)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_precompute_cross_cache(arch, dtype):
    cfg, tcfg, pj, pt = cross_params(arch)
    enc = randn(2, cfg.frontend_tokens, cfg.d_model, seed=3)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = ref_attn.precompute_cross_cache(pj, jnp.asarray(enc), cfg,
                                           dtype=jdt)
    got = attention.precompute_cross_cache(pt, torch.as_tensor(enc), tcfg,
                                           dtype=tdt)
    for leaf in ("k", "v"):
        assert got[leaf].dtype == tdt and got[leaf].shape == (
            2, cfg.frontend_tokens, cfg.kv_dim)
        if dtype == "bfloat16":
            bf16_close(got[leaf], want[leaf])
        else:
            rel_close(got[leaf], want[leaf], 1e-5)


@pytest.mark.parametrize("pos_kind", ["scalar", "per_slot"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cross_attention_decode_reads_the_static_cache(arch, pos_kind):
    """One query against a bf16 cross cache: attended in full whatever
    the position, and left as it was."""
    cfg, tcfg, pj, pt = cross_params(arch)
    enc = randn(3, cfg.frontend_tokens, cfg.d_model, seed=4)
    wcache = ref_attn.precompute_cross_cache(pj, jnp.asarray(enc), cfg)
    cache = {k: torch.as_tensor(np.array(v.astype(jnp.float32))).to(
        torch.bfloat16) for k, v in wcache.items()}
    before = {k: v.clone() for k, v in cache.items()}
    x = randn(3, 1, cfg.d_model, seed=5)
    pos = 7 if pos_kind == "scalar" else np.array([2, 9, 30], np.int32)
    want, _ = ref_attn.apply_attention(
        pj, jnp.asarray(x), cfg, kv_x=jnp.asarray(x), cache=wcache,
        pos=jnp.asarray(pos))
    xt = torch.as_tensor(x)
    got, gc = attention.apply_attention(
        pt, xt, tcfg, kv_x=xt, cache=cache,
        pos=pos if pos_kind == "scalar" else torch.as_tensor(pos))
    rel_close(got, want, 1e-4)
    assert gc is None
    for k in cache:
        assert torch.equal(cache[k], before[k])


# ---------------------------------------------------------------------------
# encoder, forward, prefill, decode
# ---------------------------------------------------------------------------

def _logit_close(got, want, tol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_encoder_is_the_reference_enc_out():
    """whisper's bidirectional encoder (non-causal self-attention) over
    16 frames, after enc_norm."""
    cfg, tcfg, jp, tp = setup_arch("whisper-small")
    fe, toks = frontend(cfg, 2), np.zeros((2, 3), np.int32)
    _, _, wc = ref_tf.forward(jp, jnp.asarray(toks), cfg,
                              frontend=jnp.asarray(fe), collect_cache=True)
    got = transformer.encode(tp, torch.as_tensor(fe), tcfg)
    rel_close(got, wc["enc_out"], 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_caches(arch):
    cfg, tcfg, jp, tp = setup_arch(arch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 24))
    fe = frontend(cfg, 2)
    wl, waux, wc = ref_tf.forward(jp, jnp.asarray(toks, jnp.int32), cfg,
                                  frontend=jnp.asarray(fe),
                                  collect_cache=True)
    gl, gaux, gc = transformer.forward(tp, torch.as_tensor(toks), tcfg,
                                       frontend=torch.as_tensor(fe),
                                       collect_cache=True)
    _logit_close(gl, wl)
    assert float(gaux) == float(waux) == 0.0
    assert set(gc) == set(wc)
    for part in gc:
        leaves = gc[part] if isinstance(gc[part], dict) else {"": gc[part]}
        for leaf, v in leaves.items():
            rel_close(v, wc[part][leaf] if leaf else wc[part], 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_is_required(arch):
    _, tcfg, _, tp = setup_arch(arch)
    with pytest.raises(ValueError, match="frontend"):
        transformer.forward(tp, torch.zeros((1, 3), dtype=torch.long), tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_teacher_forced_decode(arch):
    """Prefill 16 tokens, then feed tokens 16..23: every step's logits
    and the final self and cross caches equal the reference's."""
    cfg, tcfg, jp, tp = setup_arch(arch)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 24))
    fe = frontend(cfg, 2, seed=7)
    ref_step = jax.jit(ref_decode.decode_step, static_argnums=3)
    wl, wc = ref_decode.prefill(jp, jnp.asarray(toks[:, :16], jnp.int32),
                                cfg, frontend=jnp.asarray(fe), max_len=24)
    gl, gc = decode.prefill(tp, torch.as_tensor(toks[:, :16]), tcfg,
                            frontend=torch.as_tensor(fe), max_len=24)
    _logit_close(gl, wl)
    assert gc["pos"] == 16 and set(gc) == set(wc)
    cross = gc["cross"]
    for leaf in ("k", "v"):
        assert cross[leaf].dtype == torch.bfloat16
        assert tuple(cross[leaf].shape) == wc["cross"][leaf].shape
        bf16_close(cross[leaf], wc["cross"][leaf])
    for t in range(16, 24):
        nxt = toks[:, t:t + 1]
        wl, wc = ref_step(jp, jnp.asarray(nxt, jnp.int32), wc, cfg)
        gl, gc = decode.decode_step(tp, torch.as_tensor(nxt), gc, tcfg)
        _logit_close(gl, wl)
    assert gc["pos"] == 24 and gc["cross"] is cross
    for leaf in ("k", "v"):
        rel_close(gc["self"][leaf], wc["self"][leaf], 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_layout_and_cross_values(arch):
    """The template (no frontend, on ``meta``) has the reference's leaf
    shapes, the cross leaves bf16 whatever the K/V dtype; with a frontend
    the cross K/V are the reference's."""
    cfg, tcfg, jp, tp = setup_arch(arch)
    fe = frontend(cfg, 3)
    want = ref_decode.init_cache(jp, cfg, 3, 40, frontend=jnp.asarray(fe),
                                 dtype=jnp.float32)
    meta = decode.init_cache(tp, tcfg, 3, 40, dtype=torch.float32,
                             device="meta")
    got = decode.init_cache(tp, tcfg, 3, 40, frontend=torch.as_tensor(fe),
                            dtype=torch.float32)
    assert set(meta) == set(got) == set(want)
    for part in ("self", "cross"):
        for leaf in ("k", "v"):
            assert tuple(meta[part][leaf].shape) == want[part][leaf].shape
            assert meta[part][leaf].is_meta
            assert str(meta[part][leaf].dtype)[6:] == str(
                want[part][leaf].dtype)
    assert meta["cross"]["k"].dtype == torch.bfloat16
    for leaf in ("k", "v"):
        bf16_close(got["cross"][leaf], want["cross"][leaf])


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_keys_shapes_and_compute_dtypes(arch):
    cfg, tcfg, jp, _ = setup_arch(arch)
    got = transformer.init_params(torch.Generator().manual_seed(0), tcfg)

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}
    assert shapes(got) == jax.tree.map(lambda a: tuple(a.shape), jp,
                                       is_leaf=lambda a: hasattr(a, "shape"))
    cp = transformer.compute_params(got, dataclasses.replace(
        tcfg, dtype="bfloat16"))
    if cfg.family == "vlm":
        assert torch.equal(got["cross_layers"]["gate"],
                           torch.zeros(cfg.n_layers // cfg.cross_attn_every))
        assert cp["cross_layers"]["gate"].dtype == torch.float32
        assert cp["cross_layers"]["ln"].dtype == torch.float32
        assert cp["cross_layers"]["attn"]["wk"].dtype == torch.bfloat16
    else:
        assert cp["enc_norm"].dtype == torch.float32
        assert cp["layers"]["ln3"].dtype == torch.float32
        assert cp["encoder"]["ffn"]["wd"].dtype == torch.bfloat16
        assert cp["layers"]["cross"]["wq"].dtype == torch.bfloat16


def test_vlm_gate_closed_and_open():
    """At init (gate 0) the image changes no logit; opened, it does."""
    cfg, tcfg, _, tp = setup_arch("llama-3.2-vision-11b")
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 12)))
    fe = torch.as_tensor(frontend(cfg, 2))
    closed = dict(tp, cross_layers=dict(
        tp["cross_layers"], gate=torch.zeros_like(tp["cross_layers"]["gate"])))
    a = transformer.forward(closed, toks, tcfg, frontend=fe)[0]
    b = transformer.forward(closed, toks, tcfg, frontend=fe + 0.5)[0]
    assert torch.equal(a, b)
    a = transformer.forward(tp, toks, tcfg, frontend=fe)[0]
    b = transformer.forward(tp, toks, tcfg, frontend=fe + 0.5)[0]
    assert (a - b).abs().max() > 1e-6


def test_bf16_vlm_residual_is_fp32_as_in_the_reference(monkeypatch):
    """bf16 compute: JAX promotes ``x + tanh(gate) * h`` to fp32 (the
    gate is an fp32 array); the port promotes explicitly.  The dtype that
    reaches each norm, the cross block's output and the logits agree."""
    cfg, tcfg, jp, tp = setup_arch("llama-3.2-vision-11b", dtype="bfloat16")
    cp = transformer.compute_params(tp, tcfg)
    seen = {"ref": [], "port": []}
    real_ref, real_port = ref_tf.rmsnorm, transformer.rmsnorm

    def ref_norm(x, g, eps=1e-5):
        seen["ref"].append(str(x.dtype))
        return real_ref(x, g, eps)

    def port_norm(x, g, eps=1e-5):
        seen["port"].append(str(x.dtype)[6:])
        return real_port(x, g, eps)

    monkeypatch.setattr(ref_tf, "rmsnorm", ref_norm)
    monkeypatch.setattr(transformer, "rmsnorm", port_norm)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 12))
    fe = frontend(cfg, 2)
    wl, _, _ = ref_tf.forward(jp, jnp.asarray(toks, jnp.int32), cfg,
                              frontend=jnp.asarray(fe))
    gl, _, _ = transformer.forward(cp, torch.as_tensor(toks), tcfg,
                                   frontend=torch.as_tensor(fe))
    # the first norm (the first cross block's) sees the bf16 embedding,
    # every later one the promoted stream, the final norm included
    assert seen["ref"][0] == seen["port"][0] == "bfloat16"
    assert set(seen["ref"][1:]) == set(seen["port"][1:]) == {"float32"}
    _logit_close(gl, wl, tol=5e-2)

    # one cross block on the same bf16 input
    x = randn(2, 12, cfg.d_model, seed=6)
    img = jnp.asarray(fe).astype(jnp.bfloat16)
    cl = jax.tree.map(lambda a: a[0], jp["cross_layers"])
    h, _ = ref_attn.apply_attention(
        cl["attn"], ref_common.rmsnorm(jnp.asarray(x).astype(jnp.bfloat16),
                                       cl["ln"], cfg.norm_eps),
        cfg, kv_x=img, causal=False)
    want = jnp.asarray(x).astype(jnp.bfloat16) + jnp.tanh(cl["gate"]) * h
    got = transformer._cross_block(
        transformer.layer_params(cp["cross_layers"], 0),
        torch.as_tensor(x).to(torch.bfloat16), tcfg,
        img=torch.as_tensor(fe).to(torch.bfloat16))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    rel_close(got, want, 2e-2)
