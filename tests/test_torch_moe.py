"""The port's MoE family against the reference, on the CPU.

Inputs are made with numpy from a seed; model parameters come from the
reference's initializer and cross over with
``convert.params_from_reference``.  Reduced ``mixtral-8x22b`` (SWA 16)
and ``grok-1-314b`` (full attention): 2 layers, d=64, 4 experts, top 2.
Tolerances: the dispatch table and keep mask exactly; ``apply_moe``'s
output and aux loss within 1e-5 x max|.| in fp32 (XLA and PyTorch sum
in other orders); logits within 1e-4 x max|logit|.  Teacher-forced
decode runs at ``capacity_factor=8`` (no drops), as the reference's own
test does; prefill at the default capacity, where the drops must match.
The bf16 case holds the router's probabilities and top-k choices and the
residual's dtype to the reference's, layer by layer on the same inputs.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import decode as ref_decode  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.models import mlp as ref_mlp  # noqa: E402
from repro.models import split  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.models import decode, mlp, transformer  # noqa: E402

ARCHS = ["mixtral-8x22b", "grok-1-314b"]
_SETUP = {}


def setup_arch(arch, **over):
    """(reference cfg, port cfg, reference params, port params) of the
    reduced config with ``over`` replaced."""
    key = (arch, tuple(sorted(over.items())))
    if key not in _SETUP:
        cfg = dataclasses.replace(ref_config(arch).reduced(), **over)
        tcfg = dataclasses.replace(get_config(arch).reduced(), **over)
        jp = _SETUP.get(("params", arch))
        if jp is None:
            jp = _SETUP[("params", arch)] = jax.tree.map(np.asarray, split(
                ref_init_params(jax.random.PRNGKey(0), cfg))[0])
        _SETUP[key] = (cfg, tcfg, jp, params_from_reference(jp,
                                                            device="cpu"))
    return _SETUP[key]


def randn(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def rel_close(got, want, tol):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.to(torch.float32).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def distinct_choices(t, k, e, seed):
    """(t, k) expert choices, distinct within a token, as top-k gives."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(e)[:k] for _ in range(t)]).astype(
        np.int32)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

DISPATCH = [(12, 2, 4, 7), (12, 2, 4, 3), (1, 2, 8, 1), (16, 1, 4, 2),
            (9, 3, 8, 2), (24, 2, 4, 13)]


@pytest.mark.parametrize("t,k,e,cap", DISPATCH)
def test_dispatch_indices_equal_the_reference(t, k, e, cap):
    idx = distinct_choices(t, k, e, seed=t * 31 + cap)
    want_slots, want_keep = ref_mlp._dispatch_indices(jnp.asarray(idx), e,
                                                      cap)
    slots, keep = mlp._dispatch_indices(torch.as_tensor(idx), e, cap)
    assert slots.dtype == torch.int32 and slots.shape == (e, cap)
    np.testing.assert_array_equal(slots.numpy(), np.asarray(want_slots))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want_keep))


def test_dispatch_drops_in_token_then_slot_order():
    """Capacity 3 over 6 tokens that all pick experts 0 then 1: tokens
    0-2 win both places, tokens 3-5 are dropped, and expert 2 is empty."""
    idx = np.tile(np.array([[0, 1]], np.int32), (6, 1))
    slots, keep = mlp._dispatch_indices(torch.as_tensor(idx), 3, 3)
    assert keep[:3].all() and not keep[3:].any()
    assert slots.tolist() == [[0, 2, 4], [1, 3, 5], [12, 12, 12]]


@pytest.mark.parametrize("t,k,e,cap", DISPATCH[:4])
def test_dispatch_groups_are_independent(t, k, e, cap):
    """A (G, T, K) batch gives each group its own table: the reference's
    per-group ``vmap``."""
    idx = np.stack([distinct_choices(t, k, e, seed=s) for s in range(3)])
    slots, keep = mlp._dispatch_indices(torch.as_tensor(idx), e, cap)
    assert slots.shape == (3, e, cap) and keep.shape == (3, t, k)
    for g in range(3):
        ws, wk = ref_mlp._dispatch_indices(jnp.asarray(idx[g]), e, cap)
        np.testing.assert_array_equal(slots[g].numpy(), np.asarray(ws))
        np.testing.assert_array_equal(keep[g].numpy(), np.asarray(wk))


# ---------------------------------------------------------------------------
# apply_moe
# ---------------------------------------------------------------------------

def _layer_ffn(arch, i=1, **over):
    cfg, tcfg, jp, tp = setup_arch(arch, **over)
    return (cfg, tcfg, jax.tree.map(lambda a: a[i], jp["layers"]["ffn"]),
            {k: v[i] for k, v in tp["layers"]["ffn"].items()})


@pytest.mark.parametrize("cf", [1.25, 0.5, 8.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_reference(arch, cf):
    """The default capacity, a tight one that drops many choices, and one
    that drops none."""
    cfg, tcfg, pj, pt = _layer_ffn(arch, capacity_factor=cf)
    x = randn(2, 12, cfg.d_model, seed=3)
    want, waux = jax.jit(ref_mlp.apply_moe, static_argnums=2)(
        pj, jnp.asarray(x), cfg)
    got, aux = mlp.apply_moe(pt, torch.as_tensor(x), tcfg)
    assert got.dtype == torch.float32 and aux.shape == ()
    rel_close(got, want, 1e-5)
    rel_close(aux, waux, 1e-5)


def test_tight_capacity_really_drops():
    cfg, tcfg, _, pt = _layer_ffn("mixtral-8x22b", capacity_factor=0.5)
    x = torch.as_tensor(randn(2, 12, cfg.d_model, seed=3))
    _, _, _, top_idx = mlp.route(pt, x, tcfg)
    _, keep = mlp._dispatch_indices(top_idx, tcfg.n_experts,
                                    mlp.capacity(tcfg, 12))
    assert 0 < int((~keep).sum()) < keep.numel()


def test_moe_groups_do_not_share_capacity():
    """A batch row's output does not depend on the other rows: each row
    routes within its own capacity (what keeps co-batched and idle slots
    from taking each other's places)."""
    cfg, tcfg, _, pt = _layer_ffn("mixtral-8x22b")
    x = torch.as_tensor(randn(3, 12, cfg.d_model, seed=4))
    both, _ = mlp.apply_moe(pt, x, tcfg)
    for r in range(3):
        alone, _ = mlp.apply_moe(pt, x[r:r + 1], tcfg)
        assert torch.equal(both[r], alone[0])


def test_init_moe_shapes_and_scales():
    tcfg = get_config("mixtral-8x22b").reduced()
    p = mlp.init_moe(torch.Generator().manual_seed(0), tcfg, 2)
    e, d, f = tcfg.n_experts, tcfg.d_model, tcfg.d_ff
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "router": (2, d, e), "wg": (2, e, d, f), "wu": (2, e, d, f),
        "wd": (2, e, f, d)}
    assert abs(float(p["wd"].std()) - f ** -0.5) < 0.01
    cfg, _, jp, _ = setup_arch("mixtral-8x22b")
    assert {k: v.shape for k, v in jp["layers"]["ffn"].items()} == {
        k: tuple(v.shape) for k, v in p.items()}


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------

def _logit_close(got, want, tol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_aux_and_caches(arch):
    cfg, tcfg, jp, tp = setup_arch(arch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 24))
    wl, waux, wc = ref_tf.forward(jp, jnp.asarray(toks, jnp.int32), cfg,
                                  collect_cache=True)
    gl, gaux, gc = transformer.forward(tp, torch.as_tensor(toks), tcfg,
                                       collect_cache=True)
    _logit_close(gl, wl)
    rel_close(gaux, waux, 1e-5)
    assert float(gaux) > 0
    assert set(gc) == set(wc) == {"self"}
    for leaf in ("k", "v"):
        rel_close(gc["self"][leaf], wc["self"][leaf], 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_at_default_capacity(arch):
    """16-token prompts: capacity 11 of 32 choices over 4 experts, where
    a crowded expert drops; the logits and caches match the
    reference's."""
    cfg, tcfg, jp, tp = setup_arch(arch)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 16))
    wl, wc = ref_decode.prefill(jp, jnp.asarray(toks, jnp.int32), cfg,
                                max_len=24)
    gl, gc = decode.prefill(tp, torch.as_tensor(toks), tcfg, max_len=24)
    _logit_close(gl, wl)
    assert gc["pos"] == 16 and set(gc) == set(wc)
    for leaf in ("k", "v"):
        assert tuple(gc["self"][leaf].shape) == wc["self"][leaf].shape
        rel_close(gc["self"][leaf], wc["self"][leaf], 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_reference_and_forward(arch):
    """capacity_factor 8 (no drops anywhere): prefill 16 tokens, then
    feed tokens 16..23 one at a time; every step's logits equal the
    reference's decode step and the port's own full forward (SWA: past
    mixtral's 16-slot window)."""
    cfg, tcfg, jp, tp = setup_arch(arch, capacity_factor=8.0)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 24))
    full, _, _ = transformer.forward(tp, torch.as_tensor(toks), tcfg)
    ref_step = jax.jit(ref_decode.decode_step, static_argnums=3)
    wl, wc = ref_decode.prefill(jp, jnp.asarray(toks[:, :16], jnp.int32),
                                cfg, max_len=24)
    gl, gc = decode.prefill(tp, torch.as_tensor(toks[:, :16]), tcfg,
                            max_len=24)
    _logit_close(gl, wl)
    for t in range(16, 24):
        nxt = toks[:, t:t + 1]
        wl, wc = ref_step(jp, jnp.asarray(nxt, jnp.int32), wc, cfg)
        gl, gc = decode.decode_step(tp, torch.as_tensor(nxt), gc, tcfg)
        _logit_close(gl, wl)
        _logit_close(gl, full[:, t].numpy())
    assert gc["pos"] == 24


def test_bf16_router_choices_and_residual_dtype(monkeypatch):
    """bf16 compute on the engines' parameters (``compute_params``): at
    every layer, fed the reference's residual, the router's probabilities
    are within 1e-5 x max of the reference's (its fp32 master router),
    its top-2 choices are the reference's, and the residual stays bf16
    as there."""
    cfg, tcfg, jp, tp = setup_arch("mixtral-8x22b", dtype="bfloat16")
    cp = transformer.compute_params(tp, tcfg)
    assert cp["layers"]["ffn"]["router"].dtype == torch.float32
    assert cp["layers"]["ffn"]["wg"].dtype == torch.bfloat16
    seen = {}
    real_top_k, real_route = jax.lax.top_k, mlp.route

    def top_k(probs, k):
        out = real_top_k(probs, k)
        seen["ref"] = (np.asarray(probs), np.asarray(out[1]))
        return out

    def route(p, x, c):
        out = real_route(p, x, c)
        seen["port"] = (out[1].numpy(), out[3].numpy())
        return out

    monkeypatch.setattr(jax.lax, "top_k", top_k)
    monkeypatch.setattr(mlp, "route", route)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (4, 32))
    x = jnp.take(jp["embed"], jnp.asarray(toks), axis=0).astype(jnp.bfloat16)
    for i in range(cfg.n_layers):
        want, _, _ = ref_tf._dense_block(
            jax.tree.map(lambda a: a[i], jp["layers"]), x, cfg)
        got, _, _ = transformer._dense_block(
            transformer.layer_params(cp["layers"], i),
            torch.as_tensor(np.array(x.astype(jnp.float32))).to(
                torch.bfloat16), tcfg)
        (wp, wi), (gp, gi) = seen["ref"], seen["port"]
        np.testing.assert_allclose(gp, wp, rtol=0, atol=1e-5 * wp.max())
        np.testing.assert_array_equal(gi, wi)
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        rel_close(got, want, 2e-2)
        x = want
