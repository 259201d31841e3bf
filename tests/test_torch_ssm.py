"""The port's Mamba-2 path against the reference, on the CPU: the SSD
oracles and the scan kernel's plain version, the SSM block, the hybrid
grouping, caches, parameters, and serving the ssm and hybrid families.

Inputs are made with numpy from a seed and go through the reference
function and its port counterpart; model parameters come from the
reference's initializer and cross over with
``convert.params_from_reference``.  The reference's SSD Pallas kernel
runs in ``interpret=True`` mode.  Tolerances: SSD outputs and states
within rtol = atol = 2e-4 (the reference's own SSD tolerance: the
chunked and sequential sums round apart); SSM block outputs and caches
within 1e-4 (XLA and PyTorch sum in other orders); greedy tokens and
slot-engine tokens exactly.  Reduced configs (``.reduced()``: d=64, SSM
state 16, head dim 16, chunk 8, conv window 4; mamba2 2 layers, zamba2 4
with the shared block every 2).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import decode as ref_decode  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.models import split  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.serve import DecodeEngine as RefDecodeEngine  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.kernels import ops, ref, ssd_scan  # noqa: E402
from repro_torch.models import decode, ssm, transformer  # noqa: E402
from repro_torch.serve import DecodeEngine, SlotEngine  # noqa: E402

SSM_ARCHS = ["mamba2-370m", "zamba2-1.2b"]
CPU = "cpu"
TOL = 2e-4


def ssd_inputs(B=2, L=128, H=4, P=16, G=2, N=8, seed=0):
    """The reference's ``tests/test_kernels.py`` SSD inputs: dt in
    [0.1, 1), a in (-1.5, -0.5]."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = (0.1 + 0.9 * rng.random((B, L, H))).astype(np.float32)
    a = (-0.5 - rng.random(H)).astype(np.float32)
    b = rng.standard_normal((B, L, G, N)).astype(np.float32)
    c = rng.standard_normal((B, L, G, N)).astype(np.float32)
    return x, dt, a, b, c


def both(args):
    return ([jnp.asarray(v) for v in args],
            [torch.as_tensor(v) for v in args])


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# the SSD: port against the reference's interpret-mode kernel and oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("chunk", [8, 16, 32, 64])
def test_ssd_matches_interpret_kernel(chunk, G):
    j, t = both(ssd_inputs(G=G, H=4))
    want = ref_ops.ssd(*j, chunk=chunk, interpret=True)
    got = ops.ssd(*t, chunk=chunk)
    assert got.shape == want.shape and got.dtype == torch.float32
    close(got, want)
    close(got, jref.ssd_chunked_ref(*j, chunk=chunk)[0])


@pytest.mark.parametrize("L,chunk", [(37, 37), (74, 37), (24, 12)])
def test_ssd_ragged_chunk(L, chunk):
    """Chunks that are no power of two, as ``min(ssm_chunk, l)`` gives
    for short prompts."""
    j, t = both(ssd_inputs(B=1, L=L, H=2, P=8, G=1, N=16, seed=L))
    want = ref_ops.ssd(*j, chunk=chunk, interpret=True)
    close(ops.ssd(*t, chunk=chunk), want)


@pytest.mark.parametrize("chunk", [16, 64])
def test_ssd_final_state_matches_sequential_oracle(chunk):
    j, t = both(ssd_inputs(L=128, seed=1))
    want_y, want_h = jref.ssd_ref(*j)
    y, h = ssd_scan.ssd_scan(*t, chunk=chunk)
    assert h.shape == (2, 4, 8, 16) and h.dtype == torch.float32
    close(y, want_y)
    close(h, want_h)


def test_ssd_chunked_ref_and_ssd_ref_match_the_reference():
    j, t = both(ssd_inputs(L=64, seed=2))
    h0 = np.random.default_rng(3).standard_normal((2, 4, 8, 16)).astype(
        np.float32)
    for name in ("ssd_ref", "ssd_chunked_ref"):
        kw = {"chunk": 16} if name == "ssd_chunked_ref" else {}
        wy, wh = getattr(jref, name)(*j, h0=jnp.asarray(h0), **kw)
        gy, gh = getattr(ref, name)(*t, h0=torch.as_tensor(h0), **kw)
        close(gy, wy)
        close(gh, wh)


def test_ssd_xla_backend_is_the_oracle():
    j, t = both(ssd_inputs(L=32, seed=5))
    close(ops.ssd(*t, chunk=16, backend="xla"),
          ref_ops.ssd(*j, chunk=16, backend="xla"))
    with pytest.raises(ValueError, match="backend"):
        ops.ssd(*t, chunk=16, backend="pallas")


def test_ssd_scan_rejects_bad_shapes():
    x, dt, a, b, c = (torch.as_tensor(v) for v in ssd_inputs(L=24))
    with pytest.raises(ValueError, match="divisible by chunk"):
        ssd_scan.ssd_scan(x, dt, a, b, c, chunk=16)
    with pytest.raises(ValueError, match="groups"):
        ssd_scan.ssd_scan(x[:, :, :3], dt[:, :, :3], a[:3], b, c, chunk=8)
    with pytest.raises(ValueError, match="takes x"):
        ssd_scan.ssd_scan(x, dt, a, b, c[..., :4], chunk=8)
    with pytest.raises(ValueError, match="disagree"):
        ssd_scan.ssd_scan(x, dt[:1], a, b, c, chunk=8)
    with pytest.raises(ValueError, match="disagree"):
        ssd_scan.ssd_scan(x, dt, a[:2], b, c, chunk=8)


@pytest.mark.parametrize("arch,length", [("zamba2-1.2b", 1536),
                                         ("mamba2-370m", 1472)])
def test_ssd_launch_plan_fills_the_card(arch, length):
    # at each model's longest serve prefill the chunk-output grid shares
    # C B^T over the largest head block, 4 heads, and still gives each of
    # the 132 SMs a CTA
    cfg = get_config(arch)
    h, g = cfg.ssm_heads, cfg.ssm_groups
    n, p, q = cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_chunk
    plan = ssd_scan.launch_plan(1, length, h, g, n, p, q)
    nc = length // q
    assert plan == (nc, ssd_scan.HEAD_BLOCK, nc * h * (n * p + 1))
    assert nc * g * -(-(h // g) // plan.head_block) >= 132


@pytest.mark.parametrize("arch,length,block", [("zamba2-1.2b", 512, 2),
                                               ("zamba2-1.2b", 256, 1),
                                               ("mamba2-370m", 1024, 2),
                                               ("mamba2-370m", 512, 1)])
def test_ssd_launch_plan_halves_at_short_prefills(arch, length, block):
    # shorter serve prefills have too few chunks for 4 heads a CTA to
    # give each SM one: the block halves until the grid does
    cfg = get_config(arch)
    h, g = cfg.ssm_heads, cfg.ssm_groups
    plan = ssd_scan.launch_plan(1, length, h, g, cfg.ssm_state,
                                cfg.ssm_head_dim, cfg.ssm_chunk)
    nc = length // cfg.ssm_chunk
    assert plan.head_block == block
    assert nc * g * -(-(h // g) // block) >= 132
    assert nc * g * -(-(h // g) // (2 * block)) < 132


def test_ssd_launch_plan_small_and_empty():
    # the head block halves until every SM has a CTA, down to one head a
    # CTA; with no chunks the scratch is empty
    assert ssd_scan.launch_plan(2, 3 * 37, 4, 2, 16, 24, 37) == (
        3, 1, 2 * 3 * 4 * (16 * 24 + 1))
    assert ssd_scan.launch_plan(1, 8 * 64, 64, 1, 64, 64, 64).head_block == 2
    assert ssd_scan.launch_plan(1, 0, 4, 1, 16, 24, 16) == (0, 1, 0)


@pytest.mark.parametrize("arch,blocks,smem", [("mamba2-370m", 8, 112_768),
                                               ("zamba2-1.2b", 16, 77_952)])
def test_ssd_backward_plan_at_the_training_shape(arch, blocks, smem):
    # batch 4 x 2048: 4 heads a CTA of the backward's chunk kernels (1024
    # CTAs for mamba2-370m's 32 heads, 2048 for zamba2-1.2b's 64), two
    # CTAs an SM; the work buffer holds the state gradients, the da terms
    # and the blocks' dB and dC
    cfg = get_config(arch)
    h, g = cfg.ssm_heads, cfg.ssm_groups
    n, p, q = cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_chunk
    plan = ssd_scan.backward_plan(4, 2048, h, g, n, p, q)
    nc = 2048 // q
    assert (plan.n_chunks, plan.head_block, plan.blocks) == (nc, 4, blocks)
    assert plan.grid == (nc, g * blocks, 4)
    assert nc * g * blocks * 4 == {8: 1024, 16: 2048}[blocks]
    assert plan.chunk_smem == smem and plan.ctas_per_sm == 2
    assert plan.dstate_smem == {8: 52_224, 16: 35_840}[blocks]
    assert plan.work == (4 * nc * h * n * p + 4 * nc * h
                         + 2 * 4 * 2048 * g * blocks * n)


@pytest.mark.parametrize("bsz,length,h,g,hb,blocks", [
    (2, 2048, 12, 2, 4, 2),      # 6 heads a group: blocks of 4 and 2
    (2, 1024, 8, 8, 4, 1),       # one head a group
    (2, 640, 8, 2, 1, 4),        # 40 CTAs at 4 heads: halves down to 1
    (2, 768, 12, 2, 2, 3),       # 144 CTAs at 2 heads, 96 at 4
    (2, 3 * 37, 4, 2, 1, 2)])
def test_ssd_backward_plan_ragged_heads(bsz, length, h, g, hb, blocks):
    # the forward's rule: the largest of 4, 2, 1 heads a CTA that gives the
    # 132 SMs a CTA each; a group's last block may hold fewer heads
    q = 37 if length % 64 else 64
    plan = ssd_scan.backward_plan(bsz, length, h, g, 64, 64, q)
    assert (plan.head_block, plan.blocks) == (hb, blocks)
    ctas = plan.grid[0] * plan.grid[1] * plan.grid[2]
    assert plan.grid[1] == g * blocks
    assert ctas >= 132 or hb == 1
    if hb < 4:
        assert plan.grid[0] * g * -(-(h // g) // (2 * hb)) * bsz < 132
    partials = 2 * bsz * length * g * blocks * 64 if blocks > 1 else 0
    assert plan.work == (bsz * plan.n_chunks * h * 64 * 64
                         + -(-bsz * plan.n_chunks * h // 4) * 4 + partials)


def test_ssd_backward_plan_takes_a_head_block():
    plan = ssd_scan.backward_plan(2, 3 * 37, 12, 2, 16, 24, 37, head_block=4)
    assert (plan.head_block, plan.blocks, plan.grid) == (4, 2, (3, 4, 2))
    assert ssd_scan.backward_plan(2, 3 * 37, 6, 1, 16, 24, 37,
                                  head_block=3).blocks == 2
    for bad in (0, 5):
        with pytest.raises(ValueError, match="head_block"):
            ssd_scan.backward_plan(1, 64, 4, 1, 16, 16, 64, head_block=bad)
    assert ssd_scan.backward_plan(1, 0, 4, 1, 16, 24, 16).work == 0


@pytest.mark.parametrize("n", [16, 64, 96, 128])
def test_ssd_backward_shared_memory_fits_the_sm(n):
    # both chunk kernels fit a CTA's 227 KB, and the chunk kernel two
    # CTAs (16 warps) an SM at both state widths
    plan = ssd_scan.backward_plan(4, 2048, 32, 1, n, 64, 64)
    assert plan.dstate_smem <= 232_448 and plan.chunk_smem <= 232_448
    assert plan.ctas_per_sm >= 2
    assert plan.ctas_per_sm * (plan.chunk_smem + 1024) <= 233_472
    assert plan.ctas_per_sm * 256 // 32 >= 16


@pytest.mark.parametrize("h,g", [(12, 2), (4, 1)])
def test_ssd_backward_work_buffer_is_the_plans(monkeypatch, h, g):
    # _backward allocates the plan's work buffer and hands the kernel the
    # plan's head block (the library is a stand-in that launches nothing)
    calls, sizes = [], []

    class Lib:
        def ssd_scan_backward_launch(self, *args):
            calls.append(args)
            return 0
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        sizes.append(t.numel())
        return t
    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(ssd_scan._build, "library", lambda stem: Lib())
    monkeypatch.setattr(ssd_scan, "_stream", lambda: 0)
    x, dt, a, b, c = (torch.as_tensor(v) for v in ssd_inputs(
        B=2, L=111, H=h, P=24, G=g, N=16))
    ops_ = ssd_scan._operands(x, dt, a, b, c)
    scratch = torch.zeros(ssd_scan.launch_plan(2, 111, h, g, 16, 24,
                                               37).scratch)
    ssd_scan._backward(*ops_, torch.ones_like(x), None, scratch, 37)
    plan = ssd_scan.backward_plan(2, 111, h, g, 16, 24, 37)
    assert len(calls) == 1 and plan.work in sizes
    assert calls[0][-2] == plan.head_block          # before the stream


def test_ssd_runs_the_plain_version_on_the_cpu():
    ssd_scan.reset_launches()
    ops.ssd(*both(ssd_inputs(L=16))[1], chunk=8)
    assert ssd_scan.launches["ssd_scan"] == 0


# ---------------------------------------------------------------------------
# the SSM block
# ---------------------------------------------------------------------------

_SETUP = {}


def setup_arch(arch, n_layers=None):
    """(reference cfg, port cfg, reference params, port params)."""
    key = (arch, n_layers)
    if key not in _SETUP:
        cfg, tcfg = ref_config(arch).reduced(), get_config(arch).reduced()
        if n_layers:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
            tcfg = dataclasses.replace(tcfg, n_layers=n_layers)
        jp = jax.tree.map(np.asarray, split(
            ref_init_params(jax.random.PRNGKey(0), cfg))[0])
        _SETUP[key] = (cfg, tcfg, jp, params_from_reference(jp, device=CPU))
    return _SETUP[key]


def _layer(arch, i=1):
    cfg, tcfg, jp, tp = setup_arch(arch)
    return (cfg, tcfg, jax.tree.map(lambda a: a[i], jp["layers"]["ssm"]),
            {k: v[i] for k, v in tp["layers"]["ssm"].items()})


@pytest.mark.parametrize("L", [8, 13, 20])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_apply_ssm_prefill_collects_cache(arch, L):
    """L = 13 and 20 pad to the chunk (8): the padded steps carry dt = 0,
    and the conv window is cut from the unpadded input."""
    cfg, tcfg, pj, pt = _layer(arch)
    x = np.random.default_rng(L).standard_normal(
        (2, L, cfg.d_model)).astype(np.float32)
    want, wc = jax.jit(ref_ssm.apply_ssm, static_argnums=2,
                       static_argnames="collect_cache")(
        pj, jnp.asarray(x), cfg, collect_cache=True)
    got, gc = ssm.apply_ssm(pt, torch.as_tensor(x), tcfg, collect_cache=True)
    close(got, want, 1e-4)
    assert gc["conv"].dtype == gc["state"].dtype == torch.float32
    close(gc["conv"], wc["conv"], 1e-4)
    close(gc["state"], wc["state"], 1e-4)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_apply_ssm_decode_returns_new_tensors(arch):
    cfg, tcfg, pj, pt = _layer(arch)
    rng = np.random.default_rng(9)
    conv = rng.standard_normal((3, cfg.conv_kernel - 1,
                                ssm.conv_dim(tcfg))).astype(np.float32)
    state = rng.standard_normal((3, cfg.ssm_heads, cfg.ssm_state,
                                 cfg.ssm_head_dim)).astype(np.float32)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    want, wc = jax.jit(ref_ssm.apply_ssm, static_argnums=2)(
        pj, jnp.asarray(x), cfg, cache={"conv": jnp.asarray(conv),
                                        "state": jnp.asarray(state)})
    cache = {"conv": torch.as_tensor(conv.copy()),
             "state": torch.as_tensor(state.copy())}
    got, gc = ssm.apply_ssm(pt, torch.as_tensor(x), tcfg, cache=cache)
    close(got, want, 1e-4)
    close(gc["conv"], wc["conv"], 1e-4)
    close(gc["state"], wc["state"], 1e-4)
    # the given lanes are untouched: the slot engine selects old vs new
    assert gc["conv"] is not cache["conv"] and gc["state"] is not cache[
        "state"]
    np.testing.assert_array_equal(cache["conv"].numpy(), conv)
    np.testing.assert_array_equal(cache["state"].numpy(), state)


def test_make_ssm_cache_matches_reference():
    cfg, tcfg, _, _ = setup_arch("mamba2-370m")
    want = ref_ssm.make_ssm_cache(cfg, 3)
    got = ssm.make_ssm_cache(tcfg, 3)
    for leaf in ("conv", "state"):
        assert tuple(got[leaf].shape) == want[leaf].shape
        assert got[leaf].dtype == torch.float32
    assert ssm.conv_dim(tcfg) == ref_ssm.conv_dim(cfg)


def test_ssm_mesh_branch_falls_back():
    """With ``explicit_collectives`` and no mesh ``gather_seq`` returns
    None, so the block equals the flag-off one bit for bit (prefill and
    decode), and the reference's flag-on block within 1e-4."""
    cfg, tcfg, pj, pt = _layer("mamba2-370m")
    etp = dataclasses.replace(tcfg, explicit_collectives=True)
    x = np.random.default_rng(31).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    on, con = ssm.apply_ssm(pt, torch.as_tensor(x), etp, collect_cache=True)
    off, coff = ssm.apply_ssm(pt, torch.as_tensor(x), tcfg,
                              collect_cache=True)
    assert torch.equal(on, off)
    assert all(torch.equal(con[k], coff[k]) for k in coff)
    want, _ = jax.jit(ref_ssm.apply_ssm, static_argnums=2)(
        pj, jnp.asarray(x), dataclasses.replace(cfg,
                                                explicit_collectives=True))
    close(on, want, 1e-4)
    step = torch.as_tensor(x[:, :1])
    d_on, _ = ssm.apply_ssm(pt, step, etp, cache=con)
    d_off, _ = ssm.apply_ssm(pt, step, tcfg, cache=coff)
    assert torch.equal(d_on, d_off)


# ---------------------------------------------------------------------------
# hybrid grouping, parameters, caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_layers", [4, 5, 38])
def test_hybrid_groups_and_shared_positions(n_layers):
    cfg = dataclasses.replace(ref_config("zamba2-1.2b").reduced(),
                              n_layers=n_layers)
    tcfg = dataclasses.replace(get_config("zamba2-1.2b").reduced(),
                               n_layers=n_layers)
    n_apps, gsz, tail = ref_tf.hybrid_groups(cfg)
    assert transformer.hybrid_groups(tcfg) == (n_apps, gsz, tail)
    after = [transformer.shared_after(tcfg, i) for i in range(n_layers)]
    assert [i for i, g in enumerate(after) if g is not None] == [
        (gi + 1) * gsz - 1 for gi in range(n_apps)]
    assert [g for g in after if g is not None] == list(range(n_apps))
    assert transformer.shared_after(get_config("mamba2-370m"), 5) is None


def test_full_zamba2_has_six_groups_and_a_tail_of_two():
    assert transformer.hybrid_groups(get_config("zamba2-1.2b")) == (6, 6, 2)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_init_params_keys_shapes_and_scales(arch):
    cfg, tcfg, jp, _ = setup_arch(arch)
    got = transformer.init_params(torch.Generator().manual_seed(0), tcfg)

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}
    assert shapes(got) == jax.tree.map(lambda a: tuple(a.shape), jp,
                                       is_leaf=lambda a: hasattr(a, "shape"))
    lay = got["layers"]["ssm"]
    np.testing.assert_allclose(lay["a_log"].numpy(), jp["layers"]["ssm"][
        "a_log"], rtol=1e-6)
    assert torch.equal(lay["d_skip"], torch.ones_like(lay["d_skip"]))
    assert abs(float(lay["conv_w"].std()) - 0.1) < 0.01
    if arch == "zamba2-1.2b":
        assert got["shared"]["attn"]["wq"].dim() == 2      # unstacked


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_params_from_reference_carries_the_ssm_trees(arch):
    _, _, jp, tp = setup_arch(arch)
    assert set(tp) == set(jp)
    for k, v in jp["layers"]["ssm"].items():
        np.testing.assert_array_equal(tp["layers"]["ssm"][k].numpy(), v)
        assert tp["layers"]["ssm"][k].dtype == torch.float32
    if arch == "zamba2-1.2b":
        assert set(tp["shared"]) == {"ln1", "ln2", "attn", "mlp"}
        np.testing.assert_array_equal(tp["shared"]["mlp"]["wd"].numpy(),
                                      jp["shared"]["mlp"]["wd"])


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_compute_params_keeps_the_ssm_scalars_fp32(arch):
    _, tcfg, _, tp = setup_arch(arch)
    cp = transformer.compute_params(tp, dataclasses.replace(
        tcfg, dtype="bfloat16"))
    lay = cp["layers"]["ssm"]
    for leaf in ("conv_w", "conv_b", "a_log", "d_skip", "dt_bias",
                 "norm_g"):
        assert lay[leaf].dtype == torch.float32, leaf
        assert torch.equal(lay[leaf], tp["layers"]["ssm"][leaf])
    assert lay["in_proj"].dtype == lay["out_proj"].dtype == torch.bfloat16
    assert cp["layers"]["ln1"].dtype == torch.float32
    if arch == "zamba2-1.2b":
        assert cp["shared"]["ln1"].dtype == torch.float32
        assert cp["shared"]["attn"]["wq"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_init_cache_layout_with_fp32_ssm_leaves(arch, dtype):
    cfg, tcfg, jp, tp = setup_arch(arch)
    want = ref_decode.init_cache(jp, cfg, 3, 40)
    got = decode.init_cache(tp, tcfg, 3, 40, dtype=dtype)
    assert got["pos"] == 0 and set(got) == set(want)
    for leaf in ("conv", "state"):
        assert tuple(got["ssm"][leaf].shape) == want["ssm"][leaf].shape
        assert got["ssm"][leaf].dtype == torch.float32
    if arch == "zamba2-1.2b":
        for leaf in ("k", "v"):
            assert tuple(got["shared"][leaf].shape) == \
                want["shared"][leaf].shape
            assert got["shared"][leaf].dtype == dtype
    meta = decode.init_cache(tp, tcfg, 3, 40, device="meta")
    assert meta["ssm"]["state"].is_meta


def test_forward_bf16_compute_params_equal_masters():
    """Casting once (compute_params) changes no logit in bf16: the SSM
    scalars stay fp32 on both routes."""
    _, tcfg, _, tp = setup_arch("zamba2-1.2b", 5)
    bcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    toks = torch.arange(11)[None] % tcfg.vocab
    la = transformer.forward(tp, toks, bcfg)[0]
    lb = transformer.forward(transformer.compute_params(tp, bcfg), toks,
                             bcfg)[0]
    assert torch.equal(la, lb)


# ---------------------------------------------------------------------------
# serving the ssm and hybrid families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_decode_engine_greedy_tokens_equal_reference(arch):
    cfg, tcfg, jp, tp = setup_arch(arch)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 12)).astype(np.int32)
    want, wstats = RefDecodeEngine(jp, cfg).generate(prompts,
                                                     max_new_tokens=10)
    got, stats = DecodeEngine(tp, tcfg, device=CPU).generate(
        prompts, max_new_tokens=10)
    np.testing.assert_array_equal(got, want)
    assert stats == wstats


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_slot_engine_idle_lanes_do_not_change(arch):
    _, tcfg, _, tp = setup_arch(arch)
    eng = SlotEngine(tp, tcfg, capacity=3, max_context=32, page_size=8,
                     device=CPU)
    rng = np.random.default_rng(7)
    for s in (6, 9):
        eng.insert(rng.integers(0, tcfg.vocab, (s,)).astype(np.int32),
                   max_new_tokens=5)
    eng.step()
    slot, _ = eng.insert(rng.integers(0, tcfg.vocab, (7,)).astype(
        np.int32), max_new_tokens=5)
    eng.evict(0)                     # slot 0 idle from here on
    before = {p: v.clone() for p, v in eng.cache.lanes.items()}
    assert set(before) == {("ssm", "conv"), ("ssm", "state")}
    eng.step()
    for path, old in before.items():
        new = eng.cache.lanes[path]
        assert new.dtype == torch.float32
        assert torch.equal(new[:, 0], old[:, 0]), path   # idle: frozen
        assert not torch.equal(new[:, slot], old[:, slot]), path


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_slot_engine_conv_window_floor(arch):
    _, tcfg, _, tp = setup_arch(arch)
    eng = SlotEngine(tp, tcfg, capacity=2, max_context=16, page_size=8,
                     device=CPU)
    with pytest.raises(ValueError, match="conv window"):
        eng.insert(np.zeros((tcfg.conv_kernel - 2,), np.int32),
                   max_new_tokens=2)
    assert eng.insert(np.zeros((tcfg.conv_kernel - 1,), np.int32),
                      max_new_tokens=2) is not None


def test_slot_engine_geometry_of_lane_only_and_mixed_caches():
    """mamba2 has no paged leaf: one page a slot, lanes only; zamba2
    pages its shared K/V and keeps its SSM leaves as lanes."""
    _, mcfg, _, mp = setup_arch("mamba2-370m")
    eng = SlotEngine(mp, mcfg, capacity=2, max_context=32, page_size=8,
                     device=CPU)
    lay = eng.cache.layout
    assert lay.paged == () and lay.pages_per_slot == 1
    assert lay.seq_len == 8 and eng.cache.pools == {}
    _, zcfg, _, zp = setup_arch("zamba2-1.2b")
    eng = SlotEngine(zp, zcfg, capacity=2, max_context=32, page_size=8,
                     device=CPU)
    lay = eng.cache.layout
    assert [p for p, _ in lay.paged] == [("shared", "k"), ("shared", "v")]
    assert lay.pages_per_slot == 4
    assert eng.cache.lanes[("ssm", "state")].shape == (
        zcfg.n_layers, 2, zcfg.ssm_heads, zcfg.ssm_state, zcfg.ssm_head_dim)
