"""The port's explicit tensor-parallel collectives and the models on a
rank mesh, against the reference's.

One subprocess with 8 fake XLA devices runs the reference's
``explicit_tp`` helpers under a 2x4 ``("data", "model")`` mesh (outputs,
``jax.grad`` of ``sum(out * cotangent)`` for every input, and which
fallback cases give None) and the reference's flag-on forward of reduced
granite-8b (fp32, ``d_ff=128``) and mixtral-8x22b (capacity factor 8),
sequence-parallel as ``tests/test_explicit_tp.py`` runs them, with the
default ``FULL_SCORES_MAX_LEN`` and with 16.  Then one world of 8 gloo
ranks (``dist.model_cases``) runs the port's helpers on the same numpy
inputs, each rank on its blocks, and the models on the mesh with the
reference's weights (``convert.params_from_reference``), the other
families (mamba2-370m, zamba2-1.2b, whisper-small, llama-3.2-vision-11b
with a frontend) against the port's one-device flag-off forward, on 2x4
(q heads split) and 1x8 (4 heads on 8 ranks: query rows), and
``DecodeEngine``'s greedy tokens on the mesh.

Tolerances: helper outputs and gradients within 1e-5 x max|.| (the
partial sums of a reduce-scatter add in another order); logits within
2e-3 x max|logit| (the reference test's); the gradient of an input a rank
holds whole (a weight, the K/V of the chunked attention) is the sum of
the ranks' partials, as the reference's is (``models/explicit_tp.py``;
the sharded train step sums them so: ``tests/test_torch_train_mesh.py``).
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist import model_cases as mc  # noqa: E402
from repro_torch.dist import spawn  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, S, D, F = 4, 16, 32, 64
HELPERS = tuple(mc.SPECS)
#: the fallback cases of each helper (``F % m`` where it has an F)
NONE_CASES = ("no mesh", "m=1", "S%m", "F%m", "batch")
F_HELPERS = ("project_scatter", "mlp_manual", "qkv_manual", "moe_manual")
REF_ARCHS = {"granite": ("granite-8b", (("sequence_parallel", True),
                                        ("d_ff", 128))),
             "mixtral": ("mixtral-8x22b", (("sequence_parallel", True),
                                           ("capacity_factor", 8.0)))}
OTHER = ("mamba2-370m", "zamba2-1.2b", "whisper-small",
         "llama-3.2-vision-11b")
TOKENS = np.random.default_rng(1).integers(0, 256, (4, 64))


def _inputs(b=B, s=S, d=D, f=F, seed=0):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    return {"x": n(b, s, d), "h": n(b, s, f), "w": n(f, d, scale=0.2),
            "wg": n(d, f, scale=0.2), "wu": n(d, f, scale=0.2),
            "wd": n(f, d, scale=0.2), "wq": n(d, f, scale=0.2),
            "wk": n(d, d, scale=0.2), "wv": n(d, d, scale=0.2),
            "router": n(d, 4, scale=0.2), "mwg": n(4, d, f, scale=0.2),
            "mwu": n(4, d, f, scale=0.2), "mwd": n(4, f, d, scale=0.2),
            "q": n(b, 4, s, 16), "k": n(b, 2, s, 16), "v": n(b, 2, s, 16)}


def _helper_inputs():
    ins = _inputs()
    rng = np.random.default_rng(9)
    shapes = {"gather_seq": [(B, S, D)], "project_scatter": [(B, S, D)],
              "mlp_manual": [(B, S, D)], "moe_manual": [(B, S, D)],
              "qkv_manual": [(B, S, F), (B, S, D), (B, S, D)],
              "chunked_attn_manual": [(B, 4, S, 16)]}
    for name, outs in shapes.items():
        for i, shape in enumerate(outs):
            ins[f"cot_{name}_{i}"] = rng.standard_normal(shape).astype(
                np.float32)
    return ins


def _pick(ins, name):
    return {k: ins[k] for k, _ in mc.SPECS[name][0]}


def _none_inputs():
    """case -> helper -> global inputs that make the helper decline."""
    cases = {}
    odd_s, odd_f, odd_b = _inputs(s=6), _inputs(f=6), _inputs(b=3)
    cases["S%m"] = {n: _pick(odd_s, n) for n in HELPERS}
    cases["F%m"] = {n: _pick(odd_f, n) for n in F_HELPERS}
    cases["batch"] = {n: _pick(odd_b, n) for n in HELPERS}
    cases["m=1"] = {n: _pick(_inputs(b=8), n) for n in HELPERS}
    return cases


_REFERENCE = r"""
import dataclasses, json, os, sys
import numpy as np
import jax, jax.numpy as jnp
from repro import jax_compat
from repro.configs import get_config
from repro.models import attention, explicit_tp as etp, forward, init_params
from repro.models import split

ins = dict(np.load(sys.argv[1]))
nones = json.load(open(sys.argv[2]))
spec = json.load(open(sys.argv[3]))
out_dir = sys.argv[4]
mesh = jax_compat.make_mesh((2, 4), ("data", "model"))
mesh1 = jax_compat.make_mesh((8, 1), ("data", "model"))
ARGS = spec["args"]


def moe_cfg(d, f):
    return dataclasses.replace(get_config("mixtral-8x22b").reduced(),
                               d_model=d, d_ff=f, capacity_factor=8.0)


def call(name, a):
    f32 = jnp.float32
    if name == "gather_seq":
        return etp.gather_seq(a["x"])
    if name == "project_scatter":
        return etp.project_scatter(a["h"], a["w"])
    if name == "mlp_manual":
        return etp.mlp_manual(a["x"], a["wg"], a["wu"], a["wd"], f32)
    if name == "qkv_manual":
        return etp.qkv_manual(a["x"], a["wq"], a["wk"], a["wv"], f32)
    if name == "moe_manual":
        p = {"router": a["router"], "wg": a["mwg"], "wu": a["mwu"],
             "wd": a["mwd"]}
        return etp.moe_manual(a["x"], p, moe_cfg(a["x"].shape[-1],
                                                 a["mwg"].shape[-1]), f32)
    return etp.chunked_attn_manual(a["q"], a["k"], a["v"], causal=True,
                                   window=None)


res = {}
with jax_compat.set_mesh(mesh):
    for name, names in ARGS.items():
        a = {k: jnp.asarray(ins[k]) for k in names}
        out = jax.jit(lambda a: call(name, a))(a)
        aux = None
        if name == "moe_manual":
            out, aux = out
            res[f"aux/{name}"] = np.asarray(aux)
        outs = out if isinstance(out, tuple) else (out,)
        for i, o in enumerate(outs):
            res[f"out/{name}/{i}"] = np.asarray(o)

        def loss(*vals):
            r = call(name, dict(zip(names, vals)))
            r = r[0] if name == "moe_manual" else r
            r = r if isinstance(r, tuple) else (r,)
            return sum(jnp.sum(o * jnp.asarray(ins[f"cot_{name}_{i}"]))
                       for i, o in enumerate(r))

        grads = jax.jit(jax.grad(loss, argnums=tuple(range(len(names)))))(
            *[a[k] for k in names])
        for k, g in zip(names, grads):
            res[f"grad/{name}/{k}"] = np.asarray(g)

flags = {}
for case, by_helper in nones.items():
    if case == "m=1":
        ctx = jax_compat.set_mesh(mesh1)
    else:
        ctx = jax_compat.set_mesh(mesh)
    with ctx:
        flags[case] = {n: call(n, {k: jnp.asarray(np.asarray(v, np.float32))
                                   for k, v in a.items()}) is None
                       for n, a in by_helper.items()}
flags["no mesh"] = {n: call(n, {k: jnp.asarray(np.asarray(v, np.float32))
                                for k, v in a.items()}) is None
                    for c in nones.values() for n, a in c.items()}
json.dump(flags, open(os.path.join(out_dir, "flags.json"), "w"))
np.savez(os.path.join(out_dir, "helpers.npz"), **res)

toks = jnp.asarray(np.asarray(spec["tokens"], np.int32))
models = {}
params_out = {}
for label, (arch, overrides) in spec["models"].items():
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              explicit_collectives=True, **dict(overrides))
    params, _ = split(init_params(jax.random.PRNGKey(0), cfg))
    params_out[label] = params
    for full_max in (None, 16):
        keep = attention.FULL_SCORES_MAX_LEN
        if full_max:
            attention.FULL_SCORES_MAX_LEN = full_max
        with jax_compat.set_mesh(mesh):
            logits, _, _ = jax.jit(lambda p, t: forward(p, t, cfg))(params,
                                                                   toks)
        attention.FULL_SCORES_MAX_LEN = keep
        models[f"{label}/{full_max}"] = np.asarray(logits)
np.savez(os.path.join(out_dir, "models.npz"), **models)
flat = {}


def walk(prefix, tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            walk(prefix + k + "/", v)
        else:
            flat[prefix + k] = np.asarray(v)


for label, params in params_out.items():
    walk(label + "/", jax.tree.map(np.asarray, params))
np.savez(os.path.join(out_dir, "params.npz"), **flat)
print("REFERENCE_OK")
"""


def _nest(flat, label):
    tree = {}
    for key, v in flat.items():
        parts = key.split("/")
        if parts[0] != label:
            continue
        d = tree
        for p in parts[1:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return tree


def _model_cases():
    cases = []
    for full_max in (None, 16):
        for label, (arch, ov) in REF_ARCHS.items():
            cases.append(mc.ModelCase(f"{label}/{full_max}", arch, (2, 4),
                                      ov, full_max))
        for arch in OTHER:
            for shape in ((2, 4), (1, 8)):
                cases.append(mc.ModelCase(
                    f"{arch}/{shape[0]}x{shape[1]}/{full_max}", arch, shape,
                    (("sequence_parallel", True),), full_max))
    return cases


MODEL_CASES = _model_cases()
DECODE = mc.ModelCase("decode/granite", "granite-8b", (2, 4),
                      (("sequence_parallel", True),))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("explicit_tp")
    ins = _helper_inputs()
    nones = _none_inputs()
    np.savez(tmp / "ins.npz", **ins)
    (tmp / "nones.json").write_text(json.dumps(
        {c: {n: {k: v.tolist() for k, v in a.items()}
             for n, a in h.items()} for c, h in nones.items()}))
    (tmp / "spec.json").write_text(json.dumps({
        "args": {n: [k for k, _ in mc.SPECS[n][0]] for n in HELPERS},
        "tokens": TOKENS.tolist(),
        "models": {k: [a, [list(o) for o in ov]]
                   for k, (a, ov) in REF_ARCHS.items()}}))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "")
                               .split(os.pathsep) if p])
    ref = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(tmp / "ins.npz"),
         str(tmp / "nones.json"), str(tmp / "spec.json"), str(tmp)],
        env=env, capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stdout[-2000:] + ref.stderr[-4000:]
    params = dict(np.load(tmp / "params.npz"))
    ref_params = {c.label: _nest(params, c.label.split("/")[0])
                  for c in MODEL_CASES if c.label.split("/")[0] in REF_ARCHS}
    port = spawn.run_ranks(mc.mesh_battery, 8, device="cpu",
                           args=(ins, nones, MODEL_CASES, TOKENS, ref_params,
                                 DECODE), timeout=240)
    return {"port": port, "helpers": dict(np.load(tmp / "helpers.npz")),
            "models": dict(np.load(tmp / "models.npz")),
            "flags": json.loads((tmp / "flags.json").read_text())}


def _sizes():
    return dict(zip(mc.AXES, mc.HELPER_MESH))


def _assemble(recs, name, key, shape, spec):
    """The global gradient from every rank's: each rank's block placed
    where its spec cuts it, partials of a block held whole summed."""
    out = np.zeros(shape, np.float64)
    for rec in recs:
        idx = []
        for d, entry in enumerate(spec):
            if entry is None:
                idx.append(slice(None))
                continue
            axis = "data" if entry == "rows" else "model"
            step = shape[d] // _sizes()[axis]
            c = rec["coord"][axis]
            idx.append(slice(c * step, (c + 1) * step))
        out[tuple(idx)] += rec["grads"][name][key]
    return out


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("name", HELPERS)
def test_helper_outputs_match_the_reference(both, name):
    recs = both["port"]["helpers"]
    outs = mc.SPECS[name][1]
    for rec in recs:
        for i, spec in enumerate(outs):
            want = mc.block(both["helpers"][f"out/{name}/{i}"], spec,
                            rec["coord"], _sizes())
            assert rec["outs"][name][i].shape == want.shape
            _close(rec["outs"][name][i], want)
    if name == "moe_manual":
        # averaged over the batch axes only: equal on the ranks of one
        # model row, the reference's value
        for rec in recs:
            assert abs(rec["aux"] - float(both["helpers"][
                "aux/moe_manual"])) <= 1e-5 * abs(rec["aux"])


@pytest.mark.parametrize("name", HELPERS)
def test_helper_gradients_match_the_reference(both, name):
    recs = both["port"]["helpers"]
    for key, spec in mc.SPECS[name][0]:
        want = both["helpers"][f"grad/{name}/{key}"]
        got = _assemble(recs, name, key, want.shape, spec)
        _close(got, want)


@pytest.mark.parametrize("name,case", [(n, c) for c in NONE_CASES
                                       for n in HELPERS
                                       if c != "F%m" or n in F_HELPERS])
def test_fallback_cases_return_none_in_both(both, name, case):
    ref = both["flags"][case]
    for rec in both["port"]["helpers"]:
        assert rec["none"][case][name] is True
    assert ref[name] is True


def test_helpers_apply_on_the_mesh(both):
    # the battery's own inputs take the manual path in both packages
    for rec in both["port"]["helpers"]:
        assert all(o is not None for o in rec["outs"].values())


@pytest.mark.parametrize("label", [c.label for c in MODEL_CASES
                                   if c.label.split("/")[0] in REF_ARCHS])
def test_dense_and_moe_on_the_mesh_match_the_reference(both, label):
    rec = both["port"]["models"][label]
    want = both["models"][label]
    assert rec["agree"], "the ranks returned different logits"
    assert rec["logits"].shape == want.shape
    _close(rec["logits"], want, 2e-3)


def _one_device(case):
    cfg = mc.model_config(case, flag=False)
    params = mc.model_params(case, cfg)
    fe = mc.model_inputs(case, TOKENS)
    with torch.no_grad():
        return transformer.forward(
            params, torch.as_tensor(TOKENS), cfg,
            frontend=None if fe is None else torch.as_tensor(fe))[0].numpy()


@pytest.mark.parametrize("label", [c.label for c in MODEL_CASES
                                   if c.label.split("/")[0] in OTHER])
def test_other_families_on_the_mesh_match_one_device(both, label):
    case = next(c for c in MODEL_CASES if c.label == label)
    from repro_torch.models import attention
    keep = attention.FULL_SCORES_MAX_LEN
    attention.FULL_SCORES_MAX_LEN = case.full_max or keep
    try:
        want = _one_device(case)
    finally:
        attention.FULL_SCORES_MAX_LEN = keep
    rec = both["port"]["models"][label]
    assert rec["agree"]
    _close(rec["logits"], want, 2e-3)


def test_decode_engine_on_the_mesh_matches_one_device(both):
    from repro_torch.serve.engine import DecodeEngine, ServeConfig
    cfg = mc.model_config(DECODE)
    eng = DecodeEngine(mc.model_params(DECODE, cfg), cfg,
                       ServeConfig(max_new_tokens=mc.DECODE_TOKENS),
                       device="cpu")
    want, _ = eng.generate(TOKENS[:, :TOKENS.shape[1] // 2])
    np.testing.assert_array_equal(both["port"]["decode"], want)


# ---------------------------------------------------------------------------
# the flash kernel's q_offset, plain versions against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None)])
@pytest.mark.parametrize("off", [0, 32, 80])
def test_flash_plain_q_offset_matches_the_reference(causal, window, off):
    import jax
    import jax.numpy as jnp
    from repro.kernels import ref as rref
    rng = np.random.default_rng(off)
    q = rng.standard_normal((2, 4, 32, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 112, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 112, 16)).astype(np.float32)
    g = rng.standard_normal((2, 4, 32, 16)).astype(np.float32)
    want = rref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window, q_offset=off)
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    out, lse = fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                        window=window, q_offset=off,
                                        bkv=16, return_lse=True)
    _close(out.numpy(), np.asarray(want), 1e-5)
    wgrads = jax.grad(lambda a, b, c: jnp.sum(rref.attention_ref(
        a, b, c, causal=causal, window=window, q_offset=off) * g),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = fa.flash_attention_backward_plain(
        tq, tk, tv, out, torch.as_tensor(g), lse, causal=causal,
        window=window, q_offset=off)
    for got, wnt in zip(grads, wgrads):
        _close(got.numpy(), np.asarray(wnt), 1e-4)
    # the Function routes q_offset to both plain halves on the CPU
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    o = fa.FlashAttentionFn.apply(*leaves, causal, window, off)
    (o * torch.as_tensor(g)).sum().backward()
    for leaf, wnt in zip(leaves, wgrads):
        _close(leaf.grad.numpy(), np.asarray(wnt), 1e-4)


def test_flash_q_offset_on_the_card_has_no_backward_yet(monkeypatch):
    # the backward kernels take q_offset now: a CUDA tensor under
    # autograd with q_offset goes through FlashAttentionFn to the forward
    # and backward launches, each handed the offset, and never to the
    # plain version (the library is a recording stand-in)
    calls = []

    class Lib:
        def flash_attention_launch(self, *a):
            calls.append(("forward", a[18]))
            return 0

        def flash_attention_backward_launch(self, *a):
            calls.append(("backward", a[25]))
            return 0

    def plain(*a, **k):
        calls.append("plain")
        raise AssertionError("the plain version ran on the card path")
    monkeypatch.setattr(fa, "_on_cpu", lambda *xs: False)
    monkeypatch.setattr(fa, "_stream", lambda: 0)
    monkeypatch.setattr(fa._build, "library", lambda name: Lib())
    monkeypatch.setattr(fa, "flash_attention_plain", plain)
    monkeypatch.setattr(fa, "flash_attention_backward_plain", plain)
    fa.reset_launches()
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    k = torch.randn(1, 1, 24, 16, requires_grad=True)
    out = fa.flash_attention(q, k, k, q_offset=8)
    assert "FlashAttentionFn" in type(out.grad_fn).__name__
    torch.autograd.grad(out, (q, k), torch.ones_like(out))
    assert calls == [("forward", 8), ("backward", 8)]
    assert fa.launches == {"flash_attention": 1,
                           "flash_attention_backward": 1}
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention_backward(q, k, k, q, q, torch.zeros(1, 2, 8),
                                    q_offset=-1)


def test_reduced_configs_split_heads_on_2x4_and_rows_on_1x8():
    cfg = get_config("granite-8b").reduced()
    assert cfg.n_heads % 4 == 0 and cfg.n_heads % 8 != 0
    assert TOKENS.shape[1] % 8 == 0
