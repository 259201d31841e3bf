"""Serving with parameters placed by ``launch.specs.param_shardings``
(``models.placed``), against the port's whole-parameter run and the
reference's ``models.decode.prefill`` / ``decode_step``.

The reference's serving cells place the bf16 parameters with
``param_shardings``: FSDP over ``data`` on the ``embed`` dim, ``model``
on heads, kv, mlp, vocab and ssm_inner.  One reference subprocess (JAX,
one CPU device) runs prefill and 8 greedy decode steps of each case with
its own seeded parameters; then one world of 8 gloo ranks
(``dist.param_cases``) runs every case on its ``("data", "model")`` mesh
with the same weights (``convert.params_from_reference``), once whole
and once placed (``placed.place_params``: each rank keeps its blocks and
gathers one layer whole while it runs).

Cases: reduced granite-8b, mixtral-8x22b, mamba2-370m, zamba2-1.2b,
whisper-small and llama-3.2-vision-11b (gates opened to 0.5) on 2x4 and
1x8, and granite on 2x2.  Each placed run is held to

* the port's whole-parameter run on the same mesh: the hidden states
  handed to the output projection bit-identical (the gathered layers are
  the whole weights, the embedding is one value plus zeros), the logits
  within 1e-6 x max|logit| (the rank projects onto its vocab block,
  whose product may sum in another order), the greedy tokens equal;
* the reference's: greedy tokens equal, logits within 1e-5 x max|logit|
  (whisper-small 1e-4, as in ``test_torch_placed_decode.py``: its bf16
  cross cache rounds an ulp apart on one device already);
* the rank's parameter storage: exactly the bytes of its blocks under
  the specs, each block a tensor of its own.

Then the serving engines built on the 2x4 mesh (each places the whole
parameters itself) against the whole-parameter engines on one device:
``SlotEngine`` drives ``serve_selftest``'s two requests, eviction and
churn bit-identically with one decode build; ``ContinuousServer`` over
one and ``DecodeEngine`` return the same tokens.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.dist import decode_cases as dc  # noqa: E402
from repro_torch.dist import param_cases as pc  # noqa: E402
from repro_torch.dist import spawn  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, S, MAX_LEN = 4, 12, 24
FAMILIES = ("granite-8b", "mixtral-8x22b", "mamba2-370m", "zamba2-1.2b",
            "whisper-small", "llama-3.2-vision-11b")
CASES = tuple(
    [dc.DecodeCase(f"{a}/{m[0]}x{m[1]}", a, m)
     for a in FAMILIES for m in ((2, 4), (1, 8))]
    + [dc.DecodeCase("granite-8b/2x2", "granite-8b", (2, 2))])
LABELS = [c.label for c in CASES]
SLOT_LABEL = "granite-8b/2x4"
TOKENS = np.random.default_rng(3).integers(0, 256, (B, S))
PROMPTS = [np.random.default_rng(0).integers(0, 256, (s,)).astype(np.int32)
           for s in (9, 14)]
#: the whole-parameter yardstick and the reference's
WHOLE_TOL = 1e-6
REF_TOL = {"whisper-small": 1e-4}

_REFERENCE = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.models import decode, init_params, split

spec = json.load(open(sys.argv[1]))
toks = jnp.asarray(np.asarray(spec["tokens"], np.int32))
out = {}


def walk(prefix, tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            walk(prefix + k + "/", v)
        else:
            out[prefix + k] = np.asarray(jnp.asarray(v, jnp.float32))


for arch in spec["archs"]:
    cfg = get_config(arch).reduced()
    params, _ = split(init_params(jax.random.PRNGKey(0), cfg))
    params = jax.tree.map(np.asarray, params)
    if "cross_layers" in params:
        params["cross_layers"]["gate"] = np.full_like(
            params["cross_layers"]["gate"], 0.5)
    fe = spec["frontends"].get(arch)
    fe = None if fe is None else jnp.asarray(np.asarray(fe, np.float32))
    logits, cache = jax.jit(decode.prefill, static_argnums=2,
                            static_argnames="max_len")(
        params, toks, cfg, frontend=fe, max_len=spec["max_len"])
    walk(f"{arch}/params/", params)
    step = jax.jit(decode.decode_step, static_argnums=3)
    lg, tk = [np.asarray(logits)], []
    for _ in range(spec["steps"]):
        nxt = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        tk.append(np.asarray(nxt))
        logits, cache = step(params, nxt, cache, cfg)
        lg.append(np.asarray(logits))
    out[f"{arch}/logits"] = np.stack(lg)
    out[f"{arch}/tokens"] = np.concatenate(tk, axis=1)
np.savez(sys.argv[2], **out)
print("REFERENCE_OK")
"""


def _frontends():
    """{arch: (B, F, D)} for the families with a frontend."""
    out = {}
    for arch in FAMILIES:
        cfg = dc.case_config(dc.DecodeCase(arch, arch, (1, 1)))
        if cfg.frontend_tokens:
            rng = np.random.default_rng(5)
            out[arch] = (0.5 * rng.standard_normal(
                (B, cfg.frontend_tokens, cfg.d_model))).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("placed_params")
    fronts = _frontends()
    (tmp / "spec.json").write_text(json.dumps({
        "tokens": TOKENS.tolist(), "max_len": MAX_LEN, "steps": dc.STEPS,
        "archs": list(FAMILIES),
        "frontends": {k: v.tolist() for k, v in fronts.items()}}))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "")
                               .split(os.pathsep) if p])
    ref = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(tmp / "spec.json"),
         str(tmp / "ref.npz")], env=env, capture_output=True, text=True,
        timeout=300)
    assert ref.returncode == 0, ref.stdout[-2000:] + ref.stderr[-4000:]
    flat = dict(np.load(tmp / "ref.npz"))
    params = {}
    for arch in FAMILIES:
        pre = f"{arch}/params/"
        params[arch] = dc.nest({k[len(pre):]: v for k, v in flat.items()
                                if k.startswith(pre)})
    port = spawn.run_ranks(
        pc.placed_battery, 8, device="cpu",
        args=(CASES, TOKENS, {c.label: fronts[c.arch] for c in CASES
                              if c.arch in fronts},
              {c.label: params[c.arch] for c in CASES}, MAX_LEN,
              SLOT_LABEL, PROMPTS), timeout=240)
    return {"port": port, "ref": flat}


def _arch(label):
    return next(c.arch for c in CASES if c.label == label)


def _close(got, want, tol):
    want = np.asarray(want, np.float64)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    scale = float(np.abs(want).max())
    assert err <= tol * scale, (err, scale, err / scale)


@pytest.mark.parametrize("label", LABELS)
def test_hidden_states_equal_the_whole_parameters_bit_for_bit(both, label):
    for rec in both["port"][label]:
        hw, _, _ = rec["whole"]
        hp, _, _ = rec["placed"]
        assert hp.shape == hw.shape
        np.testing.assert_array_equal(hp, hw)


@pytest.mark.parametrize("label", LABELS)
def test_logits_and_tokens_against_the_whole_parameters(both, label):
    recs = both["port"][label]
    for rec in recs:
        _, lw, tw = rec["whole"]
        _, lp, tp = rec["placed"]
        np.testing.assert_array_equal(tp, tw)
        _close(lp, lw, WHOLE_TOL)
        # every rank returns the same (global) logits
        np.testing.assert_array_equal(lp, recs[0]["placed"][1])


@pytest.mark.parametrize("label", LABELS)
def test_placed_serving_against_the_reference(both, label):
    arch = _arch(label)
    want_logits = both["ref"][f"{arch}/logits"]
    want_tokens = both["ref"][f"{arch}/tokens"]
    for rec in both["port"][label]:
        _, lp, tp = rec["placed"]
        assert lp.shape == want_logits.shape
        np.testing.assert_array_equal(tp, want_tokens)
        _close(lp, want_logits, REF_TOL.get(arch, 1e-5))


@pytest.mark.parametrize("label", LABELS)
def test_each_rank_holds_exactly_its_spec_blocks(both, label):
    case = next(c for c in CASES if c.label == label)
    recs = both["port"][label]
    assert len(recs) == case.mesh[0] * case.mesh[1]
    for rec in recs:
        assert rec["copies"]
        assert rec["held_bytes"] == rec["spec_bytes"]
        # a placed rank holds less than a whole tree: every case splits
        # the embedding's vocab rows over model
        assert rec["held_bytes"] < rec["whole_bytes"]


def test_slot_engine_on_placed_parameters(both):
    """The engine built on the 2x4 mesh places the whole tree itself and
    decodes bit-identically to the whole-parameter engine on one device,
    its step built once, each rank holding its blocks alone."""
    drives = both["port"]["slots"]
    assert len(drives) == 8
    for d in drives:
        got, want = d["got"]["slots"], d["want"]["slots"]
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert d["compiles"] == 1
        assert d["held_bytes"] == d["spec_bytes"]


@pytest.mark.parametrize("engine", ["server", "decode"])
def test_serving_engines_on_placed_parameters(both, engine):
    """``ContinuousServer`` over a slot engine built on the mesh, and
    ``DecodeEngine`` built on it: every request's tokens equal the
    whole-parameter engine's on one device, on every rank."""
    for d in both["port"]["slots"]:
        got, want = d["got"][engine], d["want"][engine]
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
