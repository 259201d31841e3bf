"""A model-mesh rank computes on its ``model`` block: each layer gathered
over the batch axes only (``models.placed``), q, k, v, the MLP's and the
experts' ``d_ff`` columns and the logits on the rank's block, each
row-parallel product reduced over ``model`` once, the training loss on
the vocab block (``train.trainer.block_cross_entropy``).

One reference subprocess (JAX, one CPU device) runs ``forward`` and
prefill + greedy decode of six reduced families (granite-8b,
mixtral-8x22b, mamba2-370m, zamba2-1.2b, whisper-small,
llama-3.2-vision-11b with its gates opened to 0.5) with its seeded
parameters; then one world of 8 gloo ranks (``dist.block_cases``) runs
each family on 2x4, granite, mixtral and whisper on 1x8 and granite on
2x2 with the same weights.
Each check is also run under a planted fault that must fail it:

* a placed layer's gathered leaves are exactly the rank's ``model``
  block, whole over ``data``, with their spans, and ``GATHERED.peak``
  over a serving forward is at most one layer's blocks plus the
  unstacked leaves' (as gathered), and on 1x8 (``data`` 1) nothing is
  gathered but the SSM mixer.  Fault: every leaf gathered over ``model``
  too (the SSM mixer is gathered whole by design and its layers set the
  bound, so mamba2's and zamba2's peaks stay under it: their embedding,
  projection and shared blocks still fail the block check);
* the logits of prefill and 3 greedy decode steps on the placed
  parameters (explicit collectives off) against the port on one device and the
  reference's (1e-5 x max|logit|, whisper 1e-4: ``ONE_TOL``,
  ``REF_TOL``), tokens equal; the sharded
  step's gathered gradients (danube, and mixtral's fallback MoE) against
  the one-device step within 1e-4 x max|g| (``test_torch_train_mesh.py``'s
  tolerance).  Fault: a
  row-parallel product left unreduced (mamba2 has none: its mixer is
  whole over ``model``);
* the vocab-block loss and its gradient with respect to the logits
  against ``common.cross_entropy`` of the whole, within 1e-6 x max|.|,
  fp32.  Fault: the log-sum-exp without the other ranks' blocks;
* explicit collectives on and off give the same greedy tokens.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.dist import block_cases as bc  # noqa: E402
from repro_torch.dist import decode_cases as dc  # noqa: E402
from repro_torch.dist import spawn  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, S, MAX_LEN, STEPS = 4, 12, 16, 3
FAMILIES = ("granite-8b", "mixtral-8x22b", "mamba2-370m", "zamba2-1.2b",
            "whisper-small", "llama-3.2-vision-11b")
#: every family on 2x4 (heads split over 4, batch over 2); on 1x8 (no
#: batch split, 4 reduced heads on 8 ranks: query rows, split kv heads)
#: the dense, MoE and encdec routes; granite on 2x2
CASES = tuple(
    [dc.DecodeCase(f"{a}/2x4", a, (2, 4)) for a in FAMILIES]
    + [dc.DecodeCase(f"{a}/1x8", a, (1, 8))
       for a in ("granite-8b", "mixtral-8x22b", "whisper-small")]
    + [dc.DecodeCase("granite-8b/2x2", "granite-8b", (2, 2))])
LABELS = [c.label for c in CASES]
MESHES = ("2x4", "1x8", "2x2")
#: the train cases the gradients run on (2x4): the dense and the fallback
#: MoE routes (``test_torch_train_mesh.py`` holds all six families' steps
#: on 2x4 and 1x8 to one device within the same 1e-4)
TRAIN_ARCHS = ("h2o-danube-1.8b", "mixtral-8x22b")
TOKENS = np.random.default_rng(3).integers(0, 256, (B, S))
#: against one device and the reference (x max|logit|); whisper's bf16
#: cross cache rounds its encoder's output, whose row-parallel sums over
#: ``model`` take another order than one device's (5e-7 x max|enc| on
#: 2x4), so a few cache elements round an ulp apart, as against the
#: reference (8.7e-5 on one device already)
ONE_TOL = {"whisper-small": 1e-4}
REF_TOL = {"whisper-small": 1e-4}
LOSS_TOL = 1e-6
GRAD_TOL = 1e-4
#: the families whose mixer holds no row-parallel product (declared)
NO_ROW_PARALLEL = ("mamba2-370m",)
#: the families with an SSM mixer, gathered whole over ``model`` (declared):
#: its layers set the gathered-bytes bound, which a planted gather of the
#: rest over ``model`` does not pass
SSM_MIXER = ("mamba2-370m", "zamba2-1.2b")

_REFERENCE = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.models import decode, forward, init_params, split

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
    walk(f"{arch}/params/", params)
    out[f"{arch}/forward"] = np.asarray(jax.jit(
        forward, static_argnums=2)(params, toks, cfg, frontend=fe)[0])
    logits, cache = jax.jit(decode.prefill, static_argnums=2,
                            static_argnames="max_len")(
        params, toks, cfg, frontend=fe, max_len=spec["max_len"])
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
    out = {}
    for arch in FAMILIES:
        cfg = dc.case_config(dc.DecodeCase(arch, arch, (1, 1)))
        if cfg.frontend_tokens:
            rng = np.random.default_rng(5)
            out[arch] = (0.5 * rng.standard_normal(
                (B, cfg.frontend_tokens, cfg.d_model))).astype(np.float32)
    return out


def _one_device(arch, params, fe):
    """The port on one device: (forward logits, greedy logits, tokens)."""
    from repro_torch import convert
    from repro_torch.dist.param_cases import greedy
    from repro_torch.models import transformer
    cfg = dc.case_config(dc.DecodeCase(arch, arch, (1, 1)))
    p = convert.params_from_reference(params, device="cpu")
    fe = None if fe is None else torch.as_tensor(fe)
    with torch.no_grad():
        fwd = transformer.forward(p, torch.as_tensor(TOKENS), cfg,
                                  frontend=fe)[0].numpy()
        _, lg, tk = greedy(p, cfg, torch.as_tensor(TOKENS), fe, MAX_LEN,
                           STEPS)
    return fwd, lg, tk


def _one_device_grads(arch):
    from repro_torch.dist import train_cases as tc
    from repro_torch.train import trainer
    case = tc.TrainCase(arch, arch, overrides=())
    cfg = tc.case_config(case)
    state = tc.case_state(case, cfg)
    _, _, g = trainer.value_and_grad(
        state.params, tc._tensors(tc.case_batch(case, cfg, 0), "cpu"), cfg)
    return tc.flat(g)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("model_block")
    fronts = _frontends()
    (tmp / "spec.json").write_text(json.dumps({
        "tokens": TOKENS.tolist(), "max_len": MAX_LEN, "steps": STEPS,
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
    ranks = spawn.run_ranks(
        bc.block_battery, 8, device="cpu",
        args=(CASES, TOKENS, fronts, {c.label: params[c.arch]
                                      for c in CASES}, MAX_LEN,
              TRAIN_ARCHS, STEPS), timeout=900)
    one = {a: _one_device(a, params[a], fronts.get(a)) for a in FAMILIES}
    grads = {a: _one_device_grads(a) for a in TRAIN_ARCHS}
    return {"ranks": ranks, "ref": flat, "one": one, "grads": grads}


def _recs(world, key):
    recs = [r[key] for r in world["ranks"] if key in r]
    assert recs, key
    return recs


def _arch(label):
    return label.split("/")[0]


def _err(got, want):
    want = np.asarray(want, np.float64)
    return (float(np.abs(np.asarray(got, np.float64) - want).max())
            / max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("label", LABELS)
def test_gathered_leaves_are_the_ranks_model_block(world, label):
    recs = _recs(world, f"blocks/{label}/None")
    assert len(recs) == (4 if label.endswith("2x2") else 8)
    for rec in recs:
        assert rec["exact"] and rec["spans"], rec
        assert rec["peak"] <= rec["bound"], rec
        if label.endswith("1x8") and _arch(label) not in SSM_MIXER:
            # data 1: the rank's blocks are what it computes on, and
            # nothing is gathered
            assert rec["peak"] == 0, rec
        else:
            assert rec["peak"] > 0, rec


@pytest.mark.parametrize("label", LABELS)
def test_planted_gather_over_model_fails_the_block_check(world, label):
    for rec in _recs(world, f"blocks/{label}/gather_model"):
        assert not rec["exact"], rec
        if _arch(label) not in SSM_MIXER:
            assert rec["peak"] > rec["bound"], rec


@pytest.mark.parametrize("label", LABELS)
def test_logits_and_tokens_against_one_device_and_the_reference(world,
                                                                label):
    arch = _arch(label)
    _, one_lg, one_tk = world["one"][arch]
    ref = world["ref"]
    for rec in _recs(world, f"greedy/{label}/None"):
        lg, tk = rec[False]
        np.testing.assert_array_equal(tk, one_tk)
        np.testing.assert_array_equal(tk, ref[f"{arch}/tokens"])
        assert _err(lg, one_lg) <= ONE_TOL.get(arch, 1e-5)
        assert _err(lg, ref[f"{arch}/logits"]) <= REF_TOL.get(arch, 1e-5)


def test_one_device_forward_against_the_reference(world):
    for arch in FAMILIES:
        fwd = world["one"][arch][0]
        assert _err(fwd, world["ref"][f"{arch}/forward"]) <= REF_TOL.get(
            arch, 1e-5), arch


@pytest.mark.parametrize("label", [lb for lb in LABELS
                                   if _arch(lb) not in NO_ROW_PARALLEL])
def test_planted_unreduced_product_fails_the_logits_check(world, label):
    _, one_lg, _ = world["one"][_arch(label)]
    errs = [_err(rec[False][0], one_lg)
            for rec in _recs(world, f"greedy/{label}/unreduced")]
    assert max(errs) > 100 * ONE_TOL.get(_arch(label), 1e-5)


@pytest.mark.parametrize("label", LABELS)
def test_explicit_collectives_on_and_off_give_the_same_tokens(world,
                                                               label):
    for rec in _recs(world, f"greedy/{label}/None"):
        np.testing.assert_array_equal(rec[True][1], rec[False][1])


@pytest.mark.parametrize("mesh", MESHES)
def test_vocab_block_loss_equals_the_whole_cross_entropy(world, mesh):
    for rec in _recs(world, f"loss/{mesh}/None"):
        assert rec["loss"] <= LOSS_TOL and rec["grad"] <= LOSS_TOL, rec


@pytest.mark.parametrize("mesh", MESHES)
def test_planted_lone_log_sum_exp_fails_the_loss_check(world, mesh):
    recs = _recs(world, f"loss/{mesh}/lse_alone")
    assert max(max(r["loss"], r["grad"]) for r in recs) > 100 * LOSS_TOL


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_gradients_against_one_device(world, arch):
    want = world["grads"][arch]
    for rec in _recs(world, f"grads/{arch}/None"):
        for path, g in want.items():
            assert _err(rec[path], g) <= GRAD_TOL, path


def test_planted_unreduced_product_fails_the_gradient_check(world):
    arch = TRAIN_ARCHS[0]
    want = world["grads"][arch]
    errs = [max(_err(rec[p], g) for p, g in want.items())
            for rec in _recs(world, f"grads/{arch}/unreduced")]
    assert max(errs) > 100 * GRAD_TOL
