"""The port's sharded train step on a model mesh, against the port's
one-device step and the reference's ``make_sharded_train_step``.

One subprocess with 8 fake XLA CPU devices runs the reference: the
parameters' logical axes and ``state_shardings`` of every family (fp32
and 8-bit moments) on 2x4, 4x2, 1x8 ``("data", "model")`` and 2x2x2
``("pod", "data", "model")``, ``batch_shardings``, and its jitted sharded
step (under its mesh, explicit collectives on) on reduced granite-8b and
mixtral-8x22b on 2x4, started from the port's seeded parameters.  While
it runs, one world of 8 gloo ranks (``dist.train_cases``) runs the port's
sharded step: each family on 2x4 and on 1x8 (4 heads on 8 ranks: query
rows), granite with 8-bit moments, the flag-on mixtral of the reference
comparison, a repeat of one case, and a planted fault (the loss counted
whole on every rank).

Tolerances (``PERF.md`` §2): the first batch's loss within 1e-5 x |loss|
and each gathered gradient leaf within 1e-4 x max|g| of the one-device
step; the parameters after 3 steps within 1e-5 x max|p| for the dense
family, else within the larger of that and 2e-2 x the summed lr (Adam's
eps turns last-bit gradient differences into update differences:
``tests/test_torch_train.py``).  The MoE's one-device case on 2x4 runs
the fallback MoE (explicit collectives off), whose aux loss is the global
one; ``moe_manual`` averages the shards' aux losses, as the reference's
does, which is another number once the batch splits: the flag-on mixtral
is held to the reference's sharded step.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.dist import spawn  # noqa: E402
from repro_torch.dist import train_cases as tc  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAMILIES = {"dense": "h2o-danube-1.8b", "moe": "mixtral-8x22b",
            "ssm": "mamba2-370m", "hybrid": "zamba2-1.2b",
            "encdec": "whisper-small", "vlm": "llama-3.2-vision-11b"}
SPEC_ARCHS = ("granite-8b",) + tuple(FAMILIES.values())
SPEC_MESHES = {"2x4": ((2, 4), ("data", "model")),
               "4x2": ((4, 2), ("data", "model")),
               "1x8": ((1, 8), ("data", "model")),
               "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
#: the fallback MoE: explicit collectives off (the module docstring)
FALLBACK = (("sequence_parallel", True),)
UPDATE_TOL = 2e-2


def _family_cases():
    cases = []
    for fam, arch in FAMILIES.items():
        for shape in ((2, 4), (1, 8)):
            ov = FALLBACK if fam == "moe" and shape[0] > 1 else tc.FLAGS
            cases.append(tc.TrainCase(f"{fam}/{shape[0]}x{shape[1]}", arch,
                                      shape, ov))
    return cases


FAMILY_CASES = _family_cases()
REF_CASES = [tc.TrainCase("ref/granite", "granite-8b"),
             tc.TrainCase("ref/mixtral", "mixtral-8x22b")]
EXTRA = [tc.TrainCase("dense/2x4/again", FAMILIES["dense"]),
         tc.TrainCase("q8/granite", "granite-8b", bits=8, steps=1),
         tc.TrainCase("planted", "granite-8b", steps=0, planted=True)]
CASES = FAMILY_CASES + REF_CASES + EXTRA


_REFERENCE = r"""
import dataclasses, json, os, sys
import numpy as np
import jax, jax.numpy as jnp
from repro import jax_compat
from repro.configs import get_config
from repro.data import pipeline
from repro.models import common, transformer
from repro.optim import adamw
from repro.train import trainer

spec = json.load(open(sys.argv[1]))
given = dict(np.load(sys.argv[2]))
out_dir = sys.argv[3]


def walk(prefix, t, out):
    if isinstance(t, dict):
        for k in sorted(t):
            walk(f"{prefix}/{k}", t[k], out)
    elif isinstance(t, adamw.Q8):
        walk(prefix + "/q", t.q, out)
        walk(prefix + "/scale", t.scale, out)
    elif isinstance(t, tuple) and hasattr(t, "_fields"):
        for f in t._fields:
            walk(f"{prefix}/{f}", getattr(t, f), out)
    else:
        out[prefix] = t
    return out


strings = {}
for arch in spec["spec_archs"]:
    cfg = get_config(arch).reduced()
    axes = common.split(transformer.init_params(jax.random.PRNGKey(0),
                                                cfg))[1]
    for path, a in walk("", axes, {}).items():
        strings[f"axes/{arch}{path}"] = str(a.axes)
    for bits in (32, 8):
        opt = adamw.AdamWConfig(state_bits=bits)
        shape = jax.eval_shape(lambda: trainer.init_state(
            jax.random.PRNGKey(0), cfg, opt)[0])
        for name, (mshape, names) in spec["meshes"].items():
            mesh = jax_compat.make_mesh(tuple(mshape), tuple(names))
            st = trainer.state_shardings(shape, axes, mesh)
            for path, ns in walk("", st, {}).items():
                strings[f"spec/{arch}/{name}/{bits}{path}"] = str(ns.spec)
for name, (mshape, names) in spec["meshes"].items():
    mesh = jax_compat.make_mesh(tuple(mshape), tuple(names))
    for wf in (False, True):
        for k, ns in trainer.batch_shardings(mesh, wf).items():
            strings[f"batch/{name}/{wf}/{k}"] = str(ns.spec)
json.dump(strings, open(os.path.join(out_dir, "specs.json"), "w"))

steps = {}
for label, arch, overrides, mshape, n_steps, seq, batch in spec["steps"]:
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              **dict(overrides))
    opt = adamw.AdamWConfig(**dict(spec["opt"]))
    params = {}
    for key, v in given.items():
        if not key.startswith(label + "/"):
            continue
        parts = key[len(label) + 1:].split("/")
        d = params
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = jnp.asarray(v)
    state = trainer.TrainState(params, adamw.init(params, opt))
    axes = common.split(transformer.init_params(jax.random.PRNGKey(0),
                                                cfg))[1]
    mesh = jax_compat.make_mesh(tuple(mshape), ("data", "model"))
    with jax_compat.set_mesh(mesh):
        step, st_sh, b_sh = trainer.make_sharded_train_step(
            cfg, opt, mesh, state, axes, donate=False)
        state = jax.device_put(state, st_sh)
        for i in range(n_steps):
            b = pipeline._batch_numpy(pipeline.DataConfig(
                vocab=cfg.vocab, seq_len=seq, global_batch=batch), i)
            state, m = step(state, jax.device_put(
                {k: jnp.asarray(v) for k, v in b.items()}, b_sh))
            for k, v in m.items():
                steps[f"{label}/metrics/{i}/{k}"] = np.asarray(v)
    for path, v in walk("", state.params, {}).items():
        steps[f"{label}/params{path}"] = np.asarray(v)
np.savez(os.path.join(out_dir, "steps.npz"), **steps)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_mesh")
    given = {}
    for c in REF_CASES:
        state = tc.case_state(c, tc.case_config(c))
        for path, v in tc.flat(state.params).items():
            given[c.label + path] = v
    np.savez(tmp / "params.npz", **given)
    (tmp / "spec.json").write_text(json.dumps({
        "spec_archs": SPEC_ARCHS,
        "meshes": {k: [list(s), list(n)] for k, (s, n)
                   in SPEC_MESHES.items()},
        "opt": [list(o) for o in tc.OPT],
        "steps": [[c.label, c.arch, [list(o) for o in c.overrides],
                   list(c.mesh), c.steps, c.seq, c.batch]
                  for c in REF_CASES]}))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "")
                               .split(os.pathsep) if p])
    # the reference and the port's ranks run side by side
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(tmp / "spec.json"),
         str(tmp / "params.npz"), str(tmp)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = spawn.run_ranks(tc.train_battery, 8, device="cpu",
                               args=(CASES,), timeout=300)
        out, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, out[-2000:] + err[-4000:]
    return {"port": port,
            "specs": json.loads((tmp / "specs.json").read_text()),
            "steps": dict(np.load(tmp / "steps.npz"))}


@pytest.fixture(scope="module")
def one_device():
    return {c.label: tc.one_device(c) for c in FAMILY_CASES + EXTRA[1:2]}


def _walk(prefix, t, out):
    """The reference walker's paths over the port's state trees."""
    if isinstance(t, dict):
        for k in sorted(t):
            _walk(f"{prefix}/{k}", t[k], out)
    elif isinstance(t, adamw.Q8):
        _walk(prefix + "/q", t.q, out)
        _walk(prefix + "/scale", t.scale, out)
    elif isinstance(t, tuple) and hasattr(t, "_fields"):
        for f in t._fields:
            _walk(f"{prefix}/{f}", getattr(t, f), out)
    else:
        out[prefix] = t
    return out


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / scale


# ---------------------------------------------------------------------------
# axes and specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_param_axes_match_the_reference(both, arch):
    from repro_torch.configs import get_config
    got = {f"axes/{arch}{p}": str(a.axes) for p, a in _walk(
        "", transformer.param_axes(get_config(arch).reduced()), {}).items()}
    want = {k: v for k, v in both["specs"].items()
            if k.startswith(f"axes/{arch}/")}
    assert got == want


@pytest.mark.parametrize("bits", [32, 8])
@pytest.mark.parametrize("mesh", list(SPEC_MESHES))
@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_state_specs_match_the_reference(both, arch, mesh, bits):
    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced()
    state = trainer.init_state(torch.Generator().manual_seed(0), cfg,
                               adamw.AdamWConfig(state_bits=bits))
    shape, names = SPEC_MESHES[mesh]
    st = trainer.state_shardings(state, transformer.param_axes(cfg),
                                 dict(zip(names, shape)))
    got = {f"spec/{arch}/{mesh}/{bits}{p}": str(s)
           for p, s in _walk("", st, {}).items()}
    want = {k: v for k, v in both["specs"].items()
            if k.startswith(f"spec/{arch}/{mesh}/{bits}/")}
    assert got == want


@pytest.mark.parametrize("mesh", list(SPEC_MESHES))
def test_batch_specs_match_the_reference(both, mesh):
    shape, names = SPEC_MESHES[mesh]
    for wf in (False, True):
        got = {f"batch/{mesh}/{wf}/{k}": str(s) for k, s in
               trainer.batch_shardings(dict(zip(names, shape)), wf).items()}
        want = {k: v for k, v in both["specs"].items()
                if k.startswith(f"batch/{mesh}/{wf}/")}
        assert got == want


# ---------------------------------------------------------------------------
# the sharded step against the one-device step
# ---------------------------------------------------------------------------

def _hold_to(rec, want, dense):
    assert abs(rec["loss0"] - want["loss0"]) <= 1e-5 * abs(want["loss0"])
    for path, g in want["grads0"].items():
        assert _rel(rec["grads0"][path], g) <= 1e-4, path
    lr_sum = 0.0
    for got_m, want_m in zip(rec["metrics"], want["metrics"]):
        assert abs(got_m["loss"] - want_m["loss"]) <= 1e-5 * abs(
            want_m["loss"])
        assert abs(got_m["grad_norm"] - want_m["grad_norm"]) <= 1e-5 * abs(
            want_m["grad_norm"])
        lr_sum += want_m["lr"]
    for path, w in want["params"].items():
        scale = float(np.abs(w).max())
        tol = 1e-5 * scale if dense else max(1e-5 * scale,
                                             UPDATE_TOL * lr_sum)
        assert float(np.abs(rec["params"][path] - w).max()) <= tol, path


@pytest.mark.parametrize("label", [c.label for c in FAMILY_CASES])
def test_sharded_step_matches_one_device(both, one_device, label):
    rec = both["port"][label]
    assert rec["agree"], "the ranks' replicated blocks differ"
    assert len(rec["metrics"]) == 3
    _hold_to(rec, one_device[label], dense=label.startswith("dense"))


def test_sharded_step_with_q8_moments_matches_one_device(both, one_device):
    # one step: an 8-bit moment rounds v to a code, and a code that
    # flips on a last-bit gradient difference moves its element by up to
    # lr * m / eps in the next step, so later steps are held to the
    # update fed one gradient (below)
    rec = both["port"]["q8/granite"]
    assert rec["agree"]
    _hold_to(rec, {**one_device["q8/granite"], "params": {}}, dense=True)


def test_sharded_q8_update_equals_one_device_bit_for_bit(both):
    # the same gradients (global norm below 1: the clip factor is 1)
    # through the sharded update and adamw.apply_updates: parameters,
    # codes and scales equal
    case = next(c for c in EXTRA if c.bits == 8)
    got = both["port"][f"updates/{case.label}"]
    want = tc.updates(case)
    for path, p in want["params"].items():
        np.testing.assert_array_equal(got["params"][path], p)
    assert len(got["moments"]) == len(want["moments"])
    for a, b in zip(got["moments"], want["moments"]):
        np.testing.assert_array_equal(a, b)


def test_planted_double_counted_loss_fails_the_gradient_check(
        both, one_device):
    # the same granite step as the q8 case's first gradient (fp32 and 8-bit
    # moments give the same gradient), the loss counted whole on 8 ranks
    rec, want = both["port"]["planted"], one_device["q8/granite"]
    errs = [_rel(rec["grads0"][p], g) for p, g in want["grads0"].items()]
    assert min(errs) > 1e-4
    with pytest.raises(AssertionError):
        _hold_to(rec, {**want, "metrics": [], "params": {}}, dense=True)


def test_sharded_step_is_deterministic(both):
    a, b = both["port"]["dense/2x4"], both["port"]["dense/2x4/again"]
    assert a["metrics"] == b["metrics"]
    for path in a["params"]:
        np.testing.assert_array_equal(a["params"][path], b["params"][path])
    for path in a["grads0"]:
        np.testing.assert_array_equal(a["grads0"][path], b["grads0"][path])


# ---------------------------------------------------------------------------
# the sharded step against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", [c.label for c in REF_CASES])
def test_sharded_step_matches_the_references(both, label):
    rec, ref = both["port"][label], both["steps"]
    assert rec["agree"]
    lr_sum = 0.0
    for i, m in enumerate(rec["metrics"]):
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            want = float(ref[f"{label}/metrics/{i}/{k}"])
            assert abs(m[k] - want) <= 1e-5 * max(abs(want), 1e-6), (i, k)
        lr_sum += m["lr"]
    dense = label == "ref/granite"
    for path, p in rec["params"].items():
        w = ref[f"{label}/params{path}"]
        scale = float(np.abs(w).max())
        tol = 1e-5 * scale if dense else max(1e-5 * scale,
                                             UPDATE_TOL * lr_sum)
        assert float(np.abs(p - w).max()) <= tol, path
