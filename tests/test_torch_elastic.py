"""Elastic training on a model mesh: the port's checkpoints across mesh
shapes, ``TrainDriver(mesh=)`` with a failure and a re-mesh, both against
one device and the reference, and ``launch.specs`` against the
reference's.

One world of 8 gloo ranks (``dist.train_cases.elastic_battery``) runs
the port: (a) reduced granite-8b states (fp32 and 8-bit moments, seeded
nonzero) placed on 2x4 and saved, restored onto 4x2, 1x8, a 2x2 mesh of
the first four ranks and one device, and at permuted coordinates (a
planted fault); (b) the reduced granite driver on 2x4 failing at step 3
and restarted by ``run_with_restarts`` onto 4x2; (c) the driver on 2x4
from a checkpoint of the port's seeded state; (d) reference checkpoints
restored onto 2x4.  Beside it one subprocess on 8 fake XLA devices runs
the reference: ``launch.specs`` of every cell on 2x4 and 2x2x2, its
``TrainDriver(mesh=make_host_mesh(2, 4))`` from the same seeded
checkpoint, and its ``restore(shardings=)`` of the port's 2x4
checkpoints.

Tolerances: restored blocks bit for bit; losses within 1e-5 x |loss| and
parameters within 1e-5 x max|p| of one device's uninterrupted run and of
the reference's mesh driver (``tests/test_torch_train_mesh.py``'s limits
for the dense family); specs, shapes, dtypes and counts equal.
"""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import store as ref_store  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.train import trainer as ref_trainer  # noqa: E402

from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.dist import spawn  # noqa: E402
from repro_torch.dist import train_cases as tc  # noqa: E402
from repro_torch.dist.comm_engine import Spec  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "granite-8b"
RUN = tc.ELASTIC_RUN
DRIVER_STEPS = 4
SPEC_MESHES = {"2x4": ((2, 4), ("data", "model")),
               "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
CELLS = [(m, a, s) for m in SPEC_MESHES for a, s in specs.all_cells()]
TARGETS = ("2x4", "4x2", "1x8", "2x2", "one device")


_REFERENCE = r"""
import dataclasses, json, os, sys, time
import numpy as np
import jax
from jax.sharding import NamedSharding
from repro import jax_compat
from repro.checkpoint import store
from repro.configs import ARCH_IDS, get_config
from repro.data.pipeline import DataConfig
from repro.launch import specs
from repro.launch.mesh import make_host_mesh
from repro.optim import adamw
from repro.runtime.driver import RunConfig, TrainDriver
from repro.train import trainer

spec = json.load(open(sys.argv[1]))
out_dir = sys.argv[2]


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
    elif isinstance(t, (tuple, list)):
        for i, x in enumerate(t):
            walk(f"{prefix}/{i}", x, out)
    elif isinstance(t, NamedSharding):
        out[prefix] = str(t.spec)
    elif t is None:
        out[prefix] = "None"
    else:
        out[prefix] = f"{tuple(t.shape)} {t.dtype}"
    return out


cells = {}
for name, (mshape, names) in spec["meshes"].items():
    mesh = jax_compat.make_mesh(tuple(mshape), tuple(names))
    for arch, sname in specs.all_cells():
        c = specs.input_specs(arch, sname, mesh)
        cells[f"{name}/{arch}/{sname}"] = {
            "kind": c.kind, "args": walk("", c.args, {}),
            "in": walk("", c.in_shardings, {}),
            "out": walk("", c.out_shardings, {}), "donate": list(c.donate),
            "model_flops": c.model_flops, "tokens": c.tokens}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        params, axes = specs.params_struct(cfg)
        cells[f"{name}/{arch}/params"] = {
            "struct": walk("", params, {}),
            "specs": walk("", specs.param_shardings(params, axes, cfg, mesh),
                          {})}
cells["skipped"] = [list(x) for x in specs.skipped_cells()]
json.dump(cells, open(os.path.join(out_dir, "cells.json"), "w"))

cfg = dataclasses.replace(get_config(spec["arch"]).reduced(),
                          **dict(spec["flags"]))
opt = adamw.AdamWConfig(**dict(spec["opt"]))
mesh = make_host_mesh(2, 4)
with jax_compat.set_mesh(mesh):
    d = TrainDriver(cfg, opt, DataConfig(vocab=cfg.vocab, seq_len=spec["seq"],
                                         global_batch=spec["batch"]),
                    RunConfig(total_steps=spec["driver_steps"],
                              ckpt_every=100, ckpt_dir=spec["ref_driver"],
                              log_every=1), mesh=mesh)
    start = d.start_step
    out = d.run()
driver = {"start_step": start, "metrics": out["metrics"]}

restored = {}
deadline = time.monotonic() + 240
for label, (path, bits) in spec["port_ckpts"].items():
    while not store.list_steps(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no port checkpoint in {path}")
        time.sleep(0.2)
    state, axes = trainer.init_state(jax.random.PRNGKey(0), cfg,
                                     adamw.AdamWConfig(state_bits=bits))
    st_sh = trainer.state_shardings(state, axes, mesh)
    got, step, _ = store.restore(path, state, shardings=st_sh)
    with np.load(os.path.join(path, f"step_{step:08d}", "arrays.npz")) as f:
        arrays = {k: f[k] for k in f.files}
    flat = store._flatten_with_paths(got)
    placed = all(a.sharding == s for a, s in zip(
        jax.tree.leaves(got), jax.tree.leaves(st_sh)))
    restored[label] = {
        "mismatches": sorted(k for k, v in flat.items()
                             if not np.array_equal(v, arrays[k])),
        "keys_equal": sorted(flat) == sorted(arrays), "placed": placed}
json.dump({"driver": driver, "restored": restored},
          open(os.path.join(out_dir, "runs.json"), "w"))
print("REFERENCE_OK")
"""


def _ref_checkpoint(path, bits, seed):
    """A reference train state of reduced granite, every leaf seeded
    (nonzero moments, Q8 codes and scales), saved by the reference."""
    cfg = ref_config(ARCH).reduced()
    state, _ = ref_trainer.init_state(
        jax.random.PRNGKey(seed), cfg,
        ref_adamw.AdamWConfig(state_bits=bits))
    rng = np.random.default_rng(seed)

    def fill(x):
        x = np.asarray(x)
        if x.dtype == np.int8:
            return rng.integers(-127, 128, x.shape).astype(np.int8)
        if x.dtype == np.int32:
            return np.asarray(seed, np.int32)
        return rng.standard_normal(x.shape).astype(x.dtype)
    ref_store.save(str(path), 3, jax.tree.map(fill, state))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    case = tc.TrainCase("driver", ARCH)
    cfg = tc.case_config(case)
    store.save(str(tmp / "seeded_port"), 0, tc.case_state(case, cfg))
    shutil.copytree(tmp / "seeded_port", tmp / "seeded_ref")
    foreign = {}
    for bits in (32, 8):
        _ref_checkpoint(tmp / f"ref{bits}", bits, seed=bits)
        foreign[f"ref/{bits}"] = (str(tmp / f"ref{bits}"), bits)
    (tmp / "spec.json").write_text(json.dumps({
        "meshes": {k: [list(s), list(n)] for k, (s, n)
                   in SPEC_MESHES.items()},
        "arch": ARCH, "flags": [list(f) for f in tc.FLAGS],
        "opt": [list(o) for o in tc.OPT], "seq": case.seq,
        "batch": case.batch, "driver_steps": DRIVER_STEPS,
        "ref_driver": str(tmp / "seeded_ref"),
        "port_ckpts": {f"port/{bits}": [str(tmp / "port" / f"mesh{bits}"),
                                        bits] for bits in (32, 8)}}))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "")
                               .split(os.pathsep) if p])
    # the reference and the port's ranks run side by side
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(tmp / "spec.json"),
         str(tmp)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        port = spawn.run_ranks(tc.elastic_battery, 8, device="cpu", args=({
            "root": str(tmp / "port"), "foreign": foreign,
            "seeded": str(tmp / "seeded_port"), "steps": RUN,
            "driver_steps": DRIVER_STEPS},), timeout=300)
        out, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, out[-2000:] + err[-4000:]
    return {"port": port, "tmp": tmp,
            "cells": json.loads((tmp / "cells.json").read_text()),
            "runs": json.loads((tmp / "runs.json").read_text())}


@pytest.fixture(scope="module")
def one_device(tmp_path_factory):
    path = tmp_path_factory.mktemp("one_device")
    rec = tc.one_device_run(tc.TrainCase("run", ARCH), str(path), RUN[0])
    return {**rec, "arrays": tc.ckpt_arrays(str(path))}


def _by_step(metrics_logs):
    """{step: loss} over drivers in order, a later driver's step winning
    (a restart repeats the steps after its checkpoint)."""
    out = {}
    for log in metrics_logs:
        for m in log:
            out[m["step"]] = m["loss"]
    return out


def _params_within(got, want, tol=1e-5):
    keys = [k for k in want if k.startswith(".params/")]
    assert keys and sorted(k for k in got if k.startswith(".params/")) == \
        sorted(keys)
    for k in keys:
        scale = float(np.abs(want[k]).max())
        assert float(np.abs(got[k] - want[k]).max()) <= tol * scale, k


# ---------------------------------------------------------------------------
# (a) elastic restore
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [32, 8])
def test_mesh_checkpoint_holds_the_logical_state(both, bits):
    for r in both["port"]:
        assert r[f"restore/{bits}"]["saved"] == [], r["rank"]
    path = both["tmp"] / "port" / f"mesh{bits}"
    assert store.list_steps(str(path)) == [1]
    assert not [p for p in os.listdir(path) if p.startswith("tmp.")]


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("bits", [32, 8])
def test_elastic_restore_is_bit_exact(both, bits, target):
    for r in both["port"]:
        got = r[f"restore/{bits}"][target]
        if target == "2x2" and r["rank"] >= 4:
            assert got == "idle"
        else:
            assert got == [], (r["rank"], got[:5])


@pytest.mark.parametrize("bits", [32, 8])
def test_blocks_at_permuted_coordinates_fail_the_check(both, bits):
    for r in both["port"]:
        assert r[f"restore/{bits}"]["permuted"], r["rank"]


# ---------------------------------------------------------------------------
# (b) the elastic run; (c) against the reference's mesh driver
# ---------------------------------------------------------------------------

def test_elastic_run_restarts_onto_another_mesh(both):
    total, every, fail_at = RUN
    for r in both["port"]:
        run = r["run"]
        assert run["restarts"] == 1 and run["final_step"] == total
        assert run["start_step"] == (fail_at // every) * every
        assert run["restored"] == [], r["rank"]
        assert [m["step"] for m in run["metrics"][0]] == list(
            range(1, fail_at + 1))


def test_elastic_run_matches_one_device(both, one_device):
    want = _by_step([one_device["metrics"]])
    for r in both["port"]:
        got = _by_step(r["run"]["metrics"])
        assert sorted(got) == sorted(want) == list(range(1, RUN[0] + 1))
        for s, loss in want.items():
            assert abs(got[s] - loss) <= 1e-5 * abs(loss), (r["rank"], s)
    got = tc.ckpt_arrays(str(both["tmp"] / "port" / "run"))
    assert store.latest_step(str(both["tmp"] / "port" / "run")) == RUN[0]
    _params_within(got, one_device["arrays"])


def test_mesh_driver_matches_the_references(both):
    ref = both["runs"]["driver"]
    assert ref["start_step"] == 0
    for r in both["port"]:
        assert r["driver"]["start_step"] == 0
        got, want = r["driver"]["metrics"], ref["metrics"]
        assert [m["step"] for m in got] == [m["step"] for m in want] == \
            list(range(1, DRIVER_STEPS + 1))
        for a, b in zip(got, want):
            for k in ("loss", "grad_norm", "lr"):
                assert abs(a[k] - b[k]) <= 1e-5 * abs(b[k]), (r["rank"], k)
    for d in ("seeded_port", "seeded_ref"):
        assert store.latest_step(str(both["tmp"] / d)) == DRIVER_STEPS
    _params_within(tc.ckpt_arrays(str(both["tmp"] / "seeded_port")),
                   tc.ckpt_arrays(str(both["tmp"] / "seeded_ref")))


# ---------------------------------------------------------------------------
# (d) checkpoints across the packages on a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [32, 8])
def test_reference_checkpoint_restores_onto_the_port_mesh(both, bits):
    for r in both["port"]:
        assert r["foreign"][f"ref/{bits}"] == [], r["rank"]


@pytest.mark.parametrize("bits", [32, 8])
def test_port_mesh_checkpoint_restores_through_the_reference(both, bits):
    rec = both["runs"]["restored"][f"port/{bits}"]
    assert rec == {"mismatches": [], "keys_equal": True, "placed": True}


# ---------------------------------------------------------------------------
# (e) the cells' structs and specs against the reference's
# ---------------------------------------------------------------------------

def _walk(prefix, t, out):
    """The reference walker's paths and leaf strings over the port's."""
    if isinstance(t, dict):
        for k in sorted(t):
            _walk(f"{prefix}/{k}", t[k], out)
    elif isinstance(t, adamw.Q8):
        _walk(prefix + "/q", t.q, out)
        _walk(prefix + "/scale", t.scale, out)
    elif isinstance(t, Spec):
        out[prefix] = str(t)
    elif isinstance(t, tuple) and hasattr(t, "_fields"):
        for f in t._fields:
            _walk(f"{prefix}/{f}", getattr(t, f), out)
    elif isinstance(t, (tuple, list)):
        for i, x in enumerate(t):
            _walk(f"{prefix}/{i}", x, out)
    elif t is None:
        out[prefix] = "None"
    else:
        assert t.device.type == "meta", prefix
        out[prefix] = f"{tuple(t.shape)} {str(t.dtype)[6:]}"
    return out


def _mesh(name):
    shape, names = SPEC_MESHES[name]
    return dict(zip(names, shape))


@pytest.mark.parametrize("mesh,arch,shape", CELLS)
def test_cell_matches_the_reference(both, mesh, arch, shape):
    c = specs.input_specs(arch, shape, _mesh(mesh))
    want = both["cells"][f"{mesh}/{arch}/{shape}"]
    assert c.kind == want["kind"]
    assert _walk("", c.args, {}) == want["args"]
    assert _walk("", c.in_shardings, {}) == want["in"]
    assert _walk("", c.out_shardings, {}) == want["out"]
    assert list(c.donate) == want["donate"]
    assert c.model_flops == want["model_flops"]
    assert c.tokens == want["tokens"]


@pytest.mark.parametrize("mesh", list(SPEC_MESHES))
def test_params_struct_and_shardings_match_the_reference(both, mesh):
    from repro_torch.configs import ARCH_IDS, get_config
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        params, axes = specs.params_struct(cfg)
        want = both["cells"][f"{mesh}/{arch}/params"]
        assert _walk("", params, {}) == want["struct"], arch
        assert _walk("", specs.param_shardings(params, axes, cfg,
                                               _mesh(mesh)), {}) == \
            want["specs"], arch


def test_skipped_cells_match_the_reference(both):
    assert [list(x) for x in specs.skipped_cells()] == \
        both["cells"]["skipped"]
