"""The port's checkpoints, fault-tolerant driver and command lines, on
the CPU, mirroring the reference's ``tests/test_substrate.py``, plus
checkpoints that cross between the two packages in both directions.

Tolerances: restored arrays exactly; the next step's loss after a
checkpoint crosses packages within 1e-5 x |loss| (XLA and PyTorch sum in
other orders).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import store as ref_store  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.train import trainer as ref_trainer  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, _batch_numpy  # noqa: E402
from repro_torch.dist import spawn  # noqa: E402
from repro_torch.dist import train_cases as tc  # noqa: E402
from repro_torch.dist.comm_engine import Spec  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime.driver import (RunConfig, TrainDriver,  # noqa: E402
                                        run_with_restarts)
from repro_torch.train import trainer  # noqa: E402

ARCH = "granite-8b"


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "nest": {"b": torch.ones(5, dtype=torch.int32)}}


def test_roundtrip(tmp_path):
    t = _tree()
    store.save(str(tmp_path), 7, t)
    got, step, _ = store.restore(str(tmp_path), t)
    assert step == 7
    assert torch.equal(got["a"], t["a"]) and torch.equal(got["nest"]["b"],
                                                         t["nest"]["b"])
    assert got["nest"]["b"].dtype == torch.int32


def test_atomicity_tmp_never_visible(tmp_path):
    t = _tree()
    store.save(str(tmp_path), 1, t)
    os.makedirs(tmp_path / "tmp.2")            # a save that crashed
    assert store.list_steps(str(tmp_path)) == [1]
    _, step, _ = store.restore(str(tmp_path), t)
    assert step == 1


def test_async_checkpointer_gc(tmp_path):
    ck = store.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save_async(s, _tree())
    ck.wait()
    assert store.list_steps(str(tmp_path)) == [3, 4]


def test_async_snapshot_is_taken_on_the_callers_thread(tmp_path):
    ck = store.AsyncCheckpointer(str(tmp_path))
    t = _tree()
    ck.save_async(1, t)
    t["a"] += 100                               # after the call returns
    ck.wait()
    got, _, _ = store.restore(str(tmp_path), _tree())
    assert torch.equal(got["a"], torch.arange(12.0).reshape(3, 4))


def test_shape_mismatch_rejected(tmp_path):
    store.save(str(tmp_path), 1, _tree())
    bad = {"a": torch.zeros(2, 2), "nest": {"b": torch.ones(5)}}
    with pytest.raises(ValueError, match="shape mismatch"):
        store.restore(str(tmp_path), bad)


def test_missing_directory_and_mesh_restore_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        store.restore(str(tmp_path / "none"), _tree())
    store.save(str(tmp_path), 1, _tree())
    specs = {"a": Spec("data", None), "nest": {"b": Spec("model")}}
    with pytest.raises(ValueError, match="pass mesh="):
        store.restore(str(tmp_path), _tree(), shardings=specs)
    # the mesh restore runs: onto a one-rank 1x1 mesh, every block whole
    with spawn.single_rank(device="cpu"):
        got, step, _ = store.restore(str(tmp_path), _tree(),
                                     shardings=specs,
                                     mesh=make_host_mesh(1, 1, device="cpu"))
    assert step == 1
    assert torch.equal(got["a"], _tree()["a"])
    assert torch.equal(got["nest"]["b"], _tree()["nest"]["b"])


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------

def _ref_state(bits, seed=0):
    cfg = ref_config(ARCH).reduced()
    state, _ = ref_trainer.init_state(
        jax.random.PRNGKey(seed), cfg,
        ref_adamw.AdamWConfig(state_bits=bits))
    return cfg, state


def _one_step_losses(rcfg, rstate, pstate, bits, step=0):
    """The next step's loss in both packages on one batch."""
    cfg = get_config(ARCH).reduced()
    opt = dict(warmup_steps=2, total_steps=10, state_bits=bits)
    b = _batch_numpy(DataConfig(vocab=cfg.vocab, seq_len=32,
                                global_batch=4), step)
    _, rm = ref_trainer.make_train_step(rcfg, ref_adamw.AdamWConfig(**opt))(
        rstate, {k: jnp.asarray(v) for k, v in b.items()})
    _, pm = trainer.make_train_step(cfg, adamw.AdamWConfig(**opt))(
        pstate, {k: torch.as_tensor(v) for k, v in b.items()})
    return float(rm["loss"]), float(pm["loss"])


@pytest.mark.parametrize("bits", [32, 8])
def test_reference_checkpoint_restores_into_the_port(tmp_path, bits):
    rcfg, rstate = _ref_state(bits)
    # one step first, so the moments and step are not all zero
    b = _batch_numpy(DataConfig(vocab=rcfg.vocab, seq_len=32,
                                global_batch=4), 5)
    rstate, _ = ref_trainer.make_train_step(
        rcfg, ref_adamw.AdamWConfig(state_bits=bits))(
        rstate, {k: jnp.asarray(v) for k, v in b.items()})
    ref_store.save(str(tmp_path), 1, rstate, extra={"data": {"step": 1}})
    cfg = get_config(ARCH).reduced()
    like = trainer.init_state(torch.Generator().manual_seed(5), cfg,
                              adamw.AdamWConfig(state_bits=bits))
    pstate, step, extra = store.restore(str(tmp_path), like)
    assert step == 1 and extra == {"data": {"step": 1}}
    assert int(pstate.opt.step) == 1
    want = convert.train_state_from_reference(
        jax.tree.map(np.asarray, rstate), device="cpu")
    flat_got = store._flatten_with_paths(pstate)
    flat_want = store._flatten_with_paths(want)
    assert flat_got.keys() == flat_want.keys()
    for k in flat_want:
        np.testing.assert_array_equal(flat_got[k], flat_want[k])
    r, p = _one_step_losses(rcfg, rstate, pstate, bits, step=1)
    assert abs(p - r) <= 1e-5 * abs(r)


@pytest.mark.parametrize("bits", [32, 8])
def test_port_checkpoint_restores_into_the_reference(tmp_path, bits):
    rcfg, like = _ref_state(bits, seed=1)
    cfg = get_config(ARCH).reduced()
    pstate = trainer.init_state(torch.Generator().manual_seed(3), cfg,
                                adamw.AdamWConfig(state_bits=bits))
    b = _batch_numpy(DataConfig(vocab=cfg.vocab, seq_len=32,
                                global_batch=4), 5)
    pstate, _ = trainer.make_train_step(
        cfg, adamw.AdamWConfig(state_bits=bits))(
        pstate, {k: torch.as_tensor(v) for k, v in b.items()})
    store.save(str(tmp_path), 1, pstate)
    manifest = json.loads((tmp_path / "step_00000001" /
                           "manifest.json").read_text())
    assert ".opt/.step" in manifest["keys"]
    assert ".params/layers/attn/wq" in manifest["keys"]
    rstate, step, _ = ref_store.restore(str(tmp_path), like)
    assert step == 1
    for k, v in store._flatten_with_paths(pstate).items():
        np.testing.assert_array_equal(
            np.asarray(ref_store._flatten_with_paths(rstate)[k]), v)
    r, p = _one_step_losses(rcfg, rstate, pstate, bits, step=1)
    assert abs(p - r) <= 1e-5 * abs(r)


# ---------------------------------------------------------------------------
# the fault-tolerant driver
# ---------------------------------------------------------------------------

def _driver_factory(tmp, cfg, failure_at=None, slow_at=None, steps=30):
    def make():
        return TrainDriver(
            cfg, adamw.AdamWConfig(lr=1e-2, warmup_steps=2,
                                   total_steps=steps),
            DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8),
            RunConfig(total_steps=steps, ckpt_every=10, log_every=10,
                      ckpt_dir=tmp),
            failure_at=failure_at, slow_step_at=slow_at, device="cpu")
    return make


def test_loss_decreases(tmp_path):
    cfg = get_config(ARCH).reduced()
    out = _driver_factory(str(tmp_path), cfg, steps=60)().run()
    losses = [m["loss"] for m in out["metrics"]]
    assert losses[-1] < losses[0] * 0.8


def test_restart_after_failure_resumes(tmp_path):
    cfg = get_config(ARCH).reduced()
    made = []

    def make():
        made.append(1)
        return _driver_factory(str(tmp_path), cfg,
                               failure_at=15 if len(made) == 1 else None,
                               steps=30)()

    out = run_with_restarts(make, max_restarts=2)
    assert out["restarts"] == 1
    assert out["final_step"] == 30
    assert store.latest_step(str(tmp_path)) == 30


def test_resumed_run_matches_an_uninterrupted_one(tmp_path):
    cfg = get_config(ARCH).reduced()
    whole = _driver_factory(str(tmp_path / "a"), cfg, steps=20)().run()
    made = []

    def make():
        made.append(1)
        return _driver_factory(str(tmp_path / "b"), cfg,
                               failure_at=13 if len(made) == 1 else None,
                               steps=20)()
    resumed = run_with_restarts(make)
    assert resumed["restarts"] == 1
    # the restart resumed from step 10 and logged step 20 again
    (last_w,), (last_r,) = ([m for m in out["metrics"] if m["step"] == 20]
                            for out in (whole, resumed))
    assert last_r["loss"] == last_w["loss"]


def test_straggler_watchdog_flags_slow_step(tmp_path):
    cfg = get_config(ARCH).reduced()
    out = _driver_factory(str(tmp_path), cfg, slow_at=20, steps=25)().run()
    assert 20 in out["stragglers"]


def test_resume_replays_data_stream(tmp_path):
    cfg = get_config(ARCH).reduced()
    _driver_factory(str(tmp_path), cfg, steps=20)().run()
    d2 = _driver_factory(str(tmp_path), cfg, steps=20)()
    assert d2.start_step == 20
    assert d2.pipeline.step == 20


def test_driver_needs_a_device_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    cfg = get_config(ARCH).reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainDriver(cfg, adamw.AdamWConfig(),
                    DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=2),
                    RunConfig(ckpt_dir=str(tmp_path)))
    # on a mesh the driver follows the mesh's device: a mesh without a
    # device names the card and raises the same way; a CPU mesh runs
    with spawn.single_rank(device="cpu"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_host_mesh(1, 1)
        driver = TrainDriver(
            cfg, adamw.AdamWConfig(),
            DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=2),
            RunConfig(total_steps=1, ckpt_dir=str(tmp_path)),
            mesh=make_host_mesh(1, 1, device="cpu"))
        assert driver.device.type == "cpu"
        assert driver.run()["final_step"] == 1


# ---------------------------------------------------------------------------
# command lines
# ---------------------------------------------------------------------------

def test_launch_train_smoke_on_the_cpu(tmp_path, capsys):
    out = launch_train.main(["--arch", "h2o-danube-1.8b", "--steps", "30",
                             "--smoke", "--device", "cpu", "--lr", "1e-2",
                             "--ckpt-dir", str(tmp_path)])
    losses = [m["loss"] for m in out["metrics"]]
    assert out["final_step"] == 30 and losses[-1] < losses[0]
    printed = capsys.readouterr().out
    assert "decreased" in printed and "finished at step 30 on cpu" in printed
    assert store.latest_step(str(tmp_path)) == 30


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_launch_train_smoke_trains_the_ssm_families(tmp_path, capsys,
                                                    arch):
    out = launch_train.main(["--arch", arch, "--steps", "30", "--smoke",
                             "--device", "cpu", "--lr", "1e-2",
                             "--ckpt-dir", str(tmp_path)])
    losses = [m["loss"] for m in out["metrics"]]
    assert out["final_step"] == 30 and losses[-1] < losses[0]
    assert "finished at step 30 on cpu" in capsys.readouterr().out


def test_launch_train_multi_pod_raises(tmp_path):
    # the mesh path runs; one process is too small a world for 2 pods
    with pytest.raises(ValueError, match="needs 512 ranks"):
        launch_train.main(["--arch", "h2o-danube-1.8b", "--multi-pod",
                           "--device", "cpu", "--ckpt-dir", str(tmp_path)])


def test_launch_train_runs_on_a_mesh(tmp_path):
    # four gloo ranks, the production mesh swapped for 2x2 and the config
    # reduced (dist.train_cases.launch_train_on_mesh)
    recs = spawn.run_ranks(tc.launch_train_on_mesh, 4, device="cpu", args=(
        ["--arch", "h2o-danube-1.8b", "--steps", "4", "--global-batch", "4",
         "--seq-len", "32", "--lr", "1e-2", "--device", "cpu",
         "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)],), timeout=300)
    assert [r["final_step"] for r in recs] == [4] * 4
    assert all(r["losses"] == recs[0]["losses"] for r in recs)
    assert "finished at step 4 on a 2x2 mesh ('data', 'model') on cpu" in \
        recs[0]["printed"]
    assert all(r["printed"] == "" for r in recs[1:])
    assert store.list_steps(str(tmp_path)) == [2, 4]
    # the mesh's checkpoint restores on one device
    cfg = get_config("h2o-danube-1.8b").reduced()
    state = trainer.init_state(torch.Generator().manual_seed(0), cfg,
                               adamw.AdamWConfig())
    _, step, extra = store.restore(str(tmp_path), state)
    assert step == 4 and extra["data"]["step"] == 4


def _served(cfg, params, argv):
    """``launch.serve``'s tokens and ``DecodeEngine``'s on ``params``."""
    from repro_torch.serve.engine import DecodeEngine, ServeConfig
    gen, stats = launch_serve.main(argv)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, size=(2, 8)).astype(np.int32)
    want, _ = DecodeEngine(params, cfg, ServeConfig(max_new_tokens=4),
                           device="cpu").generate(prompts)
    return gen, want


def test_launch_serve_restores_a_trained_port_checkpoint(tmp_path, capsys):
    cfg = get_config("h2o-danube-1.8b").reduced()
    launch_train.main(["--arch", "h2o-danube-1.8b", "--steps", "12",
                       "--smoke", "--device", "cpu", "--lr", "1e-2",
                       "--ckpt-dir", str(tmp_path)])
    trained, step, _ = store.restore(
        str(tmp_path), trainer.init_state(torch.Generator().manual_seed(9),
                                          cfg, adamw.AdamWConfig()))
    gen, want = _served(cfg, trained.params, [
        "--arch", "h2o-danube-1.8b", "--smoke", "--device", "cpu",
        "--ckpt", str(tmp_path), "--batch", "2", "--prompt-len", "8",
        "--new-tokens", "4"])
    assert "restored checkpoint step 12" in capsys.readouterr().out
    np.testing.assert_array_equal(gen, want)


def test_launch_serve_restores_a_reference_checkpoint(tmp_path, capsys):
    rcfg, rstate = _ref_state(32, seed=4)
    ref_store.save(str(tmp_path), 3, rstate)
    cfg = get_config(ARCH).reduced()
    params = convert.params_from_reference(
        jax.tree.map(np.asarray, rstate.params), device="cpu")
    gen, want = _served(cfg, params, [
        "--arch", ARCH, "--smoke", "--device", "cpu", "--ckpt",
        str(tmp_path), "--batch", "2", "--prompt-len", "8",
        "--new-tokens", "4"])
    assert "restored checkpoint step 3" in capsys.readouterr().out
    np.testing.assert_array_equal(gen, want)
