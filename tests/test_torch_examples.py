"""The port's example scripts (``examples/torch_*.py``) stay runnable:
subprocess smoke tests on the CPU (``--device cpu``), at the sizes
``tests/test_examples.py`` runs the reference's, asserting the same
success lines; the quickstart also with its mesh demo over 4 gloo
ranks."""
import os
import subprocess
import sys


ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def run_example(name, *args, timeout=600):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", name), "--device",
         "cpu", *args],
        capture_output=True, text=True, timeout=timeout, cwd=ROOT, env=env)
    assert proc.returncode == 0, (
        f"STDOUT:\n{proc.stdout[-2000:]}\nSTDERR:\n{proc.stderr[-2000:]}")
    return proc.stdout


def test_quickstart():
    out = run_example("torch_quickstart.py")
    assert "quickstart OK" in out
    assert "skipping the mesh demo" in out


def test_quickstart_mesh_demo_on_four_ranks():
    out = run_example("torch_quickstart.py", "--ranks", "4")
    assert "multi-chip (2x2 mesh, strategy=cannon)" in out
    assert "quickstart OK" in out


def test_serve_lm():
    out = run_example("torch_serve_lm.py", "--capacity", "3")
    assert "serve OK" in out
    assert "decode compiles 1" in out


def test_train_lm_short(tmp_path):
    # fresh checkpoint dir each run: a leftover completed checkpoint would
    # make the driver resume at the final step and train nothing
    out = run_example("torch_train_lm.py", "--steps", "40", "--d-model",
                      "64", "--layers", "2", "--seq", "32", "--batch", "4",
                      "--ckpt-dir", str(tmp_path / "ckpt"))
    assert "DECREASED" in out


def test_dse_explore():
    out = run_example("torch_dse_explore.py")
    assert "pareto frontier" in out
    assert "generated search winner" in out
