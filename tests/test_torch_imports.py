"""Guards: the port imports neither JAX nor the reference package, and
never falls back to the CPU on its own."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = ("repro_torch", "repro_torch.api", "repro_torch.kernels.ops",
           "repro_torch.serve.engine", "repro_torch.convert",
           "repro_torch.compile.pipeline", "repro_torch.core.dse",
           "repro_torch.kernels.bsr_gemm", "repro_torch.kernels.fused_chain",
           "repro_torch.graph", "repro_torch.graph.ir",
           "repro_torch.graph.planner", "repro_torch.graph.executor",
           "repro_torch.graph.from_model", "repro_torch.models.chains",
           "repro_torch.models.transformer", "repro_torch.configs",
           "repro_torch.configs.registry", "repro_torch.kernels.paged",
           "repro_torch.kernels.flash_attention", "repro_torch.models",
           "repro_torch.models.common", "repro_torch.models.mlp",
           "repro_torch.models.attention", "repro_torch.models.decode",
           "repro_torch.serve", "repro_torch.serve.pages",
           "repro_torch.serve.slots", "repro_torch.serve.server",
           "repro_torch.serve.report", "repro_torch.models.ssm",
           "repro_torch.kernels.ssd_scan", "repro_torch.tune",
           "repro_torch.tune.measure", "repro_torch.tune.cache",
           "repro_torch.tune.calibrate", "repro_torch.tune.report",
           "repro_torch.tune.tuner", "repro_torch.optim",
           "repro_torch.optim.adamw", "repro_torch.data",
           "repro_torch.data.pipeline", "repro_torch.train",
           "repro_torch.train.trainer", "repro_torch.checkpoint",
           "repro_torch.checkpoint.store", "repro_torch.runtime",
           "repro_torch.runtime.driver", "repro_torch.launch",
           "repro_torch.launch.specs", "repro_torch.launch.train",
           "repro_torch.launch.serve", "repro_torch.launch.mesh",
           "repro_torch.dist", "repro_torch.dist.comm_engine",
           "repro_torch.dist.engine", "repro_torch.dist.schedules",
           "repro_torch.dist.spawn", "repro_torch.dist.cases",
           "repro_torch.dist.selftest", "repro_torch.dist.comm_selftest",
           "repro_torch.dist.partition_selftest",
           "repro_torch.dist.sparse_selftest",
           "repro_torch.dist.serve_selftest",
           "repro_torch.dist.model_cases",
           "repro_torch.models.explicit_tp",
           "repro_torch.dist.train_cases",
           "repro_torch.dist.train_selftest")

_IMPORT = re.compile(
    r"^\s*(import\s+(jax|repro)\b(?!_torch)"
    r"|from\s+(jax|repro)(\.\S+)?\s+import\b)", re.M)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "")
                               .split(os.pathsep) if p])
    return env


def test_port_modules_load_no_jax_and_no_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import repro_torch\n"
        "repro_torch.generate\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or m == 'repro' "
        "or m.startswith('repro.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr + out.stdout
    assert out.stdout.strip() == "[]"


def test_sources_have_no_jax_or_reference_imports():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
                 for p in files for m in _IMPORT.finditer(p.read_text())]
    assert offenders == []


def test_import_scan_catches_offenders():
    for line in ("import jax", "import jax.numpy as jnp",
                 "from repro.core import stt", "from repro import api",
                 "import repro", "  from jax import lax"):
        assert _IMPORT.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import stt",
                 "from . import stt"):
        assert not _IMPORT.search(line), line


def _require_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")


def test_entry_points_raise_without_cuda_and_device():
    _require_no_cuda()
    import repro_torch
    from repro_torch.compile import lower
    from repro_torch.core.algebra import get_algebra
    from repro_torch.kernels import ops
    from repro_torch.serve import AcceleratorEngine
    a = torch.ones(4, 4)
    for call in (lambda: repro_torch.generate("gemm"),
                 lambda: lower(get_algebra("gemm")),
                 lambda: ops.stt_matmul(a, a),
                 lambda: AcceleratorEngine()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_chip_smoke_fails_without_cuda(tmp_path):
    _require_no_cuda()
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=_env(), capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    # a directory holding chip_smoke.py and nothing else of the repo
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_cuda_tensor_without_kernel_library_raises_not_falls_back(
        monkeypatch):
    # a CUDA tensor goes to the kernel or raises: simulate a card whose
    # kernel library cannot be built and check nothing computes on the CPU
    from repro_torch.kernels import _build, stt_gemm

    def no_library(stem):
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "library", no_library)
    monkeypatch.setattr(stt_gemm, "_on_cpu", lambda *xs: False)
    calls = []
    monkeypatch.setattr(stt_gemm, "output_stationary_plain",
                        lambda *a, **k: calls.append(1))
    a = torch.ones(16, 16)
    with pytest.raises(RuntimeError, match="nvcc"):
        stt_gemm.matmul_output_stationary(a, a, bm=16, bn=16, bk=16)
    assert calls == []


def _no_plain(monkeypatch, module, plain_names):
    """Make ``module`` see CUDA tensors whose kernel library cannot be
    built, and record any call of its plain versions."""
    from repro_torch.kernels import _build

    def no_library(stem):
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "library", no_library)
    monkeypatch.setattr(module, "_on_cpu", lambda *xs: False)
    calls = []
    for name in plain_names:
        monkeypatch.setattr(module, name,
                            lambda *a, _n=name, **k: calls.append(_n))
    return calls


def test_bsr_cuda_tensor_raises_not_falls_back(monkeypatch):
    from repro_torch.kernels import bsr_gemm
    calls = _no_plain(monkeypatch, bsr_gemm,
                      ["bsr_matmul_plain", "_fp32_product"])
    a = torch.ones(8, 8)
    with pytest.raises(RuntimeError, match="nvcc"):
        bsr_gemm.bsr_matmul(a, a, coords=((0, 0), (1, 1)), bm=4, bk=4,
                            bn=8, csr=(torch.tensor([0, 1, 2],
                                                    dtype=torch.int32),
                                       torch.tensor([0, 1],
                                                    dtype=torch.int32)))
    assert calls == []


@pytest.mark.parametrize("entry", ["chain", "dag"])
def test_fused_cuda_tensor_raises_not_falls_back(monkeypatch, entry):
    from repro_torch.kernels import fused_chain
    calls = _no_plain(monkeypatch, fused_chain,
                      ["chain_reference", "dag_reference",
                       "_fp32_product"])
    x = torch.ones(4, 8)
    with pytest.raises(RuntimeError, match="nvcc"):
        if entry == "chain":
            fused_chain.fused_chain_matmul(
                x, [torch.ones(8, 6)],
                stages=[fused_chain.ChainStage(8, 6)])
        else:
            fused_chain.fused_dag(
                [x, torch.ones(8, 6)],
                stages=[fused_chain.DagStage(4, 8, 6, rhs=("ext", 1))])
    assert calls == []


def test_training_entry_points_raise_without_cuda_and_device(tmp_path):
    _require_no_cuda()
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.launch import serve, train
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import RunConfig, TrainDriver
    cfg = get_config("h2o-danube-1.8b").reduced()
    for call in (
            lambda: TrainDriver(cfg, AdamWConfig(), DataConfig(
                vocab=cfg.vocab, seq_len=8, global_batch=2),
                RunConfig(ckpt_dir=str(tmp_path))),
            lambda: train.main(["--arch", "h2o-danube-1.8b", "--smoke",
                                "--steps", "1", "--ckpt-dir",
                                str(tmp_path)]),
            lambda: serve.main(["--arch", "h2o-danube-1.8b", "--smoke"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_serving_entry_points_raise_without_cuda_and_device():
    _require_no_cuda()
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve import DecodeEngine, PagedKVCache, SlotEngine
    cfg = get_config("granite-8b").reduced()
    params = init_params(torch.Generator().manual_seed(0), cfg)
    template = {"self": {"k": torch.empty((1, 2, 8, 4), device="meta")}}
    for call in (lambda: DecodeEngine(params, cfg),
                 lambda: SlotEngine(params, cfg),
                 lambda: PagedKVCache(template, capacity=2, page_size=4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_paged_gather_cuda_tensor_raises_not_falls_back(monkeypatch):
    from repro_torch.kernels import paged
    calls = _no_plain(monkeypatch, paged, ["paged_gather_plain"])
    with pytest.raises(RuntimeError, match="nvcc"):
        paged.paged_gather(torch.ones(3, 2, 4),
                           torch.zeros(2, 2, dtype=torch.int32))
    assert calls == []


def test_flash_attention_cuda_tensor_raises_not_falls_back(monkeypatch):
    from repro_torch.kernels import flash_attention, ops
    calls = _no_plain(monkeypatch, flash_attention,
                      ["flash_attention_plain"])
    q = torch.ones(1, 2, 8, 16)
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.attention(q, q, q, causal=True)
    assert calls == []


def test_ssd_cuda_tensor_raises_not_falls_back(monkeypatch):
    from repro_torch.kernels import ops, ref, ssd_scan
    calls = _no_plain(monkeypatch, ssd_scan, [])
    monkeypatch.setattr(ref, "ssd_chunked_ref",
                        lambda *a, **k: calls.append("ssd_chunked_ref"))
    x = torch.ones(1, 16, 2, 8)
    dt, a, b = torch.ones(1, 16, 2), -torch.ones(2), torch.ones(1, 16, 1, 4)
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.ssd(x, dt, a, b, b, chunk=8)
    with pytest.raises(RuntimeError, match="nvcc"):
        ssd_scan.ssd_scan(x, dt, a, b, b, chunk=8)
    assert calls == []
