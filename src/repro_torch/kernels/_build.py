"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled on its own by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, in the
package's build directory (listed in ``.gitignore``), once: the library
name carries a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.  The libraries are
loaded with ``ctypes``; no PyTorch headers are compiled, so a build takes
seconds.  All sources are compiled in parallel, one ``nvcc`` each.  The
shared device helpers in ``csrc/*.cuh`` enter every library's hash.

Nothing here runs at import: the CPU tests import every module, and the
CPU has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, List

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
#: where the libraries go (``REPRO_TORCH_BUILD_DIR`` overrides)
BUILD_DIR = pathlib.Path(os.environ.get(
    "REPRO_TORCH_BUILD_DIR",
    pathlib.Path(__file__).resolve().parents[1] / "build"))

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_INTS, _FLOATS = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
_LLS = ctypes.POINTER(ctypes.c_longlong)
_VIEW = (_P, _LL, _LL, _LL)

#: argument types of every C entry point, by source stem
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "stt_gemm": {
        # dtype, A view, B view, out, ws, nb, m, n, k, kstep, inplace,
        # n_fast, n_ops, codes, params, bias, stream
        "stt_os_launch": (_I, *_VIEW, *_VIEW, _P, _P, _I, _I, _I, _I, _I,
                          _I, _I, _I, _INTS, _FLOATS, _P, _P),
        # dtype, A view, B view, out, ws, nb, m, n, k, n_fast, n_ops,
        # codes, params, bias, stream
        "stt_rt_launch": (_I, *_VIEW, *_VIEW, _P, _P, _I, _I, _I, _I, _I,
                          _I, _INTS, _FLOATS, _P, _P),
        # dtype, A view, B view, out, ws, nb, m, n, k, row_mode, n_ops,
        # codes, params, bias, stream
        "stt_ws_launch": (_I, *_VIEW, *_VIEW, _P, _P, _I, _I, _I, _I, _I,
                          _I, _INTS, _FLOATS, _P, _P),
    },
    "bsr_gemm": {
        # dtype, S (ptr, row and column strides), D (same), out, row_ptr,
        # col_idx, work order, m, n, bm, bk, tile, k_vec, m_vec, stream
        "bsr_launch": (_I, _P, _LL, _LL, _P, _LL, _LL, _P, _P, _P, _P, _I,
                       _I, _I, _I, _I, _I, _I, _P),
    },
    "fused_chain": {
        # dtype, stage and phase tables (device int64 words), n_stage,
        # n_phase, fp32 workspace (split partials, softmax rows), m_fast,
        # grid, stream
        "fused_chain_launch": (_I, _P, _I, _I, _P, _I, _I, _P),
        # dtype, tables, n_stage, n_phase, fp32 workspace, grid, stream
        "fused_dag_launch": (_I, _P, _I, _I, _P, _I, _P),
        # dtype -> CTAs an SM (negative: a CUDA error)
        "fused_ctas_per_sm": (_I,),
        "fused_stage_words": (),
        "fused_phase_words": (),
    },
    "paged": {
        # pool, table, out, n_pages_pool, C, n, page elements, element
        # bytes, stream
        "paged_gather_launch": (_P, _P, _P, _I, _I, _I, _LL, _I, _P),
    },
    "flash_attention": {
        # dtype, q, q strides, k, k strides, v, v strides, out, out
        # strides, B, Hq, Lq, Lkv, D, group, scale, causal, window,
        # q_offset, lse (or None), stream
        "flash_attention_launch": (_I, _P, _LLS, _P, _LLS, _P, _LLS, _P,
                                   _LLS, _I, _I, _I, _I, _I, _I,
                                   ctypes.c_float, _I, _I, _I, _P, _P),
        # dtype, q, k, v, out, dout (each with its strides), lse, delta,
        # dq, dk, dv, B, Hq, Lq, Lkv, D, group, scale, causal, window,
        # q_offset, stream
        "flash_attention_backward_launch": (
            _I, _P, _LLS, _P, _LLS, _P, _LLS, _P, _LLS, _P, _LLS, _P, _P,
            _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I,
            _I, _P),
    },
    "ssd_scan": {
        # x, x strides, dt, dt strides, a, b, c, b/c strides, y, state,
        # scratch, batch, L, H, G, N, P, chunk, head block, stream
        "ssd_scan_launch": (_P, _LLS, _P, _LLS, _P, _P, _P, _LLS, _P, _P,
                            _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
        # x, x strides, dt, dt strides, a, b, c, b/c strides, dy,
        # dh_final (or None), the forward's scratch, dx, ddt, da, db, dc,
        # scratch, batch, L, H, G, N, P, chunk, head block, stream
        "ssd_scan_backward_launch": (
            _P, _LLS, _P, _LLS, _P, _P, _P, _LLS, _P, _P, _P, _P, _P, _P,
            _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
        # state width, 8 ints out (the chunk kernels' shared bytes, CTAs
        # an SM, registers, local bytes)
        "ssd_scan_backward_info": (_I, _INTS),
    },
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _target(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, pathlib.Path]:
    """Compile every source whose library is missing, all at once.
    Returns stem -> library path; raises with nvcc's output on failure.
    The ptxas report (registers, shared memory, spills) is kept beside
    each library as ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: (src, _target(src))
               for src in sorted(CSRC.glob("*.cu"))}
    procs: List = []
    for stem, (src, lib) in targets.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((stem, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for stem, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{stem}:\n{out}")
            continue
        lib.with_name(lib.name + ".log").write_text(out)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {stem: lib for stem, (_, lib) in targets.items()}


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu`` (built at first use),
    with ``argtypes``/``restype`` set on every entry point."""
    with _LOCK:
        lib = _LIBS.get(stem)
        if lib is None:
            path = build_all()[stem]
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in SIGNATURES[stem].items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _LIBS[stem] = lib
        return lib


def check(code: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned after a launch."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
