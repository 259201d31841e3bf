"""Where the SSD backward's chunk kernel spends its time, on the card.

    python benchmarks/ssd_bwd_parts.py [--parts whole,loads,a,b,c]

Builds copies of ``csrc/ssd_scan.cu`` in which ``ssd_bwd_chunk_kernel``
leaves out one part of its work, and times the SSD backward with each at
both training shapes of ``chip_smoke.SSD_BWD_CASES`` (mamba2-370m's and
zamba2-1.2b's, given the forward's scratch): the CUDA-event mean of 10
calls and each backward kernel's traced time.  The parts:

* ``whole``: the source as it is (its gradients are also held to the
  plain version, as a check that the copy builds what the package does);
* ``loads``: every load from device memory of the tiles the kernel stages
  in shared memory (C and B, dy, x, h_in, D), the stores kept;
* ``a``, ``b``, ``c``: the products of pass A (dW, W^T dy), pass B (B D
  and the block's D xd) or pass C (H dy).

A copy's gradients are wrong by design: the time a part leaves out is
what that part costs.  Each copy is compiled by ``nvcc`` with the
package's flags into ``results/ssd_bwd_parts/`` (gitignored) and loaded
in place of the package's library.  Prints one JSON line per part and
shape with the card's ``nvidia-smi`` name and power limit, and each
copy's ptxas spill line.  Needs a CUDA card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys
import types

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "ssd_scan.cu"
OUT = ROOT / "results" / "ssd_bwd_parts"

#: the loops whose bodies are each pass's products, by the line that
#: opens them in the chunk kernel (each must occur once there)
PRODUCTS = {
    "a": ("for (int p = 0; p < pw; ++p) {\n      const float4 y4 = R3v",
          "for (int i = 16 * m; i < iend; ++i) {\n"
          "        const float4 w4 = R2v"),
    "b": ("for (int n = 0; n < N; n += 4) {",
          "for (int p = 0; p < pw; ++p) {\n        const float4 x4 = R2v"),
    "c": ("for (int p = 0; p < pw; ++p) {\n        const float4 a4 = R2v",),
}


def _chunk_kernel(src: str):
    """(start, end) of ssd_bwd_chunk_kernel's definition in ``src``."""
    start = src.index("ssd_bwd_chunk_kernel(const SsdArgs s) {")
    return start, src.index("// -- 7.", start)


def variant(src: str, part: str) -> str:
    """``src`` with ``part`` of the chunk kernel left out."""
    if part == "whole":
        return src
    a, b = _chunk_kernel(src)
    body = src[a:b]
    if part == "loads":
        body, n = re.subn(r"\b(load_slot|load_state<NR>|stage_slot|"
                          r"stage_rows<NR>)\(", r"if (0) \1(", body)
        if not n:
            raise ValueError("no staging loads found")
    else:
        for opener in PRODUCTS[part]:
            if body.count(opener) != 1:
                raise ValueError(f"part {part}: {opener!r} not found once")
            # the loop's bound becomes 0: its body never runs
            head, rest = opener.split("{", 1)
            body = body.replace(opener, re.sub(r"< \w+;", "< 0;", head, 1)
                                + "{" + rest)
    return src[:a] + body + src[b:]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parts", default="whole,loads,a,b,c")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ssd_bwd_parts: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    from chip_smoke import SSD_BWD_CASES, event_ms, kernel_times, \
        ssd_operands
    from repro_torch.kernels import _build, ssd_scan

    parts = args.parts.split(",")
    src = SOURCE.read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for part in parts:
        cu = OUT / f"{part}.cu"
        cu.write_text(variant(src, part))
        procs[part] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"{part}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    spills = {}
    for part, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {part}:\n{log}")
        lines = log.splitlines()
        spills[part] = [ln.split(":")[-1].strip() for i, ln in
                        enumerate(lines) if "spill" in ln and i
                        and "ssd_bwd_chunk_kernel" in lines[i - 1]]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    for part in parts:
        lib = ctypes.CDLL(str(OUT / f"{part}.so"))
        for fn, argtypes in _build.SIGNATURES["ssd_scan"].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _build._LIBS["ssd_scan"] = lib
        for label, b, length, h, g, n, p, q, _, _ in SSD_BWD_CASES:
            if "training" not in label:
                continue
            gen = torch.Generator(device=dev).manual_seed(0)
            dims = types.SimpleNamespace(ssm_heads=h, ssm_head_dim=p,
                                         ssm_groups=g, ssm_state=n)
            x, dt, a, bm, cm = ssd_operands(b, length, dims, gen)
            dy = torch.randn((b, length, h, p), generator=gen, device=dev)
            _, _, scratch, _ = ssd_scan._forward(x, dt, a, bm, cm, q)

            def bwd():
                return ssd_scan.ssd_scan_backward(x, dt, a, bm, cm, dy,
                                                  chunk=q, scratch=scratch)
            row = {"card": smi, "part": part, "case": label,
                   "chunk_kernel_spill": spills[part]}
            if part == "whole":
                want = ssd_scan.ssd_scan_backward_plain(x, dt, a, bm, cm,
                                                        dy, chunk=q)
                row["rel_err"] = max(
                    ((u - w).abs().max() / w.abs().max()).item()
                    for u, w in zip(bwd(), want))
            row["ms"] = event_ms(bwd, 10)
            row["kernels"] = {k: t for k, t, _ in kernel_times(bwd)
                              if "ssd_bwd" in k}
            print(json.dumps(row), flush=True)
            del x, dt, a, bm, cm, dy, scratch
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
