"""Time the port's redesigned kernels of one source tree on the card.

    python benchmarks/torch_kernel_ab.py [--src SRC] [--tag TAG]

Imports ``repro_torch`` from ``SRC`` (default: this checkout's ``src``),
so that the same script times two trees, for example a parent commit
unpacked beside the checkout, in turns on one card (parent, change,
change, parent).  Prints one JSON line per case, with
the card's ``nvidia-smi`` name and power limit:

* ``flash``: the flash-attention kernel on random bf16 q, k, v at the
  serve path's longest prefill (1495 tokens, causal) at h2o-danube-1.8b's
  heads (32 over 8, D = 80) and zamba2-1.2b's shared block (32 over 32,
  D = 64); CUDA-event mean of 20 calls;
* ``ws``: every case of ``chip_smoke.py``'s main path (``SIZES`` x
  ``STTS``) that runs the operand-stationary template, on integer
  operands: the device time of the template's kernels in one traced
  ``Accelerator.__call__`` (``torch.profiler``; ``ws_kernel`` and
  ``ws_tile_kernel``; null when three traces held neither, with the
  number of traces taken), and the CUDA-event mean of 5 calls.

Timing and tracing are ``chip_smoke.py``'s own (``event_ms``,
``kernel_times``).

Needs a CUDA card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def traced_ms(fn, names, tries=3):
    """Device time, in one traced call of ``fn``, of the kernels whose
    name holds one of ``names`` (``chip_smoke.kernel_times``), and the
    number of traces taken.  A trace that holds none of them is taken
    again, up to ``tries`` times; after that the time is None (not
    measured), never 0."""
    from chip_smoke import kernel_times
    fn()
    for n in range(1, tries + 1):
        ms = [t for k, t, _ in kernel_times(fn) if any(x in k for x in names)]
        if ms:
            return sum(ms), n
    return None, tries


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="change")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import repro_torch
    from chip_smoke import SIZES, STTS, event_ms
    from repro_torch.core.algebra import get_algebra
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    _build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def emit(**row):
        print(json.dumps({"tag": args.tag, "card": smi, **row}), flush=True)

    for hq, hkv, d in ((32, 8, 80), (32, 32, 64)):
        q, k, v = [torch.randn((1, h, 1495, d), generator=gen, device=dev
                               ).to(torch.bfloat16) for h in (hq, hkv, hkv)]
        emit(case=f"flash q (1, {hq}, 1495, {d}) k/v (1, {hkv}, 1495, {d})",
             ms=event_ms(lambda: fa.flash_attention(q, k, v, causal=True),
                         20))
        del q, k, v

    for name, bounds in SIZES.items():
        alg = get_algebra(name, **bounds)
        ops = {t.name: torch.randint(-4, 5, alg.tensor_shape(t),
                                     generator=gen, device=dev,
                                     dtype=torch.float32)
               for t in alg.inputs}
        for s in STTS:
            acc = repro_torch.generate(name, s, bounds=bounds,
                                       validate=False)
            if acc.template != "operand_stationary":
                continue
            ms, traces = traced_ms(lambda: acc(ops),
                                   ("ws_kernel<", "ws_tile_kernel<"))
            emit(case=f"ws {name} x {s}", traced_kernel_ms=ms,
                 traces=traces, call_event_ms=event_ms(lambda: acc(ops), 5))
        del ops
    return 0


if __name__ == "__main__":
    sys.exit(main())
