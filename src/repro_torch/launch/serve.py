"""Serving entry point.

    python -m repro_torch.launch.serve --arch h2o-danube-1.8b \
        [--ckpt DIR] [--smoke] [--device cpu]

Draws the model's parameters (seed 0), or with ``--ckpt`` restores them
from a checkpoint directory: a training state's parameters (the
``.params`` subtree that ``TrainDriver`` writes, the port's or the
reference's) or a bare parameter tree.  Then ``DecodeEngine`` answers a
batch of random prompts greedily, on the card unless ``--device``
names another.  ``--smoke`` serves the reduced config.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..checkpoint import store
    from ..configs import get_config
    from ..kernels.ops import resolve_device
    from ..models import init_params
    from ..serve.engine import DecodeEngine, ServeConfig

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg)
    if args.ckpt:
        step = store.latest_step(args.ckpt)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {args.ckpt}")
        with open(os.path.join(args.ckpt, f"step_{step:08d}",
                               "manifest.json")) as f:
            keys = json.load(f)["keys"]
        prefix = ".params" if any(k.startswith(".params/") for k in keys) \
            else ""
        params, step, _ = store.restore(args.ckpt, params, step=step,
                                        prefix=prefix)
        print(f"restored checkpoint step {step}")

    engine = DecodeEngine(params, cfg,
                          ServeConfig(max_new_tokens=args.new_tokens),
                          device=device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, size=(args.batch, args.prompt_len)
                           ).astype(np.int32)
    frontend = None
    if cfg.family in ("encdec", "vlm"):
        frontend = 0.05 * rng.standard_normal(
            (args.batch, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    gen, stats = engine.generate(prompts, frontend=frontend)
    print(f"generated {stats['generated']} tokens x {args.batch} sequences")
    print(gen[:2])
    return gen, stats


if __name__ == "__main__":
    main()
