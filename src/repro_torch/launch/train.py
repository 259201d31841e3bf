"""Training entry point.

    python -m repro_torch.launch.train --arch h2o-danube-1.8b --steps 100 \
        [--global-batch 4] [--seq-len 2048] [--smoke] [--device cpu]

Runs the fault-tolerant driver on one device: the card unless
``--device`` names another.  ``--smoke`` scales the config down (batch
8, sequence 64) for the CPU.  The defaults (batch 4 x 2048 tokens) fit
the fp32 masters, gradients and AdamW moments of h2o-danube-1.8b,
mamba2-370m and zamba2-1.2b on one 80 GB card (the ssm and hybrid
families train through the SSD kernels' backward).  ``--multi-pod``
needs the model-mesh slice and raises.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="ckpts")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config, batch 8 x 64 tokens")
    args = ap.parse_args(argv)

    from ..configs import get_config
    from ..data.pipeline import DataConfig
    from ..launch.specs import opt_config_for
    from ..runtime.driver import RunConfig, TrainDriver
    from ..train.trainer import MESH_SLICE

    if args.multi_pod:
        raise NotImplementedError(MESH_SLICE)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
        batch, seq = 8, 64
    else:
        batch, seq = args.global_batch, args.seq_len

    opt_cfg = dataclasses.replace(opt_config_for(cfg), lr=args.lr,
                                  total_steps=args.steps)
    driver = TrainDriver(
        cfg, opt_cfg,
        DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch),
        RunConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                  ckpt_dir=args.ckpt_dir),
        device=args.device)
    out = driver.run()
    for m in out["metrics"][-5:]:
        print(m)
    losses = [m["loss"] for m in out["metrics"]]
    if losses:
        print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"({'decreased' if losses[-1] < losses[0] else 'not lower'})")
    print(f"finished at step {out['final_step']} on {driver.device}")
    return out


if __name__ == "__main__":
    main()
