"""Training entry point.

    python -m repro_torch.launch.train --arch h2o-danube-1.8b --steps 100 \
        [--global-batch 4] [--seq-len 2048] [--smoke] [--device cpu]
    torchrun --nproc-per-node 8 -m repro_torch.launch.train \
        --arch qwen2.5-32b [--multi-pod]

One process runs the fault-tolerant driver on one device: the card
unless ``--device`` names another.  ``--smoke`` scales the config down
(batch 8, sequence 64) for the CPU and never builds a mesh.  The
defaults (batch 4 x 2048 tokens) fit the fp32 masters, gradients and
AdamW moments of h2o-danube-1.8b, mamba2-370m and zamba2-1.2b on one
80 GB card (the ssm and hybrid families train through the SSD kernels'
backward).

Without ``--smoke``, a process that is one rank of a world (a default
process group already set up, or torchrun's environment with
``WORLD_SIZE`` > 1, read through ``env://``) builds the production mesh
(``launch.mesh.make_production_mesh``: 16x16, or 2x16x16 with
``--multi-pod``) and runs the driver on it.  ``--multi-pod`` in a world
too small for its 512 ranks raises the mesh's ``ValueError``.  The
backend follows the device (``launch.mesh``): NCCL on the card, one
rank a card; gloo on the CPU.

Departure, declared: every rank reads the whole global batch
(``n_shards=1``) and the sharded step keeps its rows, where the
reference shards the data by process.  A torch rank is one mesh
position, not a host of several devices.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import os
from typing import Iterator, Optional, Sequence


def _world_size() -> int:
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


@contextlib.contextmanager
def _default_group(device) -> Iterator[None]:
    """The default process group for the ``with`` block: the caller's
    when one exists; torchrun's (``env://``) when ``WORLD_SIZE`` > 1;
    else this process as a one-rank world."""
    import torch
    import torch.distributed as dist

    from ..dist import spawn
    from ..kernels.ops import resolve_device
    from .mesh import resolve_backend

    if dist.is_initialized():
        yield
        return
    if _world_size() == 1:
        with spawn.single_rank(device):
            yield
        return
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(resolve_backend(dev, None),
                            init_method="env://",
                            timeout=datetime.timedelta(seconds=1800))
    try:
        yield
    finally:
        dist.destroy_process_group()


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
                    help="reduced config, batch 8 x 64 tokens, no mesh")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from ..configs import get_config
    from ..data.pipeline import DataConfig
    from ..launch.mesh import make_production_mesh
    from ..launch.specs import opt_config_for
    from ..runtime.driver import RunConfig, TrainDriver

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
        batch, seq = 8, 64
    else:
        batch, seq = args.global_batch, args.seq_len
    on_mesh = not args.smoke and (args.multi_pod or _world_size() > 1)

    opt_cfg = dataclasses.replace(opt_config_for(cfg), lr=args.lr,
                                  total_steps=args.steps)

    def run(mesh) -> dict:
        driver = TrainDriver(
            cfg, opt_cfg,
            DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch),
            RunConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir),
            mesh=mesh, device=args.device)
        out = driver.run()
        if mesh is not None and dist.get_rank() != 0:
            return out
        for m in out["metrics"][-5:]:
            print(m)
        losses = [m["loss"] for m in out["metrics"]]
        if losses:
            print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f} "
                  f"({'decreased' if losses[-1] < losses[0] else 'not lower'})")
        where = driver.device if mesh is None else (
            f"a {'x'.join(map(str, mesh.shape))} mesh "
            f"{tuple(mesh.mesh_dim_names)} on {driver.device.type}")
        print(f"finished at step {out['final_step']} on {where}")
        return out

    if not on_mesh:
        return run(None)
    with _default_group(args.device):
        return run(make_production_mesh(multi_pod=args.multi_pod,
                                        device=args.device))


if __name__ == "__main__":
    main()
