"""End-to-end training driver on the PyTorch port: a ~100M-param dense
LM for a few hundred steps on the synthetic pipeline, with checkpointing
and fault tolerance.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] \\
        [--arch granite-8b] [--device cpu]

The config is a scaled-down (--d-model/--layers) variant of the chosen
arch family; on the card the prefill attention and its backward run the
flash kernels.  For the full configurations and a mesh of ranks, see
``python -m repro_torch.launch.train``.
"""
import argparse
import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.driver import RunConfig, TrainDriver


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_train_lm")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this example runs on the card; "
                         "pass --device cpu for the plain versions")

    base = get_config(args.arch)
    cfg = dataclasses.replace(
        base, name=base.name + "-100m", n_layers=args.layers,
        d_model=args.d_model, n_heads=8, n_kv_heads=4,
        head_dim=args.d_model // 8, d_ff=4 * args.d_model, vocab=8192,
        n_experts=min(base.n_experts, 4) if base.n_experts else 0,
        ssm_state=min(base.ssm_state, 32) if base.ssm_state else 0,
        ssm_head_dim=32, attn_every=2 if base.attn_every else 0,
        n_enc_layers=2 if base.n_enc_layers else 0,
        cross_attn_every=2 if base.cross_attn_every else 0,
        frontend_tokens=32 if base.frontend_tokens else 0,
        swa_window=64 if base.swa_window else None,
        remat=False, sequence_parallel=False, dtype="float32",
    )
    print(f"training {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
          f"{args.steps} steps")

    driver = TrainDriver(
        cfg,
        AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps),
        DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                   global_batch=args.batch),
        RunConfig(total_steps=args.steps, ckpt_every=100, log_every=25,
                  ckpt_dir=args.ckpt_dir),
        device=args.device,
    )
    out = driver.run()
    if not out["metrics"]:
        print(f"nothing to do: checkpoint in {args.ckpt_dir} is already at "
              f"step {args.steps}; pass a fresh --ckpt-dir to retrain")
        return
    print("\nstep   loss     lr")
    for m in out["metrics"]:
        print(f"{m['step']:5d}  {m['loss']:.4f}  {m['lr']:.2e}")
    first, last = out["metrics"][0]["loss"], out["metrics"][-1]["loss"]
    print(f"\nloss {first:.3f} -> {last:.3f} "
          f"({'DECREASED' if last < first else 'no progress'}); "
          f"stragglers flagged: {out['stragglers']}")


if __name__ == "__main__":
    main()
