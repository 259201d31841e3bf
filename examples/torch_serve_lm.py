"""Serve a small model through the PyTorch port's continuous-batching
server.

    PYTHONPATH=src python examples/torch_serve_lm.py [--arch h2o-danube-1.8b]
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu

Submits a mixed-length wave of requests to ``ContinuousServer`` (slot
engine + paged KV cache underneath: the paged-gather kernel on the card
every decode step, flash attention in every prefill), then replays each
prompt through the static-batch ``DecodeEngine`` — the sequential
oracle — and checks the continuous outputs are bit-identical.  Weights
are random, drawn from a seeded ``torch.Generator``.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.serve import (ContinuousServer, DecodeEngine, ServeConfig,
                               SlotEngine)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--capacity", type=int, default=4)
    ap.add_argument("--max-context", type=int, default=64)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this example runs on the card; "
                         "pass --device cpu for the plain versions")

    cfg = get_config(args.arch).reduced()
    print(f"serving {cfg.name} ({cfg.family}); "
          f"{cfg.param_count() / 1e6:.2f}M params (reduced config)")
    params = init_params(torch.Generator().manual_seed(0), cfg)

    engine = SlotEngine(params, cfg, capacity=args.capacity,
                        max_context=args.max_context,
                        page_size=args.page_size,
                        serve_cfg=ServeConfig(), device=args.device)
    rng = np.random.default_rng(0)
    requests = [(rng.integers(0, cfg.vocab, (s0,)).astype(np.int32), t_new)
                for s0, t_new in [(24, 16), (12, 8), (32, 12), (8, 20),
                                  (16, 16), (24, 8)]]

    with ContinuousServer(engine, prefill_per_step=2) as server:
        futures = [server.submit(p, max_new_tokens=t) for p, t in requests]
        server.drain(timeout=600)
        outputs = [f.result() for f in futures]
        print(f"served {len(requests)} requests in {server.stats['steps']} "
              f"decode steps (mean occupancy "
              f"{server.mean_occupancy():.2f}, decode compiles "
              f"{engine.decode_compiles})")
    for i, out in enumerate(outputs):
        print(f"  req {i} ({len(requests[i][0])} -> {len(out)}): "
              f"{out.tolist()}")

    # oracle: sequential static-batch decode with the same cache budget
    oracle = DecodeEngine(params, cfg, device=args.device)
    for (prompt, t_new), out in zip(requests, outputs):
        want, _ = oracle.generate(prompt[None], max_new_tokens=t_new,
                                  cache_len=args.max_context)
        assert np.array_equal(out, want[0]), "continuous != sequential"
    print("serve OK (continuous outputs bit-identical to sequential decode)")


if __name__ == "__main__":
    main()
