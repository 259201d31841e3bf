"""Design-space exploration walkthrough on the PyTorch port (paper Fig.
6 in miniature).

``repro_torch.search`` enumerates every distinct GEMM dataflow TensorLib
can generate for one loop selection, costs each with the paper's
cycle/area/power model, and returns the ranked candidates;
``repro_torch.generate(search=...)`` consumes the ranking directly and
hands back the compiled winner — DSE to executable in two calls, the
winner running its CUDA template on the card.

    PYTHONPATH=src python examples/torch_dse_explore.py [--device cpu]
"""
import argparse

import torch

import repro_torch
from repro_torch.core import algebra, dse, plan, stt
from repro_torch.dist.schedules import schedule_from_comm_plan


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this example runs on the card; "
                         "pass --device cpu for the plain versions")

    g = algebra.gemm(512, 512, 512)
    # paired sweep: dataflow names repeat across distinct T's, so keep the
    # (report, dataflow) association instead of a name lookup
    pairs = dse.sweep_with_dataflows(g, selections=[("m", "n", "k")])
    print(f"distinct GEMM dataflows (one selection, |T entries| <= 1): "
          f"{len(pairs)}")

    good = [r for r, _ in pairs if r.normalized_perf >= 0.5]
    front = dse.pareto_front(good)
    print(f"efficient points: {len(good)}; pareto frontier: {len(front)}\n")

    ranked = repro_torch.search(g, top_k=10, selections=[("m", "n", "k")])
    print(f"{'dataflow':12s} {'perf':>6s} {'area':>7s} {'power':>7s}  "
          f"mesh schedule")
    for r, df in ranked:
        sched = schedule_from_comm_plan(plan.comm_plan_for(df))
        print(f"{r.dataflow_name:12s} {r.normalized_perf:6.3f} "
              f"{r.area_units:7.0f} {r.power_mw:6.1f}mW  {sched}")

    # generate the winner: candidates are lowered best-first at shrunk
    # bounds (so the python loop-nest oracle used for validation stays
    # fast); the first that validates becomes the accelerator
    small = g.with_bounds(m=16, n=16, k=16)
    small_ranked = [(r, stt.apply_stt(small, df.selected, df.T))
                    for r, df in ranked]
    acc = repro_torch.generate(small, search=small_ranked, validate=True,
                               device=args.device)
    print(f"\ngenerated search winner {acc.dataflow.name}: "
          f"template={acc.template} blocks={acc.kernel.blocks} "
          f"validated={acc.kernel.validated}")

    print("\nReading: MMT (multicast) = SUMMA all-gather matmul; "
          "SST (systolic) = Cannon ppermute rings; STS/TSS = ring "
          "reduce-scatter — one STT matrix selects both the kernel template "
          "and the collective schedule, and "
          "repro_torch.generate(...).sharded(mesh) executes the CommPlan "
          "directly.")


if __name__ == "__main__":
    main()
