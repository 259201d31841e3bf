"""Sharded-training selftest over gloo ranks on the CPU.

    PYTHONPATH=src python -m repro_torch.dist.train_selftest

Runs ``train.trainer.make_sharded_train_step`` on 8 ranks over reduced
configs (``dist.train_cases``) and holds it to the one-device step:
granite-8b on a 2x4 and a 1x8 ``("data", "model")`` mesh (explicit
collectives on; 4 heads on 8 ranks take the query-row path), and
mixtral-8x22b on 2x4 with the fallback MoE.  For each: the first batch's
loss within 1e-5 x |loss|, every gathered gradient leaf within 1e-4 x
max|g|, three steps' losses within 1e-5 and the parameters after them
within 1e-5 x max|p| (granite) or the larger of that and 2e-2 x the
summed lr (mixtral), and every rank holding the same whole state.  Then
the planted fault — the loss counted whole on every rank — must miss
the gradient limit.  Last, the elastic run: granite-8b's
``TrainDriver`` on 2x4 fails at step 3 and ``run_with_restarts``
resumes it on 4x2 from the step-2 checkpoint; every rank's restored
blocks equal the checkpoint's bit for bit, the six losses are within
1e-5 x |loss| and the final checkpoint's parameters within 1e-5 x
max|p| of one device's uninterrupted run.  Prints one line a case and
``ALL TRAIN MESH SELFTESTS PASSED``.
"""
from __future__ import annotations

import sys
import tempfile
import time

import numpy as np

from . import spawn
from . import train_cases as tc

CASES = (tc.TrainCase("granite-8b 2x4", "granite-8b"),
         tc.TrainCase("granite-8b 1x8", "granite-8b", mesh=(1, 8)),
         tc.TrainCase("mixtral-8x22b 2x4", "mixtral-8x22b",
                      overrides=(("sequence_parallel", True),)),
         tc.TrainCase("planted", "granite-8b", steps=0, planted=True))


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def compare(rec: dict, want: dict, dense: bool) -> dict:
    """The errors of a sharded record against the one-device one and
    whether each is inside its limit."""
    loss = abs(rec["loss0"] - want["loss0"]) / abs(want["loss0"])
    grad = max(_rel(rec["grads0"][p], g) for p, g in want["grads0"].items())
    steps = max([abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in
                 zip(rec["metrics"], want["metrics"])], default=0.0)
    lr_sum = sum(m["lr"] for m in want["metrics"])
    over = 0.0
    for p, w in want["params"].items():
        scale = float(np.abs(w).max())
        tol = 1e-5 * scale if dense else max(1e-5 * scale, 2e-2 * lr_sum)
        over = max(over, float(np.abs(rec["params"][p] - w).max()) / tol)
    return {"loss": loss, "grad": grad, "steps": steps, "params": over,
            "ok": (loss <= 1e-5 and grad <= 1e-4 and steps <= 1e-5
                   and over <= 1.0 and rec["agree"])}


def elastic(recs: list, root: str) -> dict:
    """The elastic run's records (every rank's) against one device's
    uninterrupted run: the largest loss and parameter errors and
    whether they and the restored blocks are inside their limits."""
    total = tc.ELASTIC_RUN[0]
    want = tc.one_device_run(tc.TrainCase("elastic", "granite-8b"),
                             f"{root}/one", total)
    want_loss = {m["step"]: m["loss"] for m in want["metrics"]}
    loss = 0.0
    for r in recs:
        got = {m["step"]: m["loss"] for log in r["metrics"] for m in log}
        if sorted(got) != sorted(want_loss):
            loss = float("inf")
            break
        loss = max([loss] + [abs(got[s] - w) / abs(w)
                             for s, w in want_loss.items()])
    got, ref = tc.ckpt_arrays(f"{root}/mesh"), tc.ckpt_arrays(f"{root}/one")
    params = max(float(np.abs(got[k] - w).max()) / float(np.abs(w).max())
                 for k, w in ref.items() if k.startswith(".params/"))
    restored = all(r["restored"] == [] for r in recs)
    return {"loss": loss, "params": params, "restored": restored,
            "restarts": recs[0]["restarts"],
            "ok": loss <= 1e-5 and params <= 1e-5 and restored
            and all(r["restarts"] == 1 for r in recs)}


def main() -> int:
    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="train_selftest_")
    got = spawn.run_ranks(tc.selftest_battery, 8, device="cpu",
                          args=(CASES, f"{tmp.name}/mesh"), timeout=300)
    failed = []
    for case in CASES:
        want = tc.one_device(case)
        res = compare(got[case.label], want, case.arch == "granite-8b")
        if case.planted:
            ok = res["grad"] > 1e-4
            print(f"planted fault (loss counted whole on 8 ranks): gradient "
                  f"off by {res['grad']:.3e} x max|g| "
                  f"({'caught' if ok else 'MISSED'})")
        else:
            ok = res["ok"]
            print(f"{case.label}: loss {res['loss']:.2e}, gradients "
                  f"{res['grad']:.2e} x max|g|, 3 steps' losses "
                  f"{res['steps']:.2e}, parameters at {res['params']:.2f} "
                  f"of their limit, replicas agree "
                  f"{got[case.label]['agree']} ({'ok' if ok else 'FAIL'})")
        if not ok:
            failed.append(case.label)
    res = elastic(got["elastic"], tmp.name)
    tmp.cleanup()
    print(f"elastic granite-8b 2x4 -> failure at step "
          f"{tc.ELASTIC_RUN[2]} -> 4x2: {res['restarts']} restart, restored "
          f"blocks exact {res['restored']}, losses {res['loss']:.2e}, "
          f"parameters {res['params']:.2e} x max|p| "
          f"({'ok' if res['ok'] else 'FAIL'})")
    if not res["ok"]:
        failed.append("elastic")
    print(f"{time.perf_counter() - t0:.1f} s on the CPU")
    if failed:
        print(f"TRAIN MESH SELFTESTS FAILED: {failed}")
        return 1
    print("ALL TRAIN MESH SELFTESTS PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
