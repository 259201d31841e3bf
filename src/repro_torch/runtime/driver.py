"""Fault-tolerant training runtime.

The port of the reference's ``runtime/driver.py``:
  * periodic async checkpoints (atomic publish; restart-safe data
    pipeline),
  * crash/preemption recovery: ``run_with_restarts`` resumes from the
    latest checkpoint (tested by injecting failures mid-run),
  * straggler watchdog: a per-step wall-time EMA; steps slower than
    ``straggler_factor`` x EMA are recorded (tested with a simulated
    slow step),
  * elastic re-mesh: checkpoints are logical, so a restart may build
    another mesh shape and restore onto it (``checkpoint.store.restore``
    with the new mesh's specs).
The driver runs on the card unless given ``device=``; a step is timed
on the host clock up to ``torch.cuda.synchronize()`` (the reference
blocks on the loss).  Parameters are drawn from a ``torch.Generator``
seeded with the data seed, so they are not the reference's numbers; a
run that starts from a reference checkpoint restores them.

**On a mesh** (``mesh=``, a ``DeviceMesh`` from ``launch.mesh``, whose
device and backend the driver follows), every rank of the mesh runs one
driver.  Each draws the whole state, places it
(``trainer.place_state``: its blocks under ``trainer.state_shardings``
with ``rules``) and frees the whole one, and steps with
``trainer.make_sharded_train_step(..., donate=False)`` as the reference
does.  Every rank receives the global batch and keeps its rows (the
rank model of ``train.trainer``, where the reference hands each host its
shard).  Checkpoints gather the placed state one leaf at a time and one
rank writes them; a restore places each leaf under the specs of the
mesh the driver was built on, which may differ from the one that
saved it.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..checkpoint import store
from ..configs.base import ModelConfig
from ..data.pipeline import DataConfig, SyntheticPipeline, frontend_stub
from ..dist.comm_engine import mesh_device
from ..kernels.ops import resolve_device
from ..models import common, transformer
from ..optim import adamw
from ..train import trainer


class SimulatedFailure(RuntimeError):
    """Stands in for a node loss / preemption in tests."""


@dataclasses.dataclass
class RunConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    log_every: int = 10
    straggler_factor: float = 3.0
    ema_alpha: float = 0.3
    keep_ckpts: int = 3


class TrainDriver:
    """One device's driver, or one rank's of a mesh (``mesh=``: every
    rank of the mesh builds one and makes the same calls)."""

    def __init__(self, cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                 data_cfg: DataConfig, run_cfg: RunConfig,
                 mesh=None, rules=None,
                 failure_at: Optional[int] = None,
                 slow_step_at: Optional[int] = None, device=None):
        self.cfg, self.opt_cfg = cfg, opt_cfg
        self.data_cfg, self.run_cfg = data_cfg, run_cfg
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
        else:
            self.device = mesh_device(mesh)
            if device is not None and \
                    resolve_device(device).type != self.device.type:
                raise ValueError(f"device {device!r} is not the mesh's "
                                 f"({self.device})")
        self.failure_at = failure_at
        self.slow_step_at = slow_step_at
        self.ckpt = store.AsyncCheckpointer(run_cfg.ckpt_dir,
                                            keep=run_cfg.keep_ckpts,
                                            mesh=mesh)
        self.stragglers: List[int] = []
        self.metrics_log: List[Dict] = []

        gen = torch.Generator(device=self.device).manual_seed(data_cfg.seed)
        self.state = trainer.init_state(gen, cfg, opt_cfg)
        self.state_sh = None
        if mesh is None:
            self.step_fn = trainer.make_train_step(cfg, opt_cfg)
        else:
            self.step_fn, self.state_sh, _ = \
                trainer.make_sharded_train_step(
                    cfg, opt_cfg, mesh, self.state,
                    transformer.param_axes(cfg),
                    rules or common.DEFAULT_RULES, donate=False)
            # the whole state goes once this rank holds its blocks
            self.state = trainer.place_state(self.state, self.state_sh,
                                             mesh)
        self.pipeline = SyntheticPipeline(data_cfg)
        self.start_step = 0
        self._maybe_restore()

    # ------------------------------------------------------------------
    def _maybe_restore(self) -> None:
        latest = store.latest_step(self.run_cfg.ckpt_dir)
        if latest is None:
            return
        self.state, step, extra = store.restore(
            self.run_cfg.ckpt_dir, self.state, shardings=self.state_sh,
            mesh=self.mesh)
        self.start_step = step
        self.pipeline.restore(extra.get("data", {"step": step}))

    def _checkpoint(self, step: int) -> None:
        self.ckpt.save_async(step, self.state,
                             extra={"data": self.pipeline.state()},
                             specs=self.state_sh)

    # ------------------------------------------------------------------
    def _device_batch(self, np_batch: Dict[str, np.ndarray]) -> Dict:
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in np_batch.items()}
        if self.cfg.family in ("encdec", "vlm"):
            batch["frontend"] = torch.as_tensor(frontend_stub(
                np_batch["tokens"].shape[0], self.cfg.frontend_tokens,
                self.cfg.d_model, step=0, seed=self.data_cfg.seed),
                device=self.device)
        return batch

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self) -> Dict[str, Any]:
        ema = None
        step = self.start_step
        while step < self.run_cfg.total_steps:
            if self.failure_at is not None and step == self.failure_at:
                self.failure_at = None   # fail exactly once
                raise SimulatedFailure(f"injected failure at step {step}")
            batch = self._device_batch(self.pipeline.next())
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            self._sync()
            dt = time.perf_counter() - t0
            if self.slow_step_at is not None and step == self.slow_step_at:
                time.sleep(max(0.2, 4 * (ema or 0.05)))   # simulated straggler
                dt = time.perf_counter() - t0
            # straggler watchdog
            if ema is not None and dt > self.run_cfg.straggler_factor * ema:
                self.stragglers.append(step)
            ema = dt if ema is None else (
                self.run_cfg.ema_alpha * dt
                + (1 - self.run_cfg.ema_alpha) * ema)
            step += 1
            if step % self.run_cfg.ckpt_every == 0:
                self._checkpoint(step)
            if step % self.run_cfg.log_every == 0 or step == 1:
                self.metrics_log.append(
                    {"step": step,
                     **{k: float(v) for k, v in metrics.items()}})
        self.ckpt.wait()
        self._checkpoint_final(step)
        return {"final_step": step, "metrics": self.metrics_log,
                "stragglers": self.stragglers}

    def _checkpoint_final(self, step: int) -> None:
        store.save(self.run_cfg.ckpt_dir, step, self.state,
                   extra={"data": self.pipeline.state()},
                   specs=self.state_sh, mesh=self.mesh)


def run_with_restarts(make_driver: Callable[[], TrainDriver],
                      max_restarts: int = 3) -> Dict[str, Any]:
    """Cluster-controller stand-in: restart the driver (which restores from
    the latest checkpoint) whenever a node failure surfaces."""
    restarts = 0
    while True:
        driver = make_driver()
        try:
            out = driver.run()
            out["restarts"] = restarts
            return out
        except SimulatedFailure:
            # the failed driver's in-flight checkpoint write finishes (or
            # fails), on a mesh every rank passing its barrier, before
            # the restart lists the directory
            try:
                driver.ckpt.wait()
            except Exception:            # pragma: no cover
                pass
            restarts += 1
            if restarts > max_restarts:
                raise
