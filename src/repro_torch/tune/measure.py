"""The shared wall-clock measurement harness.

The port of the reference's ``tune/measure.py``: one deterministic
timing loop for the tuner and the calibration fit, so every number the
tuning cache persists was produced the same way —

  * a fixed number of **warmup** calls runs first (kernel builds and
    first-call set-up land outside the clock),
  * each timed call waits for its result (``torch.cuda.synchronize`` on
    every CUDA device the result lives on — a launch-only time would
    flatter the asynchronous card),
  * the reported statistic is the **median** of ``repeats`` timed calls
    (robust to one-off scheduler noise; the min and mean are kept too).

The clock is the host's (``time.perf_counter``), not CUDA events: the
tuner's questions — which variant, merged or sequential dispatch — are
about what a caller pays per call, launches and host work included.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Tuple

import torch

#: defaults shared by the tuner and the calibration fit
DEFAULT_WARMUP = 1
DEFAULT_REPEATS = 5


def _cuda_devices(x, found: set) -> set:
    """The CUDA devices holding a tensor of ``x`` (a tensor, or a tuple,
    list or dict of them, nested)."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            found.add(x.device)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _cuda_devices(v, found)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, found)
    return found


def _block(x) -> None:
    """Wait until ``x`` (a result of the timed function) is computed: a
    synchronize of each CUDA device it lives on; a no-op on the CPU."""
    for dev in _cuda_devices(x, set()):
        torch.cuda.synchronize(dev)


@dataclasses.dataclass(frozen=True)
class Measurement:
    """One harness run: every timed sample plus the warmup cost."""

    times_s: Tuple[float, ...]
    warmup_s: float

    @property
    def median_s(self) -> float:
        s = sorted(self.times_s)
        n = len(s)
        mid = n // 2
        return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])

    @property
    def best_s(self) -> float:
        return min(self.times_s)

    @property
    def mean_s(self) -> float:
        return sum(self.times_s) / len(self.times_s)

    def cycles(self, freq_mhz: float) -> float:
        """The median expressed in cycles of a ``freq_mhz`` clock — the
        unit the calibration fit compares against ``CostReport.cycles``."""
        return self.median_s * freq_mhz * 1e6


def measure(fn: Callable, *args, warmup: int = DEFAULT_WARMUP,
            repeats: int = DEFAULT_REPEATS, **kwargs) -> Measurement:
    """Time ``fn(*args, **kwargs)``: warmup outside the clock, then
    median-of-``repeats``, each call waited for on its devices."""
    if repeats < 1:
        raise ValueError(f"repeats must be >= 1, got {repeats}")
    t0 = time.perf_counter()
    for _ in range(max(0, warmup)):
        _block(fn(*args, **kwargs))
    warmup_s = time.perf_counter() - t0
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        _block(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    return Measurement(times_s=tuple(times), warmup_s=warmup_s)
