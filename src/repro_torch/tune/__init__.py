"""Measured autotuning: close the cost-model / card gap.

The port of the reference's ``tune`` package, between the analytical
pipeline (``core.dse`` ranks, ``core.tiling`` picks blocks) and the
executing kernels:

* :mod:`~repro_torch.tune.measure` — the one shared wall-clock harness,
* :mod:`~repro_torch.tune.tuner` — timed variant search over candidate
  dataflows x kernel knobs, and merged-vs-sequential verdicts for fused
  graph groups, persisted winners,
* :mod:`~repro_torch.tune.cache` — the on-disk tuning cache ``lower()``
  and ``lower_group()`` consult before the analytical choice,
* :mod:`~repro_torch.tune.calibrate` — measured/model cycle scales that
  turn ``PaperCycleModel`` predictions into card-tracking ones,
* :mod:`~repro_torch.tune.report` — the BENCH_tune.json schema +
  validator.
"""
from . import cache, calibrate, measure, report, tuner  # noqa: F401
from .calibrate import Calibration, fit as fit_calibration  # noqa: F401
from .calibrate import load as load_calibration  # noqa: F401
from .measure import Measurement, measure as measure_fn  # noqa: F401
from .tuner import TuneResult, Variant, rank_measured, tune  # noqa: F401
from .tuner import GroupTuneResult, GroupVariant, tune_group  # noqa: F401

__all__ = [
    "cache", "calibrate", "measure", "report", "tuner",
    "Calibration", "fit_calibration", "load_calibration",
    "Measurement", "measure_fn",
    "TuneResult", "Variant", "rank_measured", "tune",
    "GroupTuneResult", "GroupVariant", "tune_group",
]
