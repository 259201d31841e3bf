"""Calibration: map measured cycles onto PaperCycleModel overrides.

A copy of the reference's ``tune/calibrate.py`` (jax-free); its records
name the device they were measured on in ``meta``.

The analytical model (``core/costmodel.py``) predicts cycles from first
principles — MACs, bandwidth, the STT tile.  Real machines disagree by a
template-dependent constant factor (the card's SIMT rate, launch
overhead, plain-version dispatch on the CPU...).  Rather than refit
every coefficient, we calibrate **multiplicatively**: each record pairs
one measured kernel with its model prediction, and the fit stores

* a per-``(template, algebra)`` **anchor** — the geometric mean of the
  measured/model cycle ratios observed for that exact pair, and
* a per-``template`` fallback — the geometric mean of that template's
  anchors — for algebras never measured.

Scale-only calibration is monotone-safe by construction: every scale is
clamped positive, so calibrated cycles are positive whenever model
cycles are, and the relative order of two designs under the *same*
(template, algebra) scale is exactly the analytical order.  The fitted
scales plus the raw records persist in ``calibration.json`` next to the
tuning cache, so ``PaperCycleModel(calibration=load())`` works in any
later process.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple

from . import cache as _cache

SCHEMA_VERSION = 1
_FILENAME = "calibration.json"

#: clamp fitted scales into a sane band; a ratio outside it means the
#: measurement or the model is broken, and an unbounded scale would let
#: one bad sample dominate every later prediction
_MIN_SCALE = 1e-6
_MAX_SCALE = 1e9


def _geomean(values: List[float]) -> float:
    vals = [v for v in values if v > 0.0 and math.isfinite(v)]
    if not vals:
        return 1.0
    return math.exp(sum(math.log(v) for v in vals) / len(vals))


def _clamp(s: float) -> float:
    if not math.isfinite(s) or s <= 0.0:
        return 1.0
    return min(max(s, _MIN_SCALE), _MAX_SCALE)


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Fitted measured/model cycle scales.

    ``scale_for`` resolves most-specific-first: exact (template, algebra)
    anchor, then the per-template geomean, then 1.0 (uncalibrated).
    Every stored scale is positive, so ``model_cycles * scale`` can never
    go negative or zero out a positive prediction.
    """

    per_template: Mapping[str, float] = dataclasses.field(
        default_factory=dict)
    anchors: Mapping[Tuple[str, str], float] = dataclasses.field(
        default_factory=dict)

    def scale_for(self, template: str, algebra: Optional[str] = None
                  ) -> float:
        if algebra is not None:
            s = self.anchors.get((template, algebra))
            if s is not None:
                return _clamp(s)
        return _clamp(self.per_template.get(template, 1.0))

    @property
    def templates(self) -> Tuple[str, ...]:
        return tuple(sorted(self.per_template))

    def __bool__(self) -> bool:
        return bool(self.per_template) or bool(self.anchors)


def fit(records: List[Dict[str, Any]]) -> Calibration:
    """Fit scales from measurement records.

    Each record needs ``template``, ``algebra``, ``model_cycles`` and
    ``measured_cycles``; records with non-positive or non-finite cycles
    are skipped (a zero model prediction has no defined ratio).
    """
    ratios: Dict[Tuple[str, str], List[float]] = {}
    for r in records:
        try:
            template = str(r["template"])
            algebra = str(r["algebra"])
            model = float(r["model_cycles"])
            measured = float(r["measured_cycles"])
        except (KeyError, TypeError, ValueError):
            continue
        if (model <= 0 or measured <= 0 or not math.isfinite(model)
                or not math.isfinite(measured)):
            continue
        ratios.setdefault((template, algebra), []).append(measured / model)
    anchors = {pair: _clamp(_geomean(v)) for pair, v in ratios.items()}
    by_template: Dict[str, List[float]] = {}
    for (template, _), s in anchors.items():
        by_template.setdefault(template, []).append(s)
    per_template = {t: _clamp(_geomean(v)) for t, v in by_template.items()}
    return Calibration(per_template=per_template, anchors=anchors)


# ---------------------------------------------------------------------------
# Persistence — calibration.json next to the tuning cache
# ---------------------------------------------------------------------------

def calibration_path() -> Path:
    return _cache.cache_dir() / _FILENAME


def _doc(records: List[Dict[str, Any]], cal: Calibration) -> Dict[str, Any]:
    return {
        "version": SCHEMA_VERSION,
        "records": records,
        "fitted": {
            "per_template": dict(cal.per_template),
            "anchors": [
                {"template": t, "algebra": a, "scale": s}
                for (t, a), s in sorted(cal.anchors.items())],
        },
    }


def load_records() -> List[Dict[str, Any]]:
    """The raw measurement records on disk (empty on any problem)."""
    path = calibration_path()
    try:
        raw = json.loads(path.read_text())
    except (OSError, ValueError):
        return []
    if not isinstance(raw, dict) or raw.get("version") != SCHEMA_VERSION:
        return []
    recs = raw.get("records")
    return ([r for r in recs if isinstance(r, dict)]
        if isinstance(recs, list) else [])


def load() -> Calibration:
    """The persisted calibration, refit from its raw records (the records
    are the source of truth; the fitted block is for humans/reports)."""
    return fit(load_records())


def record(template: str, algebra: str, model_cycles: float,
           measured_cycles: float,
           meta: Optional[Dict[str, Any]] = None) -> Calibration:
    """Append one measurement record, refit, persist, return the new fit.

    Re-recording the same (template, algebra) replaces prior samples for
    that pair — the tuner's newest measurement of a cell supersedes stale
    ones rather than diluting them in the geomean.
    """
    recs = [r for r in load_records()
            if not (r.get("template") == template
                    and r.get("algebra") == algebra)]
    entry: Dict[str, Any] = {
        "template": str(template), "algebra": str(algebra),
        "model_cycles": float(model_cycles),
        "measured_cycles": float(measured_cycles),
    }
    if meta:
        entry["meta"] = meta
    recs.append(entry)
    cal = fit(recs)
    path = calibration_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(_doc(recs, cal), indent=1, sort_keys=True))
    tmp.replace(path)
    return cal
