"""BENCH_tune.json: the machine-readable tuning report.

A copy of the reference's ``tune/report.py`` (jax-free).  The
reference's ``benchmarks/perf_iterate.py --tune`` emits one document at
the repo root with, per registry cell: modeled vs measured cycles and tuned vs
untuned wall clock.  CI's tune smoke step re-validates the document with
:func:`validate_bench` and fails when the schema drifts — so the file is
a contract, not a printf.

Schema (version 1)::

    {
      "version": 1,
      "smoke": bool,
      "interpret": bool,
      "cells": [
        {
          "cell": str,            # registry cell name
          "algebra": str,
          "dataflow": str,        # winning dataflow name
          "template": str,
          "variant": {"blocks": [int, int, int],
                      "grid_order": str, "accum": str},
          "model_cycles": float,      # analytical prediction
          "calibrated_cycles": float, # prediction x fitted scale
          "measured_cycles": float,   # tuned median at model clock
          "untuned_s": float,         # measured medians (wall clock)
          "tuned_s": float,
          "speedup": float,           # untuned_s / tuned_s  (>= 1.0)
          "tune_cache_hit": bool
        }, ...
      ],
      "calibration": {"per_template": {str: float},
                      "anchors": [{"template": str, "algebra": str,
                                   "scale": float}, ...]}
    }
"""
from __future__ import annotations

from typing import Any, Dict, List

BENCH_SCHEMA_VERSION = 1

_CELL_REQUIRED = {
    "cell": str, "algebra": str, "dataflow": str, "template": str,
    "variant": dict, "model_cycles": (int, float),
    "calibrated_cycles": (int, float), "measured_cycles": (int, float),
    "untuned_s": (int, float), "tuned_s": (int, float),
    "speedup": (int, float), "tune_cache_hit": bool,
}


def validate_bench(doc: Any) -> List[str]:
    """Validate a BENCH_tune.json document; returns a list of problems
    (empty = valid).  Hand-rolled on purpose: no jsonschema dependency,
    and the error strings name the exact offending path."""
    errors: List[str] = []
    if not isinstance(doc, dict):
        return ["document root is not an object"]
    if doc.get("version") != BENCH_SCHEMA_VERSION:
        errors.append(f"version is {doc.get('version')!r}, "
                      f"expected {BENCH_SCHEMA_VERSION}")
    for field in ("smoke", "interpret"):
        if not isinstance(doc.get(field), bool):
            errors.append(f"{field} missing or not a bool")
    cells = doc.get("cells")
    if not isinstance(cells, list) or not cells:
        errors.append("cells missing or empty")
        cells = []
    for i, cell in enumerate(cells):
        where = f"cells[{i}]"
        if not isinstance(cell, dict):
            errors.append(f"{where} is not an object")
            continue
        for name, typ in _CELL_REQUIRED.items():
            v = cell.get(name)
            if (v is None or not isinstance(v, typ)
                    or (typ is not bool and isinstance(v, bool))):
                errors.append(f"{where}.{name} missing or wrong type")
        var = cell.get("variant")
        if isinstance(var, dict):
            blocks = var.get("blocks")
            if not (isinstance(blocks, list) and len(blocks) == 3
                    and all(isinstance(b, int) and b > 0 for b in blocks)):
                errors.append(f"{where}.variant.blocks must be 3 "
                              f"positive ints")
            for f in ("grid_order", "accum"):
                if not isinstance(var.get(f), str):
                    errors.append(f"{where}.variant.{f} missing")
        sp = cell.get("speedup")
        if (isinstance(sp, (int, float)) and not isinstance(sp, bool)
                and sp <= 0):
            errors.append(f"{where}.speedup must be positive")
    cal = doc.get("calibration")
    if not isinstance(cal, dict):
        errors.append("calibration missing or not an object")
    else:
        pt = cal.get("per_template")
        if not isinstance(pt, dict) or not all(
                isinstance(k, str) and isinstance(v, (int, float))
                and not isinstance(v, bool) and v > 0
                for k, v in pt.items()):
            errors.append("calibration.per_template must map template -> "
                          "positive scale")
        anchors = cal.get("anchors")
        if not isinstance(anchors, list):
            errors.append("calibration.anchors must be a list")
        else:
            for j, a in enumerate(anchors):
                if not (isinstance(a, dict)
                        and isinstance(a.get("template"), str)
                        and isinstance(a.get("algebra"), str)
                        and isinstance(a.get("scale"), (int, float))
                        and not isinstance(a.get("scale"), bool)
                        and a["scale"] > 0):
                    errors.append(f"calibration.anchors[{j}] malformed")
    return errors


def cell_entry(*, cell: str, algebra: str, dataflow: str, template: str,
               variant: Dict[str, Any], model_cycles: float,
               calibrated_cycles: float, measured_cycles: float,
               untuned_s: float, tuned_s: float,
               tune_cache_hit: bool) -> Dict[str, Any]:
    """Build one schema-conformant cell entry (keeps the benchmark and
    the validator in one module, so they cannot drift apart)."""
    return {
        "cell": cell, "algebra": algebra, "dataflow": dataflow,
        "template": template,
        "variant": {"blocks": [int(b) for b in variant["blocks"]],
                    "grid_order": str(variant["grid_order"]),
                    "accum": str(variant["accum"])},
        "model_cycles": float(model_cycles),
        "calibrated_cycles": float(calibrated_cycles),
        "measured_cycles": float(measured_cycles),
        "untuned_s": float(untuned_s),
        "tuned_s": float(tuned_s),
        "speedup": float(untuned_s / tuned_s) if tuned_s else 1.0,
        "tune_cache_hit": bool(tune_cache_hit),
    }
