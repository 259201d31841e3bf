"""BENCH_serve.json: the machine-readable serving-load report.

``benchmarks/serve_load.py`` emits one document at the repo root after
each open-loop run: the workload it generated, continuous-batching vs
static-batch results, and the throughput speedup.  CI's serve smoke step
re-validates the document with :func:`validate_serve` and fails when the
schema drifts — a contract, not a printf (same stance as
``tune/report.py``'s BENCH_tune.json).

Schema (version 1)::

    {
      "version": 1,
      "smoke": bool,
      "arch": str,                  # registry arch the load ran against
      "capacity": int,              # slot-engine decode batch capacity
      "page_size": int,
      "max_context": int,
      "workload": {
        "requests": int,
        "arrival": str,             # "poisson" | "burst"
        "rate_rps": float,          # Poisson arrival rate (0 for burst)
        "prompt_lens": [int, ...],  # the mixed-length buckets used
        "output_lens": [int, ...]
      },
      "continuous": {
        "throughput_tok_s": float,
        "p50_latency_s": float,
        "p99_latency_s": float,
        "mean_occupancy": float,    # mean live-slot fraction per step
        "steps": int,
        "decode_compiles": int      # must stay 1 across insert/evict
      },
      "static": {
        "throughput_tok_s": float,
        "p50_latency_s": float,
        "p99_latency_s": float
      },
      "speedup": float,             # continuous / static throughput
      "parity_checked": bool        # per-request tokens == sequential
    }
"""
from __future__ import annotations

from typing import Any, Dict, List

SERVE_SCHEMA_VERSION = 1

_NUM = (int, float)

_CONTINUOUS_REQUIRED = {
    "throughput_tok_s": _NUM, "p50_latency_s": _NUM, "p99_latency_s": _NUM,
    "mean_occupancy": _NUM, "steps": int, "decode_compiles": int,
}
_STATIC_REQUIRED = {
    "throughput_tok_s": _NUM, "p50_latency_s": _NUM, "p99_latency_s": _NUM,
}


def _check_fields(errors: List[str], where: str, obj: Any,
                  required: Dict[str, Any]) -> None:
    if not isinstance(obj, dict):
        errors.append(f"{where} missing or not an object")
        return
    for name, typ in required.items():
        v = obj.get(name)
        if v is None or not isinstance(v, typ) or isinstance(v, bool):
            errors.append(f"{where}.{name} missing or wrong type")


def validate_serve(doc: Any) -> List[str]:
    """Validate a BENCH_serve.json document; returns a list of problems
    (empty = valid).  Hand-rolled on purpose: no jsonschema dependency,
    and the error strings name the exact offending path."""
    errors: List[str] = []
    if not isinstance(doc, dict):
        return ["document root is not an object"]
    if doc.get("version") != SERVE_SCHEMA_VERSION:
        errors.append(f"version is {doc.get('version')!r}, "
                      f"expected {SERVE_SCHEMA_VERSION}")
    for field in ("smoke", "parity_checked"):
        if not isinstance(doc.get(field), bool):
            errors.append(f"{field} missing or not a bool")
    if not isinstance(doc.get("arch"), str):
        errors.append("arch missing or not a string")
    for field in ("capacity", "page_size", "max_context"):
        v = doc.get(field)
        if not isinstance(v, int) or isinstance(v, bool) or v <= 0:
            errors.append(f"{field} missing or not a positive int")
    wl = doc.get("workload")
    if not isinstance(wl, dict):
        errors.append("workload missing or not an object")
    else:
        n = wl.get("requests")
        if not isinstance(n, int) or isinstance(n, bool) or n <= 0:
            errors.append("workload.requests missing or not a positive int")
        if wl.get("arrival") not in ("poisson", "burst"):
            errors.append("workload.arrival must be 'poisson' or 'burst'")
        rate = wl.get("rate_rps")
        if not isinstance(rate, _NUM) or isinstance(rate, bool) or rate < 0:
            errors.append("workload.rate_rps missing or negative")
        for field in ("prompt_lens", "output_lens"):
            lens = wl.get(field)
            if not (isinstance(lens, list) and lens and all(
                    isinstance(x, int) and not isinstance(x, bool) and x > 0
                    for x in lens)):
                errors.append(f"workload.{field} must be a non-empty list "
                              f"of positive ints")
    _check_fields(errors, "continuous", doc.get("continuous"),
                  _CONTINUOUS_REQUIRED)
    _check_fields(errors, "static", doc.get("static"), _STATIC_REQUIRED)
    cont = doc.get("continuous")
    if isinstance(cont, dict):
        occ = cont.get("mean_occupancy")
        if (isinstance(occ, _NUM) and not isinstance(occ, bool)
                and not (0.0 <= occ <= 1.0)):
            errors.append("continuous.mean_occupancy must be in [0, 1]")
        dc = cont.get("decode_compiles")
        if isinstance(dc, int) and not isinstance(dc, bool) and dc != 1:
            errors.append(f"continuous.decode_compiles is {dc}; continuous "
                          f"batching must not recompile (expected 1)")
    sp = doc.get("speedup")
    if not isinstance(sp, _NUM) or isinstance(sp, bool) or sp <= 0:
        errors.append("speedup missing or not positive")
    return errors


def serve_entry(*, smoke: bool, arch: str, capacity: int, page_size: int,
                max_context: int, workload: Dict[str, Any],
                continuous: Dict[str, Any], static: Dict[str, Any],
                parity_checked: bool) -> Dict[str, Any]:
    """Build one schema-conformant document (keeps the benchmark and the
    validator in one module, so they cannot drift apart)."""
    doc = {
        "version": SERVE_SCHEMA_VERSION,
        "smoke": bool(smoke),
        "arch": str(arch),
        "capacity": int(capacity),
        "page_size": int(page_size),
        "max_context": int(max_context),
        "workload": {
            "requests": int(workload["requests"]),
            "arrival": str(workload["arrival"]),
            "rate_rps": float(workload["rate_rps"]),
            "prompt_lens": [int(x) for x in workload["prompt_lens"]],
            "output_lens": [int(x) for x in workload["output_lens"]],
        },
        "continuous": {
            "throughput_tok_s": float(continuous["throughput_tok_s"]),
            "p50_latency_s": float(continuous["p50_latency_s"]),
            "p99_latency_s": float(continuous["p99_latency_s"]),
            "mean_occupancy": float(continuous["mean_occupancy"]),
            "steps": int(continuous["steps"]),
            "decode_compiles": int(continuous["decode_compiles"]),
        },
        "static": {
            "throughput_tok_s": float(static["throughput_tok_s"]),
            "p50_latency_s": float(static["p50_latency_s"]),
            "p99_latency_s": float(static["p99_latency_s"]),
        },
        "parity_checked": bool(parity_checked),
    }
    st = doc["static"]["throughput_tok_s"]
    doc["speedup"] = ((doc["continuous"]["throughput_tok_s"] / st) if st
        else 1.0)
    return doc
