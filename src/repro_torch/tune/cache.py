"""The on-disk tuning cache: measured winners that outlive the process.

A copy of the reference's ``tune/cache.py`` with a file of its own.
The compile cache (``compile/pipeline.py``) is in-memory and per-process;
measurement is expensive, so the autotuner persists its winners here and
``lower()`` consults this cache *before* the analytical tile chooser.
Two maps live in one JSON document (``tune_cache.json``):

``variants``
    compile-key -> the winning kernel variant (blocks, grid_order, accum,
    measured seconds).  The key is the **same tuple** the compile cache
    uses (``pipeline._cache_key``) hashed with sha256 over its ``repr``
    — Python's builtin ``hash`` is randomized per process, so it cannot
    key an on-disk store.  A tuned variant therefore applies exactly
    where the compiled kernel it was measured on would be reused.

``choices``
    algebra-level key (no dataflow) -> the winning *dataflow* choice
    (selected loops + T matrix) plus its variant, so a second
    ``tune()`` call on the same shape is a pure cache hit — no search,
    no measurement, no candidate lowering.

``groups``
    fused-group key (``pipeline._group_cache_key``) -> the measured
    merged-vs-sequential verdict for one graph chain: ``merged`` plus
    (when merged won) the winning ``bm``/``interleave`` knobs.  A
    ``merged: False`` entry is a real hit — it tells ``lower_group``
    to return None so the executor keeps per-node dispatch.

Robustness contract: a corrupt or truncated cache
file degrades to a warning plus the analytical fallback (never an
exception on the lower path); entries are version-stamped and silently
dropped on schema mismatch; writes are atomic (temp file + ``os.replace``)
so a crashed writer cannot corrupt readers; ``cache_info()`` exposes
hit/miss/store/invalid/corrupt counters for tests and benchmarks.

Location: ``$REPRO_TUNE_CACHE/torch`` if the variable is set, else
``~/.cache/repro-torch-tune`` — never the reference's file, whose keys
name another package's kernels.  The env var is re-read on every call
so tests can point each case at a fresh tmpdir (the reference's test
fixture sets the same variable, which isolates both caches at once).
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
import warnings
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

#: bump when the entry layout changes; mismatched entries are dropped
SCHEMA_VERSION = 1

_FILENAME = "tune_cache.json"
_ENV = "REPRO_TUNE_CACHE"

_LOCK = threading.RLock()
#: (path, stat) -> parsed doc, so the hot lower() path stats instead of
#: re-parsing; invalidated whenever the file changes or the env moves
_MEMO: Dict[str, Any] = {"path": None, "stat": None, "doc": None}
_STATS = {"hits": 0, "misses": 0, "stores": 0, "invalid": 0, "corrupt": 0}


def cache_dir() -> Path:
    """Resolve the cache directory (env var first, re-read every call)."""
    env = os.environ.get(_ENV)
    if env:
        return Path(env).expanduser() / "torch"
    return Path.home() / ".cache" / "repro-torch-tune"


def cache_path() -> Path:
    return cache_dir() / _FILENAME


def key_of(key_tuple: Tuple) -> str:
    """Stable cross-process digest of a compile-cache key tuple.

    The tuple is made of frozen dataclasses, strings, ints and numpy
    array reprs — all with deterministic ``repr`` — so sha256 over the
    repr is stable where builtin ``hash`` (randomized per process) is
    not.
    """
    return hashlib.sha256(repr(key_tuple).encode()).hexdigest()


def _empty_doc() -> Dict[str, Any]:
    return {"version": SCHEMA_VERSION, "variants": {}, "choices": {},
            "groups": {}}


def _load() -> Dict[str, Any]:
    """Parse (or reuse the memoized parse of) the cache document.

    Never raises: missing file -> empty doc; unparseable file -> one
    warning + empty doc (counted in ``corrupt``); wrong document version
    -> entries dropped (counted in ``invalid``).
    """
    path = cache_path()
    try:
        st = path.stat()
        stat = (st.st_mtime_ns, st.st_size)
    except OSError:
        stat = None
    with _LOCK:
        if (_MEMO["path"] == str(path) and _MEMO["stat"] == stat
                and _MEMO["doc"] is not None):
            return _MEMO["doc"]
    if stat is None:
        doc = _empty_doc()
    else:
        try:
            raw = json.loads(path.read_text())
            if not isinstance(raw, dict):
                raise ValueError("tuning cache root is not an object")
            if raw.get("version") != SCHEMA_VERSION:
                with _LOCK:
                    _STATS["invalid"] += 1
                doc = _empty_doc()
            else:
                doc = {
                    "version": SCHEMA_VERSION,
                    "variants": dict(raw.get("variants") or {}),
                    "choices": dict(raw.get("choices") or {}),
                    "groups": dict(raw.get("groups") or {}),
                }
        except (ValueError, OSError) as e:
            with _LOCK:
                _STATS["corrupt"] += 1
            warnings.warn(
                f"tuning cache at {path} is unreadable ({e}); falling "
                f"back to analytical choices", RuntimeWarning,
                stacklevel=3)
            doc = _empty_doc()
    with _LOCK:
        _MEMO.update(path=str(path), stat=stat, doc=doc)
    return doc


def _save(doc: Dict[str, Any]) -> None:
    """Atomic write (temp + rename) so readers never see a torn file."""
    path = cache_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent),
                               prefix=_FILENAME, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    try:
        st = path.stat()
        stat = (st.st_mtime_ns, st.st_size)
    except OSError:
        stat = None
    with _LOCK:
        _MEMO.update(path=str(path), stat=stat, doc=doc)


def _valid_variant(entry: Any) -> bool:
    return (isinstance(entry, dict)
            and entry.get("version") == SCHEMA_VERSION
            and isinstance(entry.get("blocks"), (list, tuple))
            and len(entry["blocks"]) == 3
            and all(isinstance(b, int) and b > 0 for b in entry["blocks"])
            and isinstance(entry.get("grid_order"), str)
            and isinstance(entry.get("accum"), str))


def _valid_group(entry: Any) -> bool:
    if not (isinstance(entry, dict)
            and entry.get("version") == SCHEMA_VERSION
            and isinstance(entry.get("merged"), bool)):
        return False
    if not entry["merged"]:
        return True                     # sequential verdict carries no knobs
    return (isinstance(entry.get("bm"), int) and entry["bm"] > 0
            and isinstance(entry.get("interleave"), str))


def _valid_choice(entry: Any) -> bool:
    return (isinstance(entry, dict)
            and entry.get("version") == SCHEMA_VERSION
            and isinstance(entry.get("selected"), (list, tuple))
            and isinstance(entry.get("T"), (list, tuple))
            and _valid_variant(entry.get("variant")))


# ---------------------------------------------------------------------------
# Variant map — keyed exactly like the compile cache
# ---------------------------------------------------------------------------

def lookup_variant(key: str) -> Optional[Dict[str, Any]]:
    """The persisted winning variant for a compile key digest, or None."""
    entry = _load()["variants"].get(key)
    with _LOCK:
        if entry is None:
            _STATS["misses"] += 1
            return None
        if not _valid_variant(entry):
            _STATS["invalid"] += 1
            _STATS["misses"] += 1
            return None
        _STATS["hits"] += 1
    return entry


def store_variant(key: str, *, blocks: Tuple[int, int, int],
                  grid_order: str, accum: str,
                  measured_s: Optional[float] = None,
                  untuned_s: Optional[float] = None,
                  meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    entry: Dict[str, Any] = {
        "version": SCHEMA_VERSION,
        "blocks": [int(b) for b in blocks],
        "grid_order": str(grid_order),
        "accum": str(accum),
    }
    if measured_s is not None:
        entry["measured_s"] = float(measured_s)
    if untuned_s is not None:
        entry["untuned_s"] = float(untuned_s)
    if meta:
        entry["meta"] = meta
    with _LOCK:
        doc = dict(_load())
        doc["variants"] = {**doc["variants"], key: entry}
        _save(doc)
        _STATS["stores"] += 1
    return entry


# ---------------------------------------------------------------------------
# Group map — merged-kernel verdicts per fused chain
# ---------------------------------------------------------------------------

def lookup_group(key: str) -> Optional[Dict[str, Any]]:
    """The persisted merged-vs-sequential verdict for a fused-group key
    digest (``pipeline._group_cache_key``), or None.  ``merged: False``
    entries are themselves cache hits — they record that sequential
    dispatch measured faster, so the executor should skip merging."""
    entry = _load()["groups"].get(key)
    with _LOCK:
        if entry is None:
            _STATS["misses"] += 1
            return None
        if not _valid_group(entry):
            _STATS["invalid"] += 1
            _STATS["misses"] += 1
            warnings.warn(
                f"tuning cache group entry {key[:12]} is corrupt or "
                f"version-skewed; falling back to the analytical verdict",
                RuntimeWarning, stacklevel=2)
            return None
        _STATS["hits"] += 1
    return entry


def store_group(key: str, *, merged: bool, bm: Optional[int] = None,
                interleave: Optional[str] = None,
                merged_s: Optional[float] = None,
                sequential_s: Optional[float] = None,
                meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    entry: Dict[str, Any] = {
        "version": SCHEMA_VERSION,
        "merged": bool(merged),
    }
    if bm is not None:
        entry["bm"] = int(bm)
    if interleave is not None:
        entry["interleave"] = str(interleave)
    if merged_s is not None:
        entry["merged_s"] = float(merged_s)
    if sequential_s is not None:
        entry["sequential_s"] = float(sequential_s)
    if meta:
        entry["meta"] = meta
    with _LOCK:
        doc = dict(_load())
        doc["groups"] = {**doc["groups"], key: entry}
        _save(doc)
        _STATS["stores"] += 1
    return entry


# ---------------------------------------------------------------------------
# Choice map — algebra-level winners (dataflow + variant)
# ---------------------------------------------------------------------------

def shape_key_for(alg, cfg, dtype, device) -> str:
    """Digest of the *algebra-level* tuning identity: everything the
    compile key carries except the dataflow (which is what the choice
    records).  The device takes the place of the reference's
    interpret/backend pair, as in ``pipeline._cache_key``."""
    from ..compile.pipeline import _dtype_name
    return key_of((alg, cfg, _dtype_name(dtype), str(device)))


def lookup_choice(key: str) -> Optional[Dict[str, Any]]:
    entry = _load()["choices"].get(key)
    with _LOCK:
        if entry is None:
            _STATS["misses"] += 1
            return None
        if not _valid_choice(entry):
            _STATS["invalid"] += 1
            _STATS["misses"] += 1
            return None
        _STATS["hits"] += 1
    return entry


def store_choice(key: str, *, selected, T, variant: Dict[str, Any],
                 dataflow_name: str = "",
                 meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    entry: Dict[str, Any] = {
        "version": SCHEMA_VERSION,
        "selected": [str(s) for s in selected],
        "T": [[int(v) for v in row] for row in T],
        "dataflow_name": str(dataflow_name),
        "variant": variant,
    }
    if meta:
        entry["meta"] = meta
    with _LOCK:
        doc = dict(_load())
        doc["choices"] = {**doc["choices"], key: entry}
        _save(doc)
        _STATS["stores"] += 1
    return entry


# ---------------------------------------------------------------------------
# Introspection / maintenance
# ---------------------------------------------------------------------------

def cache_info() -> Dict[str, int]:
    doc = _load()
    with _LOCK:
        return {"variants": len(doc["variants"]),
                "choices": len(doc["choices"]),
                "groups": len(doc.get("groups") or {}), **_STATS}


def cache_clear(*, counters_only: bool = False) -> None:
    """Delete the on-disk cache file (unless ``counters_only``) and reset
    the in-memory memo + counters."""
    with _LOCK:
        if not counters_only:
            try:
                cache_path().unlink()
            except OSError:
                pass
        _MEMO.update(path=None, stat=None, doc=None)
        for k in _STATS:
            _STATS[k] = 0
