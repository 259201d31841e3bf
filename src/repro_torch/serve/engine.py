"""Serving generated tensor-algebra accelerators.

The port of the reference's ``AcceleratorEngine`` (``serve/engine.py``):
requests name a registry algebra (plus optional bounds / dataflow) and
the engine answers with the generated accelerator's output.  Repeat
shapes are free — ``repro_torch.generate`` rides the bounded, locked
compile cache, and the engine keeps the accelerator handle per request
signature.  The LM ``DecodeEngine`` arrives with the models slice.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

import torch

from ..kernels.ops import resolve_device


class AcceleratorEngine:
    """Serve generated tensor-algebra accelerators (the front door, as a
    service) on one device: the card unless ``device="cpu"``.

    ``submit("gemm", {"A": a, "B": b})`` generates (or cache-hits) the
    accelerator for the request's algebra/bounds/dataflow and executes it.
    Request threads are safe: generation goes through the locked compile
    cache and the per-engine stats lock is local.
    """

    def __init__(self, mesh=None, dtype: torch.dtype = torch.float32,
                 device=None):
        if mesh is not None:
            raise NotImplementedError(
                "a mesh-bound AcceleratorEngine arrives with the mesh slice")
        self.dtype = dtype
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        #: request signature -> Accelerator
        self._accs: Dict = {}
        self._stats = {"requests": 0, "algebras": set()}

    def _accelerator(self, algebra, dataflow, bounds):
        # algebra (str or frozen TensorAlgebra) and dataflow (None, str or
        # frozen Dataflow) are both hashable as-is
        key = (algebra, dataflow, tuple(sorted((bounds or {}).items())))
        with self._lock:
            acc = self._accs.get(key)
        if acc is None:
            from .. import api
            acc = api.generate(algebra, dataflow, bounds=bounds,
                               dtype=self.dtype, device=self.device,
                               validate=False)
            with self._lock:
                acc = self._accs.setdefault(key, acc)
        return acc

    def submit(self, algebra, operands: Dict[str, object], *,
               dataflow=None, bounds: Optional[Dict[str, int]] = None
               ) -> torch.Tensor:
        acc = self._accelerator(algebra, dataflow, bounds)
        out = acc(operands)
        with self._lock:
            self._stats["requests"] += 1
            self._stats["algebras"].add(acc.algebra.name)
        return out

    def describe(self, algebra, *, dataflow=None,
                 bounds: Optional[Dict[str, int]] = None) -> str:
        """The served accelerator's ``describe()``."""
        return self._accelerator(algebra, dataflow, bounds).describe()

    def stats(self) -> Dict:
        from ..compile import cache_info
        with self._lock:
            return {"requests": self._stats["requests"],
                    "algebras": sorted(self._stats["algebras"]),
                    "compile_cache": cache_info()}
