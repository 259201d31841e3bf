"""Serving engines: batched LM decode + tensor-algebra accelerators.

The port of the reference's ``serve/engine.py``.

``DecodeEngine`` runs prefill and decode_step over a batch of
independent sequences with per-sequence EOS tracking; it is the
sequential parity oracle of the slot engine.  It casts the fp32 master
weights to the compute dtype once, when it is built
(``models.compute_params``).  Temperature sampling draws from a
``torch.Generator`` seeded by ``ServeConfig.seed``; its bits differ from
``jax.random``'s, so parity with the reference holds for greedy decoding.

``AcceleratorEngine`` serves the STT side of the repo through the front
door: requests name a registry algebra (plus optional bounds / dataflow)
and the engine answers with the generated accelerator's output.  Repeat
shapes are free — ``repro_torch.generate`` rides the bounded, locked
compile cache, and the engine keeps the accelerator handle per request
signature — and a mesh-bound engine executes every request through the
CommPlan interpreter (every rank of the mesh submits the same requests).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..kernels.ops import resolve_device
from ..models import decode as dec
from ..models.transformer import compute_params


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0       # 0 = greedy
    eos_id: Optional[int] = None
    seed: int = 0


def to_device(params: Dict[str, Any], device: torch.device
              ) -> Dict[str, Any]:
    """A parameter tree moved to ``device`` (leaves already there are
    kept, not copied)."""
    return {k: (to_device(v, device) if isinstance(v, dict)
                else v.to(device)) for k, v in params.items()}


def to_frontend(frontend, device: torch.device) -> Optional[torch.Tensor]:
    """The encdec/vlm stub input (numpy or a tensor) on ``device``."""
    return None if frontend is None else torch.as_tensor(frontend,
                                                         device=device)


def sample(logits: torch.Tensor, temperature: float,
           gen: torch.Generator) -> torch.Tensor:
    """(B, V) logits -> (B, 1) int64 tokens: argmax when ``temperature``
    is 0 (the first maximal index on ties, as ``jnp.argmax``), else one
    categorical draw from ``softmax(logits / temperature)``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)[:, None]
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)


class DecodeEngine:
    """Prefill + decode of a static batch on one device: the card unless
    ``device="cpu"``."""

    def __init__(self, params, cfg: ModelConfig,
                 serve_cfg: Optional[ServeConfig] = None, device=None):
        # NOTE: the default must be None + construct-per-instance.  A
        # ``serve_cfg: ServeConfig = ServeConfig()`` default evaluates ONE
        # shared instance at import time — mutating one engine's config
        # would silently reconfigure every other engine.
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = compute_params(to_device(params, self.device), cfg)
        self.serve_cfg = serve_cfg if serve_cfg is not None else ServeConfig()

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, *,
                 frontend: Optional[np.ndarray] = None,
                 max_new_tokens: Optional[int] = None,
                 cache_len: Optional[int] = None,
                 ) -> Tuple[np.ndarray, Dict]:
        """prompts: (B, S0) int.  Returns (generated (B, T), stats).

        ``cache_len`` overrides the decode cache's context budget (default
        ``S0 + max_new_tokens``).  The continuous-batching slot engine
        gathers fixed-length page views, so its sequential parity oracle
        is this method with ``cache_len`` pinned to the engine's
        ``max_context`` — same cache shape, same math.  ``frontend`` is
        the encdec/vlm stub input (B, F, D)."""
        scfg = self.serve_cfg
        t_new = max_new_tokens or scfg.max_new_tokens
        b, s0 = prompts.shape
        max_len = cache_len or (s0 + t_new)
        if max_len < s0 + t_new:
            raise ValueError(f"cache_len {max_len} < prompt {s0} + "
                             f"new tokens {t_new}")
        tokens = torch.as_tensor(np.asarray(prompts), device=self.device
                                 ).long()
        logits, cache = dec.prefill(self.params, tokens, self.cfg,
                                    frontend=to_frontend(frontend,
                                                         self.device),
                                    max_len=max_len)
        gen = torch.Generator(device=self.device).manual_seed(scfg.seed)
        out = []
        done = np.zeros((b,), bool)
        tok = sample(logits, scfg.temperature, gen)
        for t in range(t_new):
            out.append(tok.cpu().numpy().astype(np.int32))
            if scfg.eos_id is not None:
                done |= out[-1][:, 0] == scfg.eos_id
                if done.all():
                    break
            if t + 1 == t_new:
                break                  # the reference's last step is unused
            logits, cache = dec.decode_step(self.params, tok, cache,
                                            self.cfg)
            tok = sample(logits, scfg.temperature, gen)
        gen_tokens = np.concatenate(out, axis=1)
        return gen_tokens, {"prefill_len": s0,
                            "generated": gen_tokens.shape[1]}


class AcceleratorEngine:
    """Serve generated tensor-algebra accelerators (the front door, as a
    service) on one device — the card unless ``device="cpu"`` — or, with
    ``mesh=`` (a 2-D ``DeviceMesh`` of the device's type), across the
    mesh's ranks.

    ``submit("gemm", {"A": a, "B": b})`` generates (or cache-hits) the
    accelerator for the request's algebra/bounds/dataflow and executes it;
    with ``mesh=`` every request runs through the CommPlan interpreter.
    Request threads are safe: generation goes through the locked compile
    cache and the per-engine stats lock is local.
    """

    def __init__(self, mesh=None, dtype: torch.dtype = torch.float32,
                 device=None):
        if mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh
            if not isinstance(mesh, DeviceMesh):
                raise TypeError(f"mesh must be a torch.distributed "
                                f"DeviceMesh, got {type(mesh).__name__}")
        self.mesh = mesh
        self.dtype = dtype
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        #: request signature -> Accelerator.  The compile cache already
        #: dedupes CompiledKernels, but a mesh-bound Accelerator also
        #: carries the compiled MeshProgram — reusing the handle is what
        #: makes repeat shapes free on the mesh too.
        self._accs: Dict = {}
        self._stats = {"requests": 0, "algebras": set(), "partitions": {}}

    def _accelerator(self, algebra, dataflow, bounds):
        # algebra (str or frozen TensorAlgebra) and dataflow (None, str or
        # frozen Dataflow) are both hashable as-is
        key = (algebra, dataflow, tuple(sorted((bounds or {}).items())))
        with self._lock:
            acc = self._accs.get(key)
        if acc is None:
            from .. import api
            acc = api.generate(algebra, dataflow, bounds=bounds,
                               mesh=self.mesh, dtype=self.dtype,
                               device=self.device, validate=False)
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
            if acc.mesh is not None:
                # the solved partition this request executed (the proof no
                # algebra silently replicates)
                sol = acc.partition
                self._stats["partitions"][acc.algebra.name] = {
                    "strategy": sol.strategy,
                    "batch_axis": sol.batch_axis,
                    "replicated_inputs": sol.replicated_inputs()}
        return out

    def describe(self, algebra, *, dataflow=None,
                 bounds: Optional[Dict[str, int]] = None) -> str:
        """The served accelerator's ``describe()`` — per-tensor partition
        and comm bytes included when the engine is mesh-bound."""
        return self._accelerator(algebra, dataflow, bounds).describe()

    def stats(self) -> Dict:
        from ..compile import cache_info
        with self._lock:
            return {"requests": self._stats["requests"],
                    "algebras": sorted(self._stats["algebras"]),
                    "partitions": dict(self._stats["partitions"]),
                    "compile_cache": cache_info()}
