"""Continuous-batching slot engine: a fixed-capacity decode batch.

The port of the reference's ``serve/slots.py``.  The decode batch has
``capacity`` slots.  Each slot holds one in-flight sequence: its last
sampled token, its absolute position, and its share of the paged KV
cache (``pages.py``).  The decode step is built for a **capacity, never
an occupancy** — insert (a freshly prefilled request lands in a free
slot) and evict (a finished sequence frees its pages) mutate host-side
state and small device inputs only, so the batch never drains and the
step is never rebuilt (:attr:`SlotEngine.decode_compiles` counts the
step builds, keyed on capacity, and stays 1).

Prefill/decode split: prefill runs per request at its exact prompt
length, decode runs the whole slot batch every step.  Per-slot positions
ride the ``(B,)``-tensor ``cache["pos"]`` support in
``models/decode.py``, so sequences of different lengths coexist in one
step.  Each step gathers every slot's pages through the paged-gather
kernel and writes the one new K/V row per slot back into the pools in
place.

Every step returns a :class:`ResultTokens`: tokens + validity + lengths
packed into **one** array — one device→host copy per step.  Every
family runs here: the attention K/V (the hybrid's shared-attention K/V
too) are paged; the SSM conv windows and states are lane pools (one row
per slot, fp32), frozen for idle slots after each step; the encdec/vlm
cross K/V are static lane pools (one row per slot, bf16), written by
insert from the request's ``frontend`` and only read by the step.  The
MoE groups its tokens by batch row, so each slot routes within its own
expert capacity and idle slots take none of it.  Pools placed over a
mesh (``pages.place_pools``) are gathered and written through their
placement; the step is the same.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..compile.pipeline import torch_dtype
from ..configs.base import ModelConfig
from ..kernels.ops import resolve_device
from ..models import decode as dec
from ..models.transformer import compute_params, require_family
from .engine import ServeConfig, sample, to_device, to_frontend
from .pages import PagedKVCache, _flatten_cache, _nest


@dataclasses.dataclass(frozen=True)
class ResultTokens:
    """One decode step's results, packed into a single (capacity, 3)
    int32 array so only one device→host copy happens per step.

    Column ranges (JetStream-style index tuples):
    ``tokens_idx`` the sampled token, ``valid_idx`` whether the slot was
    live this step, ``length_idx`` the slot's absolute position after
    the step (prompt + generated so far).
    """

    data: np.ndarray
    tokens_idx: Tuple[int, int] = (0, 1)
    valid_idx: Tuple[int, int] = (1, 2)
    length_idx: Tuple[int, int] = (2, 3)

    def token_at(self, slot: int) -> int:
        return int(self.data[slot, self.tokens_idx[0]])

    def valid_at(self, slot: int) -> bool:
        return bool(self.data[slot, self.valid_idx[0]])

    def length_at(self, slot: int) -> int:
        return int(self.data[slot, self.length_idx[0]])


class SlotEngine:
    """Fixed-capacity continuous-batching decode engine over a paged
    cache, on one device (the card unless ``device="cpu"``).
    Thread-compatible (one caller drives step/insert/evict; the async
    server in ``server.py`` is that caller)."""

    def __init__(self, params, cfg: ModelConfig, *, capacity: int = 8,
                 max_context: int = 256, page_size: int = 16,
                 total_pages: Optional[int] = None,
                 serve_cfg: Optional[ServeConfig] = None, device=None):
        require_family(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = compute_params(to_device(params, self.device), cfg)
        self.capacity = int(capacity)
        self.max_context = int(max_context)
        self.serve_cfg = serve_cfg or ServeConfig()

        # the leaf shapes and dtypes a prefill at max_context hands over,
        # without running one: (L, capacity, cache slots, kv_dim) in the
        # compute dtype, and the cross K/V's (n, capacity, frontend
        # tokens, kv_dim) in bf16
        template = dec.init_cache(self.params, cfg, self.capacity,
                                  self.max_context,
                                  dtype=torch_dtype(cfg.dtype),
                                  device="meta")
        self.cache = PagedKVCache(template, capacity=self.capacity,
                                  page_size=page_size,
                                  total_pages=total_pages,
                                  device=self.device)
        #: decode steps built, by capacity
        self._steps: Dict[int, Callable] = {}
        self._prefill_lens: set = set()
        self._gen = torch.Generator(device=self.device).manual_seed(
            self.serve_cfg.seed)

        c = self.capacity
        self._tokens = np.zeros((c, 1), np.int64)
        self._pos = np.zeros((c,), np.int64)
        self._active = np.zeros((c,), bool)
        #: device twin of (tokens, pos, active, table).  The step carries
        #: tokens/pos forward on the device, so steady-state decode makes
        #: no host->device copy — the twin re-syncs from the host mirrors
        #: only after insert/evict touched them.
        self._dev: Optional[Tuple] = None

    # -- introspection ----------------------------------------------------
    @property
    def decode_compiles(self) -> int:
        """Decode-step builds — stays 1 across any sequence of
        insert/evict (the continuous-batching contract)."""
        return len(self._steps)

    @property
    def prefill_compiles(self) -> int:
        """Distinct prompt lengths prefilled (the reference's prefill jit
        cache entries)."""
        return len(self._prefill_lens)

    def free_slots(self) -> Tuple[int, ...]:
        return tuple(int(i) for i in np.flatnonzero(~self._active))

    def live_slots(self) -> Tuple[int, ...]:
        return tuple(int(i) for i in np.flatnonzero(self._active))

    @property
    def occupancy(self) -> float:
        return float(self._active.mean())

    def position(self, slot: int) -> int:
        return int(self._pos[slot])

    # -- the decode step ---------------------------------------------------
    def _build_step(self) -> Callable:
        cfg, lay = self.cfg, self.cache.layout
        scfg, params, gen = self.serve_cfg, self.params, self._gen

        def step(tokens, pos, active, table):
            views = self.cache.gather_views(table)
            cache: Dict[str, Any] = _nest({**views, **self.cache.lanes})
            cache["pos"] = pos
            logits, new_cache = dec.decode_step(params, tokens, cache, cfg)
            flat_new = _flatten_cache(new_cache)
            self.cache.scatter_written(
                table, {p: flat_new[p] for p, _ in lay.paged}, pos, active)
            self.cache.lanes = lay.freeze_inactive(
                self.cache.lanes, {p: flat_new[p] for p in self.cache.lanes},
                active)
            tok = sample(logits, scfg.temperature, gen)
            new_pos = torch.where(active, pos + 1, pos)
            new_tokens = torch.where(active[:, None], tok, tokens)
            packed = torch.cat([tok, active[:, None].long(),
                                new_pos[:, None]], dim=1)
            return packed, (new_tokens, new_pos)

        return step

    # -- slot lifecycle ----------------------------------------------------
    @torch.no_grad()
    def insert(self, prompt: np.ndarray, *, max_new_tokens: int,
               frontend: Optional[np.ndarray] = None
               ) -> Optional[Tuple[int, int]]:
        """Prefill one request and land it in a free slot.

        ``prompt``: (s0,) int; ``frontend``: the encdec/vlm stub input,
        (F, D) or (1, F, D).  Returns ``(slot, first_token)`` — the
        first token is sampled from the prefill logits, exactly like
        ``DecodeEngine.generate`` — or None when no slot or not enough
        free pages (the caller keeps the request queued).
        """
        s0 = int(prompt.shape[-1])
        if s0 + max_new_tokens > self.max_context:
            raise ValueError(
                f"prompt ({s0}) + max_new_tokens ({max_new_tokens}) exceeds "
                f"max_context ({self.max_context})")
        if (self.cfg.family in ("ssm", "hybrid")
                and s0 < self.cfg.conv_kernel - 1):
            # model-level floor (the sequential path shares it): the SSM
            # decode recurrence needs a full conv window from prefill
            raise ValueError(
                f"prompt ({s0}) shorter than the SSM conv window "
                f"({self.cfg.conv_kernel - 1})")
        free = self.free_slots()
        if not free:
            return None
        slot = free[0]
        if not self.cache.alloc(slot, s0 + max_new_tokens):
            return None
        tokens = torch.as_tensor(np.asarray(prompt), device=self.device
                                 ).long()[None]
        fe = to_frontend(frontend, self.device)
        if fe is not None and fe.dim() == 2:
            fe = fe[None]
        try:
            logits, cache_p = dec.prefill(self.params, tokens, self.cfg,
                                          frontend=fe,
                                          max_len=self.max_context)
        except Exception:
            self.cache.free(slot)          # a refused request holds nothing
            raise
        self._prefill_lens.add(s0)
        tok = int(sample(logits, self.serve_cfg.temperature, self._gen)[0, 0])
        self.cache.insert(slot, cache_p)
        self._pos[slot] = s0
        self._tokens[slot, 0] = tok
        self._active[slot] = True
        self._dev = None
        return slot, tok

    def evict(self, slot: int) -> None:
        """Free a finished slot's pages; the decode batch keeps running
        for the other slots (no drain, no rebuild)."""
        self.cache.free(slot)
        self._active[slot] = False
        self._pos[slot] = 0
        self._tokens[slot, 0] = 0
        self._dev = None

    # -- one decode step ---------------------------------------------------
    @torch.no_grad()
    def step(self) -> ResultTokens:
        """Advance every live slot one token; packed device→host copy."""
        step_fn = self._steps.get(self.capacity)
        if step_fn is None:
            step_fn = self._steps[self.capacity] = self._build_step()
        if self._dev is None:              # insert/evict since last step
            dev = self.device
            self._dev = (torch.tensor(self._tokens, device=dev),
                         torch.tensor(self._pos, device=dev),
                         torch.tensor(self._active, device=dev),
                         self.cache.device_table())
        tokens, pos, active, table = self._dev
        packed, (tokens, pos) = step_fn(tokens, pos, active, table)
        self._dev = (tokens, pos, active, table)
        data = packed.cpu().numpy().astype(np.int32)   # the one copy back
        live = self._active
        self._tokens[live, 0] = data[live, 0]
        self._pos[live] += 1
        return ResultTokens(data)
