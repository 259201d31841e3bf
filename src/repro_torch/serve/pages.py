"""Paged decode cache: fixed-size pages + slot→page-table indirection.

The port of the reference's ``serve/pages.py``.  The per-call decode
cache (``models/decode.py``) allocates one dense ``(L, B, S, kv)`` block
per batch.  For a serving slot engine that is the wrong shape twice
over: every slot pays for the longest context whether it uses it or
not, and insert/evict would reallocate the batch.  This module
restructures the sequence-axis caches into **pages**:

* one shared pool per K/V leaf, ``(total_pages + 1, page, L * kv)`` — a
  page holds ``page_size`` token positions across *all* layers, and the
  last physical page is a scratch page that absorbs writes from inactive
  slots and backs unmapped table entries;
* a host-managed page table ``(capacity, pages_per_slot)`` with a free
  list — long and short sequences draw from the same pool, so a slot
  only reserves ``ceil((prompt + max_new) / page)`` pages;
* the gather through the paged-gather kernel (``kernels/paged.py``, the
  CUDA kernel on the card, its plain version on the CPU), the one-token
  write-back through plain indexing.

Pools are updated **in place** (``index_copy_`` and indexed
assignment), where the reference rebuilds them functionally.  Cache
leaves without a sequence axis are **lane pools**: the slot index is
their batch axis directly (the dense and moe families have none; the
SSM conv windows and states of the ssm and hybrid families are lanes,
and so are the encdec/vlm static cross K/V).  Insert writes a slot's
lane rows in place; each decode step replaces the SSM lanes with
``freeze_inactive``'s selection between the step's new lanes and the old
ones, so the decode step must hand back new lane tensors for them.  The
static cross lanes (``STATIC_PATHS``) are read-only after insert and
stay out of that selection, which would otherwise copy them every step.
A cache with no paged leaf at all (the ssm family) keeps a 1-page
geometry, so the table and the step stay uniform.

Mesh placement (``solve_page_placement``, ``place_pools``): the
partition solver picks the mesh axis that carries the decode attention's
batch, and every pool's page axis is split over it; each rank keeps its
contiguous block of pages.  A decode step gathers each rank's own pages
through the kernel (pages owned elsewhere read a zero page) and one sum
over the axis assembles the views; token writes and ``insert`` land on
the owning rank only.  Every rank runs the same decode on the assembled
views, so placed decode is bit-identical to the unsharded engine.

Bit-exactness contract: gathering a slot's pages yields exactly the
dense cache the per-call path would hold (unmapped positions read the
scratch page, whose garbage is masked to an exact zero contribution by
the position-validity masks in ``_decode_attn``), so continuous decode
reproduces sequential decode token-for-token.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..compile.pipeline import torch_dtype
from ..kernels import paged as paged_kernels
from ..kernels.ops import resolve_device

#: decode-cache paths whose leaves carry a sequence axis (axis 2 of an
#: ``(Lx, B, S, kv)`` leaf) and are therefore paged; everything else
#: (minus "pos", which the slot engine owns) becomes a lane pool.
PAGED_PATHS = (("self", "k"), ("self", "v"), ("shared", "k"), ("shared", "v"))
#: lane leaves that only insert writes (the encdec/vlm cross K/V): the
#: decode step reads them and hands them back unchanged
STATIC_PATHS = (("cross", "k"), ("cross", "v"))


def _flatten_cache(cache: Dict[str, Any]) -> Dict[Tuple[str, ...], Any]:
    flat = {}
    for k, v in cache.items():
        if k == "pos":
            continue
        if isinstance(v, dict):
            for k2, v2 in v.items():
                flat[(k, k2)] = v2
        else:
            flat[(k,)] = v
    return flat


def _nest(flat: Dict[Tuple[str, ...], Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


@dataclasses.dataclass(frozen=True)
class PageLayout:
    """Static geometry of one paged cache (hashable; holds no tensors)."""

    capacity: int
    page_size: int
    pages_per_slot: int            # logical pages in every slot's view
    total_pages: int               # physical pages (excluding scratch)
    seq_len: int                   # gathered view length per slot
    #: paged leaves: path -> (stack, feat, dtype name); pool is
    #: (total_pages + 1, page, stack * feat)
    paged: Tuple[Tuple[Tuple[str, ...], Tuple[int, int, str]], ...]
    #: lane leaves: path -> (shape, dtype name); slot index is axis 1
    lanes: Tuple[Tuple[Tuple[str, ...], Tuple[Tuple[int, ...], str]], ...]

    @property
    def scratch_page(self) -> int:
        return self.total_pages

    # -- device-side ops (run by the decode step) --------------------------
    def gather_views(self, pools: Dict[Tuple[str, ...], torch.Tensor],
                     table: torch.Tensor,
                     placement: Optional["PagePlacement"] = None
                     ) -> Dict[Tuple[str, ...], torch.Tensor]:
        """pools + page table -> per-slot contiguous cache views
        ``(stack, capacity, seq_len, feat)`` (what decode_step expects).
        Each view is a transposed view of the gathered buffer, no copy.
        With a ``placement`` the pools are this rank's blocks: the rank
        gathers its own pages (others read its zero page) and one sum
        over the placement's axis assembles the views."""
        if placement is not None:
            table = placement.local_reads(table)
        views = {}
        for path, (stack, feat, _) in self.paged:
            v = paged_kernels.paged_gather(pools[path], table)
            if placement is not None:
                v = placement.assemble(v)
            v = v.reshape(self.capacity, self.seq_len, stack, feat)
            views[path] = v.permute(2, 0, 1, 3)
        return views

    def scatter_written(self, pools: Dict[Tuple[str, ...], torch.Tensor],
                        table: torch.Tensor,
                        new_views: Dict[Tuple[str, ...], torch.Tensor],
                        pos: torch.Tensor, active: torch.Tensor,
                        placement: Optional["PagePlacement"] = None
                        ) -> Dict[Tuple[str, ...], torch.Tensor]:
        """Write back, in place, the single token position each slot just
        produced.

        ``new_views`` are decode_step's updated caches (the gathered view
        with one write at ``pos % seq_len`` per slot); only that position
        flows back to the pool — inactive slots are pointed at the
        scratch page so the write is an exact no-op for live data.  With a
        ``placement`` only the page's owner writes it; the other ranks
        write their sink page.  Returns ``pools``."""
        slot_pos = pos.long() % self.seq_len
        lpage = slot_pos // self.page_size
        off = slot_pos % self.page_size
        rows = torch.arange(self.capacity, device=pos.device)
        pid = table[rows, lpage].long()
        pid = torch.where(active, pid, torch.full_like(pid,
                                                       self.scratch_page))
        if placement is not None:
            pid = placement.local_writes(pid)
        for path, (stack, feat, _) in self.paged:
            v = new_views[path]                      # (stack, C, S, feat)
            written = v[:, rows, slot_pos]           # (stack, C, feat)
            written = written.transpose(0, 1).reshape(self.capacity,
                                                      stack * feat)
            paged_kernels.paged_scatter_token(pools[path], pid, off, written)
        return pools

    def freeze_inactive(self, lanes: Dict[Tuple[str, ...], torch.Tensor],
                        new_lanes: Dict[Tuple[str, ...], torch.Tensor],
                        active: torch.Tensor
                        ) -> Dict[Tuple[str, ...], torch.Tensor]:
        """Keep inactive slots' lane state (SSM conv/state) frozen:
        decode ran on garbage lanes for those slots and its updates must
        not stick.  Returns new tensors; ``new_lanes`` must not alias
        ``lanes``.  Static lanes are kept as they are."""
        out = {}
        for path, old in lanes.items():
            if path in STATIC_PATHS:
                out[path] = old
                continue
            new = new_lanes.get(path, old)
            mask = active.reshape((1, self.capacity)
                                  + (1,) * (old.dim() - 2))
            out[path] = torch.where(mask, new.to(old.dtype), old)
        return out


class PagedKVCache:
    """Device pools + host page table / free list for one slot engine.

    Built from the exact leaf shapes and dtypes of the slot engine's
    decode cache (``template_cache``: tensors, ``meta`` ones included, of
    shape ``(stack, capacity, S, feat)`` for the paged leaves), so
    inserting a prefilled sequence is a pure copy — no casts, no parity
    drift.  Pools live on ``device`` (the card unless ``device="cpu"``).
    Thread-safe: alloc/free/insert take the host lock.
    """

    def __init__(self, template_cache: Dict[str, Any], *, capacity: int,
                 page_size: int, total_pages: Optional[int] = None,
                 device=None):
        self.device = resolve_device(device)
        flat = _flatten_cache(template_cache)
        paged_meta, lane_meta = [], []
        seq_len = None
        for path, leaf in sorted(flat.items()):
            if path in PAGED_PATHS:
                stack, b, s, feat = leaf.shape
                if b != capacity:
                    raise ValueError(f"{path} {tuple(leaf.shape)}: batch "
                                     f"is not the capacity {capacity}")
                if seq_len is None:
                    seq_len = s
                if s != seq_len:
                    raise ValueError(f"paged leaves disagree on seq len: "
                                     f"{path} {s} != {seq_len}")
                paged_meta.append((path, (stack, feat,
                                          _dtype_name(leaf.dtype))))
            else:
                if leaf.shape[1] != capacity:
                    raise ValueError(f"{path} {tuple(leaf.shape)}: lane "
                                     f"axis is not the capacity {capacity}")
                lane_meta.append((path, (tuple(leaf.shape),
                                         _dtype_name(leaf.dtype))))
        if seq_len is None:
            # no sequence-axis cache at all: keep a 1-page geometry so the
            # table/step machinery stays uniform
            seq_len = page_size
        if seq_len % page_size:
            raise ValueError(f"page_size {page_size} must divide the cache "
                             f"sequence length {seq_len}")
        pages_per_slot = seq_len // page_size
        if total_pages is None:
            total_pages = capacity * pages_per_slot
        self.layout = PageLayout(
            capacity=capacity, page_size=page_size,
            pages_per_slot=pages_per_slot, total_pages=total_pages,
            seq_len=seq_len, paged=tuple(paged_meta), lanes=tuple(lane_meta))
        lay = self.layout
        self.pools = {
            path: torch.zeros((total_pages + 1, page_size, stack * feat),
                              dtype=torch_dtype(dt), device=self.device)
            for path, (stack, feat, dt) in lay.paged}
        self.lanes = {path: torch.zeros(shape, dtype=torch_dtype(dt),
                                        device=self.device)
                      for path, (shape, dt) in lay.lanes}
        #: this rank's share of the pools after ``place_pools`` (None: the
        #: pools are whole)
        self.placement: Optional[PagePlacement] = None
        self._lock = threading.Lock()
        self._free: List[int] = list(range(total_pages))
        self._slot_pages: Dict[int, List[int]] = {}
        self.table = np.full((capacity, pages_per_slot), lay.scratch_page,
                             np.int32)

    # -- host-side accounting --------------------------------------------
    def pages_needed(self, context_len: int) -> int:
        """Physical pages a request spanning ``context_len`` positions
        needs; a rolling (SWA) view cycles through every logical page."""
        lay = self.layout
        n = math.ceil(min(context_len, lay.seq_len) / lay.page_size)
        return lay.pages_per_slot if context_len > lay.seq_len else n

    def can_alloc(self, context_len: int) -> bool:
        with self._lock:
            return len(self._free) >= self.pages_needed(context_len)

    def alloc(self, slot: int, context_len: int) -> bool:
        """Reserve pages for one slot; False when the pool is exhausted
        (the scheduler keeps the request queued)."""
        n = self.pages_needed(context_len)
        with self._lock:
            if slot in self._slot_pages or len(self._free) < n:
                return False
            ids = [self._free.pop() for _ in range(n)]
            self._slot_pages[slot] = ids
            self.table[slot] = self.layout.scratch_page
            self.table[slot, :n] = ids
        return True

    def free(self, slot: int) -> None:
        with self._lock:
            ids = self._slot_pages.pop(slot, [])
            self._free.extend(ids)
            self.table[slot] = self.layout.scratch_page

    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    def occupancy(self) -> float:
        lay = self.layout
        with self._lock:
            return 1.0 - len(self._free) / max(lay.total_pages, 1)

    # -- insert (device) --------------------------------------------------
    def insert(self, slot: int, cache: Dict[str, Any]) -> None:
        """Copy one freshly-prefilled sequence (batch==1 cache dict) into
        the slot's reserved pages and lane rows, in place (placed pools:
        the pages this rank owns)."""
        lay = self.layout
        flat = _flatten_cache(cache)
        with self._lock:
            ids = list(self._slot_pages.get(slot, ()))
        if not ids:
            raise ValueError(f"slot {slot} has no pages allocated")
        pl = self.placement
        keep = [j for j, i in enumerate(ids) if pl is None or pl.owns(i)]
        idx = torch.tensor([ids[j] - (0 if pl is None else pl.lo)
                            for j in keep], dtype=torch.long,
                           device=self.device)
        sel = torch.tensor(keep, dtype=torch.long, device=self.device)
        for path, (stack, feat, _) in lay.paged:
            leaf = flat[path]                       # (stack, 1, S, feat)
            rows = leaf[:, 0].transpose(0, 1).reshape(
                lay.pages_per_slot, lay.page_size, stack * feat)
            pool = self.pools[path]
            pool.index_copy_(0, idx, rows[sel].to(pool.dtype))
        for path, _ in lay.lanes:
            lane = self.lanes[path]
            lane[:, slot] = flat[path][:, 0].to(lane.dtype)

    def gather_views(self, table: torch.Tensor
                     ) -> Dict[Tuple[str, ...], torch.Tensor]:
        """Every slot's cache view through the page table (placed or
        not)."""
        return self.layout.gather_views(self.pools, table, self.placement)

    def scatter_written(self, table: torch.Tensor,
                        new_views: Dict[Tuple[str, ...], torch.Tensor],
                        pos: torch.Tensor, active: torch.Tensor) -> None:
        """Write each slot's new token row back (the owner only, when
        placed)."""
        self.layout.scatter_written(self.pools, table, new_views, pos,
                                    active, self.placement)

    def device_table(self) -> torch.Tensor:
        """The page table as an int32 tensor on the pools' device (a
        copy: later host edits do not reach it)."""
        with self._lock:
            return torch.tensor(self.table, device=self.device)


# ---------------------------------------------------------------------------
# mesh placement: pages through the partition solver
# ---------------------------------------------------------------------------

def solve_page_placement(cfg, layout: PageLayout,
                         axes: Tuple[str, str] = ("x", "y"),
                         shape: Tuple[int, int] = (2, 2), *, device=None):
    """Solve the mesh partition for the decode-attention algebra and map
    it onto the page pools.

    Decode attention over a paged cache is a ``batched_gemv``:
    ``scores[b, s] = sum_d q[b, d] * K[b, s, d]`` with the slot x kv-head
    product as the batch dim.  The same front door that serves that
    algebra (``repro_torch.generate``, on ``device``: the card unless
    ``"cpu"``; the accelerator is generated for its plan and never
    called) yields the CommPlan whose ``plan.solve_partition`` decides
    which mesh axis shards the batch — and pages belong to slots, so the
    page axis of every pool shards over that axis.  Returns
    ``(PartitionSolution, Spec)``."""
    from .. import api
    from ..dist.comm_engine import Spec
    kv_heads = max(getattr(cfg, "n_kv_heads", 1), 1)
    acc = api.generate(
        "batched_gemv",
        bounds={"m": max(layout.capacity * kv_heads, 2),
                "k": max(getattr(cfg, "head_dim", 16), 2),
                "n": max(layout.seq_len, 2)},
        device=device, validate=False)
    sol = acc.kernel.partition_for(shape, axes)
    batch_axis = sol.batch_axis or sol.grid.get("m")
    if isinstance(batch_axis, tuple):
        batch_axis = batch_axis[0]
    return sol, Spec(batch_axis, None, None)


@dataclasses.dataclass(frozen=True)
class PagePlacement:
    """This rank's share of pools placed over one mesh axis: global pages
    ``[lo, lo + pages)`` of the padded page axis.  Its local pools hold
    those pages, then a zero page (read for pages owned elsewhere) and a
    sink page (written for them)."""

    mesh: Any            # dist.comm_engine.RankMesh
    axis: Optional[str]
    shards: int
    lo: int
    pages: int

    def owns(self, page: int) -> bool:
        return self.lo <= page < self.lo + self.pages

    def _local(self, ids: torch.Tensor, other: int) -> torch.Tensor:
        own = (ids >= self.lo) & (ids < self.lo + self.pages)
        return torch.where(own, ids - self.lo,
                           torch.full_like(ids, other)).to(ids.dtype)

    def local_reads(self, table: torch.Tensor) -> torch.Tensor:
        """The page table in this rank's pool: pages owned elsewhere read
        the zero page."""
        return self._local(table, self.pages)

    def local_writes(self, pid: torch.Tensor) -> torch.Tensor:
        """Write targets in this rank's pool: pages owned elsewhere go to
        the sink page."""
        return self._local(pid, self.pages + 1)

    def assemble(self, view: torch.Tensor) -> torch.Tensor:
        """The whole view from every rank's share along the axis: one sum
        of the views' bytes as integers.  Exactly one rank holds each
        page's bytes and the others hold zeros, so the sum is a copy,
        bit for bit whatever the values."""
        if self.shards == 1:
            return view
        bits = view.contiguous().view(torch.uint8)
        return self.mesh.psum(bits, (self.axis,)).view(view.dtype)


def place_pools(cache: PagedKVCache, mesh, spec) -> None:
    """Place every page pool over the mesh with the solved spec: the page
    axis split over the batch-carrying mesh axis ``spec[0]``, each rank
    keeping its contiguous block (the reference's ``NamedSharding`` of
    the pool).  The pool keeps its scratch page, so the page axis is
    padded up to a multiple of the axis size first.  ``mesh`` is a
    ``DeviceMesh`` or this rank's ``RankMesh``; every rank of it calls
    this.  Lane pools stay whole on every rank."""
    from ..dist.comm_engine import RankMesh
    rm = mesh if isinstance(mesh, RankMesh) else RankMesh(mesh)
    axis = spec[0]
    n = rm.sizes.get(axis, 1) if axis else 1
    pages = cache.layout.total_pages + 1
    per = -(-pages // n)
    lo = (rm.coord[axis] if n > 1 else 0) * per
    for path, pool in cache.pools.items():
        block = pool[lo:lo + per]
        extra = torch.zeros((per + 2 - block.shape[0],) + block.shape[1:],
                            dtype=pool.dtype, device=pool.device)
        cache.pools[path] = torch.cat([block, extra])
    cache.placement = PagePlacement(rm, axis if n > 1 else None, n, lo, per)
