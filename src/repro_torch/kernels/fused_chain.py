"""The fused-group megakernels — the port of the reference's
``kernels/fused_chain.py``.

A merged graph group runs as ONE kernel launch (``csrc/fused_chain.cu``):

* ``fused_chain_matmul`` — the streamed lhs ladder: stage ``j`` computes
  ``x_{j+1} = cast(epilogue_j(x_j @ rhs_j))`` with ``x_0`` the group's
  lhs ``(m, k_0)`` and ``rhs_j`` ``(k_j, n_j)``;
* ``fused_dag`` — the stage-major DAG: ``dot`` and ``batched`` stages
  bound to external operands or earlier stages' outputs, a
  scratch-sourced rhs read transposed, an fp32 residual added after the
  epilogue, tap outputs.

The TPU kernels keep every intermediate in VMEM and run the stages as
ordered grid phases.  On Hopper the launch is cooperative and
persistent, and :func:`launch_plan` lays it out: stages grouped into
dependency levels, one phase a level whose work items (output tile x k
split) are spread over every co-resident CTA, a grid-wide sync between
phases, and a per-stage CTA tile and k split.  The intermediates live
in a global workspace of the chain dtype, each buffer on a 16-byte
boundary, which the wrapper allocates; split partials and softmax rows
in an fp32 one.  The two chain interleaves differ only in the tile
raster; the planner's ``bm`` stays part of the kernel's identity (cache
key) but is not the CTA tile — the kernel masks ragged edges, so rows
need no padding.

The dataclasses, validators and byte estimators are the reference's,
value for value: the graph planner gates on them.  On the CPU the
wrappers run :func:`chain_reference` / :func:`dag_reference`, the plain
versions; on CUDA tensors they launch the kernel or raise.  ``launches``
counts kernel launches.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build
from . import epilogue as _ep
from .stt_gemm import (LATER_TRAINING, _DTYPE_CODES, _fp32_product,
                       _no_backward, _on_cpu, _stream)

#: valid stage interleave orders (the merged-kernel tuner knob)
FUSED_INTERLEAVES = ("chain", "stage")

#: kernel launches since the last ``reset_launches``
launches = {"fused_chain": 0, "fused_dag": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@dataclasses.dataclass(frozen=True)
class ChainStage:
    """One gemm stage of a fused chain (hashable: a cache-key component).
    ``k`` is the stage's contraction extent (== the previous stage's
    ``n``), ``epilogue`` the spec applied to the fp32 product,
    ``has_bias`` whether the spec streams a bias row."""

    k: int
    n: int
    epilogue: Tuple[str, ...] = ()
    has_bias: bool = False


def validate_chain(stages: Sequence[ChainStage], k0: int
                   ) -> Tuple[ChainStage, ...]:
    """Normalize + validate a stage list: shapes chain, epilogues parse,
    bias flags agree with the specs."""
    stages = tuple(stages)
    if not stages:
        raise ValueError("a fused chain needs at least one stage")
    k = k0
    for j, st in enumerate(stages):
        if st.k != k:
            raise ValueError(
                f"stage {j} contracts over k={st.k} but receives a "
                f"(m, {k}) input; stages must chain n -> k")
        if st.k <= 0 or st.n <= 0:
            raise ValueError(f"stage {j} has non-positive dims "
                             f"({st.k}, {st.n})")
        spec = _ep.validate_spec(st.epilogue)
        if _ep.needs_bias(spec) != st.has_bias:
            raise ValueError(
                f"stage {j} epilogue {spec} "
                f"{'needs' if _ep.needs_bias(spec) else 'has no'} bias "
                f"but has_bias={st.has_bias}")
        k = st.n
    return stages


# ---------------------------------------------------------------------------
# Residency estimates — what the planner's budget gate prices
# ---------------------------------------------------------------------------

def chain_scratch_bytes(stages: Sequence[ChainStage], bm: int,
                        itemsize: int) -> int:
    """Intermediate scratch of the reference's ``interleave='chain'``: one
    ``(bm, n)`` strip per non-final stage, in the chain dtype."""
    return sum(bm * st.n * itemsize for st in tuple(stages)[:-1])


def stage_scratch_bytes(stages: Sequence[ChainStage], m: int,
                        itemsize: int) -> int:
    """Intermediate scratch of ``interleave='stage'``: the full ``(m, n)``
    tensor per non-final stage.  The CUDA kernel's workspace for both
    interleaves (its stages are separated by grid syncs), each buffer
    rounded up to ``SCRATCH_ALIGN`` bytes there."""
    return sum(m * st.n * itemsize for st in tuple(stages)[:-1])


def chain_vmem_bytes(stages: Sequence[ChainStage], m: int, k0: int,
                     bm: int, itemsize: int,
                     interleave: str = "chain") -> int:
    """Total residency estimate of the reference's merged kernel: lhs
    block + all pinned rhs (and bias rows, fp32) + output block +
    intermediate scratch.  The planner compares this against the array
    config's budget before committing to a merged lowering."""
    stages = tuple(stages)
    resident = bm * k0 * itemsize                     # lhs block
    resident += sum(st.k * st.n * itemsize for st in stages)   # weights
    resident += sum(4 * st.n for st in stages if st.has_bias)  # bias rows
    resident += bm * stages[-1].n * itemsize          # output block
    if interleave == "stage":
        resident += stage_scratch_bytes(stages, m, itemsize)
    else:
        resident += chain_scratch_bytes(stages, bm, itemsize)
    return resident


# ---------------------------------------------------------------------------
# DAG stages
# ---------------------------------------------------------------------------

#: the DAG template's single interleave order (stage-major, whole-tensor
#: phases)
DAG_INTERLEAVE = "dag"


@dataclasses.dataclass(frozen=True)
class DagStage:
    """One stage of a fused DAG group (hashable: a cache-key component).
    Operands are *bound*: each source is ``("ext", i)`` (the i-th
    external kernel operand, already in kernel-facing layout) or
    ``("scr", j)`` (stage j's output).

    * ``kind == "dot"`` — ``out(m, n) = lhs(m, k) @ rhs(k, n)``; a
      scratch-sourced rhs is read **transposed** (the producer's (n, m)
      output lands on this stage's rhs), so no transpose is materialized.
    * ``kind == "batched"`` — the batched_gemv image
      ``out[b, n] = sum_k lhs[b, k, n] * rhs[b, k]`` with the batch axis
      on the group's m axis; ``lhs`` is the external 3-D tensor.

    ``res`` adds a same-shape residual *after* the epilogue in fp32 (the
    graph's ``add`` node folded in); ``tap >= 0`` exports this stage's
    output to output slot ``tap`` for an unfused consumer.
    """

    m: int
    k: int
    n: int
    kind: str = "dot"                    # "dot" | "batched"
    lhs: Tuple[str, int] = ("ext", 0)
    rhs: Tuple[str, int] = ("ext", 0)
    res: Optional[Tuple[str, int]] = None
    epilogue: Tuple[str, ...] = ()
    has_bias: bool = False
    bias: int = -1                       # ext index of the (1, n) bias row
    tap: int = -1                        # tap output slot (-1: none)


def validate_dag(stages: Sequence[DagStage]) -> Tuple[DagStage, ...]:
    """Validate a DAG stage list: scratch references point backwards with
    chaining shapes, epilogues parse, bias/tap wiring is consistent."""
    stages = tuple(stages)
    if not stages:
        raise ValueError("a fused DAG needs at least one stage")
    taps = []
    for j, st in enumerate(stages):
        if st.kind not in ("dot", "batched"):
            raise ValueError(f"stage {j}: unknown kind {st.kind!r}")
        if st.m <= 0 or st.k <= 0 or st.n <= 0:
            raise ValueError(f"stage {j} has non-positive dims "
                             f"({st.m}, {st.k}, {st.n})")
        for role, src in (("lhs", st.lhs), ("rhs", st.rhs),
                          ("res", st.res)):
            if src is None:
                continue
            where, idx = src
            if where not in ("ext", "scr"):
                raise ValueError(f"stage {j} {role}: bad source {src!r}")
            if where == "scr":
                if not 0 <= idx < j:
                    raise ValueError(f"stage {j} {role} reads scratch "
                                     f"{idx}: must be an earlier stage")
                p = stages[idx]
                want = {"lhs": (st.m, st.k), "res": (st.m, st.n),
                        "rhs": ((st.n, st.k) if st.kind == "dot"
                                else (st.m, st.k))}[role]
                if (p.m, p.n) != want:
                    raise ValueError(
                        f"stage {j} {role} reads stage {idx} "
                        f"({p.m}, {p.n}) but needs {want}")
        if st.kind == "batched" and st.lhs[0] != "ext":
            raise ValueError(f"stage {j}: a batched stage's 3-D tensor "
                             f"must be an external operand")
        spec = _ep.validate_spec(st.epilogue)
        if _ep.needs_bias(spec) != st.has_bias:
            raise ValueError(
                f"stage {j} epilogue {spec} "
                f"{'needs' if _ep.needs_bias(spec) else 'has no'} bias "
                f"but has_bias={st.has_bias}")
        if st.has_bias and st.bias < 0:
            raise ValueError(f"stage {j} has_bias without a bias ext "
                             f"index")
        if st.tap >= 0:
            if j == len(stages) - 1:
                raise ValueError("the final stage is the group result; "
                                 "it cannot also be a tap")
            taps.append(st.tap)
    if sorted(taps) != list(range(len(taps))):
        raise ValueError(f"tap slots must be 0..{len(taps) - 1} with no "
                         f"gaps, got {sorted(taps)}")
    return stages


def dag_scratch_bytes(stages: Sequence[DagStage], itemsize: int) -> int:
    """Scratch of the DAG template: every non-final stage keeps its full
    ``(m, n)`` output across the stage-major phases."""
    return sum(st.m * st.n * itemsize for st in tuple(stages)[:-1])


# ---------------------------------------------------------------------------
# plain versions: the kernels' arithmetic in PyTorch
# ---------------------------------------------------------------------------

def chain_reference(lhs: torch.Tensor, *operands: torch.Tensor,
                    stages: Sequence[ChainStage], out_dtype=None
                    ) -> torch.Tensor:
    """The chain's per-stage math — fp32 product, epilogue, cast — with
    ``operands`` = the stages' ``(k, n)`` rhs, then one bias row per
    ``has_bias`` stage, in stage order."""
    stages = tuple(stages)
    n_stage = len(stages)
    rhss = operands[:n_stage]
    bias_rows = list(operands[n_stage:])
    mid_dtype = lhs.dtype
    out_dtype = out_dtype or lhs.dtype
    x = lhs
    bi = 0
    for j, st in enumerate(stages):
        acc = _fp32_product(x, rhss[j])
        if st.epilogue:
            b = None
            if st.has_bias:
                b = bias_rows[bi].reshape(-1)
                bi += 1
            acc = _ep.apply_epilogue(acc, st.epilogue, bias=b)
        x = acc.to(mid_dtype if j + 1 < n_stage else out_dtype)
    return x


def dag_reference(exts: Sequence[torch.Tensor], *,
                  stages: Sequence[DagStage], out_dtype=None
                  ) -> Tuple[torch.Tensor, ...]:
    """The DAG's per-stage math in PyTorch; returns ``(result, *taps)``."""
    stages = validate_dag(stages)
    dt = out_dtype or exts[0].dtype
    vals: list = []
    taps: dict = {}
    for st in stages:
        def fetch(src, transpose=False):
            where, idx = src
            buf = exts[idx] if where == "ext" else vals[idx]
            return buf.T if transpose else buf
        if st.kind == "batched":
            # out[b, n] = sum_k lhs[b, k, n] * rhs[b, k]
            acc = _fp32_product(fetch(st.rhs).unsqueeze(1),
                                fetch(st.lhs)).squeeze(1)
        else:
            acc = _fp32_product(fetch(st.lhs),
                                fetch(st.rhs, transpose=st.rhs[0] == "scr"))
        if st.epilogue:
            b = exts[st.bias].reshape(-1) if st.has_bias else None
            acc = _ep.apply_epilogue(acc, st.epilogue, bias=b)
        y = acc.to(dt)
        if st.res is not None:
            y = (y.to(torch.float32)
                 + fetch(st.res).to(torch.float32)).to(dt)
        vals.append(y)
        if st.tap >= 0:
            taps[st.tap] = y
    return (vals[-1],) + tuple(taps[i] for i in sorted(taps))


# ---------------------------------------------------------------------------
# the launch plan: dependency levels, per-stage tile and k split
# ---------------------------------------------------------------------------

#: k depth of a staged slab (``SLAB_K`` in csrc/simt_tile.cuh): split
#: boundaries fall on whole slabs
SLAB_K = 32
#: CTA tile edges the kernel instantiates, widest first (read by
#: :func:`card_plan` at each call)
TILES = (128, 64)
#: most k splits one stage may take
MAX_SPLIT = 16
#: the plan's cost model, in microseconds on an H100.  One slab of a CTA
#: tile: 128 x 128 x 32 is 1.05 MFLOP at the 33.6 TFLOP/s the
#: output-stationary tile kernel reaches (gemm 4096^3), over 132 SMs;
#: 64 x 64 a quarter of that at an assumed 0.6 of that rate.  An item
#: costs ITEM_SLABS slabs more than its k (the first slab's loads, the
#: flush); a split stage writes its fp32 partials, and its sum reads them
#: once and writes the output, at SUM_BYTES_PER_US, after a grid sync.
SLAB_US = {128: 4.1, 64: 1.7}
ITEM_SLABS = 2
SYNC_US = 3.0
SUM_BYTES_PER_US = 3.0e6
#: every scratch buffer starts on a 16-byte boundary, so that each one
#: keeps the 16-byte staging loads (an m x n buffer with m n % 4 != 0
#: would otherwise misalign every later one)
SCRATCH_ALIGN = 16


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """One stage's part of the launch: its dependency ``level`` (its
    phase), CTA ``tile`` edge (0 for a batched stage), ``split`` k splits
    of ``k_chunk`` each (the last one takes the rest), ``items`` work
    items from ``item0`` in its phase's list, and ``part``, the fp32
    offset of its split partials or softmax rows in the workspace (-1:
    flushed straight from registers).  Those are dead after the grid
    sync that ends their level, so each level's offsets start at 0."""

    level: int
    tile: int
    split: int
    k_chunk: int
    items: int
    item0: int
    part: int


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """The layout of one cooperative launch.  ``stages`` follow the
    caller's stage order; ``order`` lists the stage-table rows (stage
    indices by level, each level's dot stages first); ``phases`` holds
    one ``(first row, end row, items, post)`` per level, ``post`` when
    split sums or softmax rows follow the level's grid sync.
    ``ws_elems`` is the largest level's workspace."""

    grid: int
    stages: Tuple[StagePlan, ...]
    order: Tuple[int, ...]
    phases: Tuple[Tuple[int, int, int, int], ...]
    ws_elems: int

    def describe(self) -> str:
        lines = [f"grid {self.grid} CTAs, {len(self.phases)} phases, "
                 f"fp32 workspace {self.ws_elems * 4 / 1e6:.2f} MB"]
        for first, end, items, post in self.phases:
            parts = []
            for j in self.order[first:end]:
                sp = self.stages[j]
                parts.append(f"s{j} batched" if sp.tile == 0 else
                             f"s{j} {sp.tile}x{sp.tile}/{sp.split} "
                             f"({sp.items})")
            lines.append(f"  level {self.stages[self.order[first]].level}"
                         f": {items} items, {', '.join(parts)}"
                         + (" + sums/rows" if post else ""))
        return "\n".join(lines)


def dependency_levels(stages: Sequence[DagStage]) -> Tuple[int, ...]:
    """Each stage's level: one past the highest level of the stages its
    lhs, rhs and residual read (0 when it reads only external
    operands)."""
    levels: list = []
    for st in stages:
        reads = [src[1] for src in (st.lhs, st.rhs, st.res)
                 if src is not None and src[0] == "scr"]
        levels.append(1 + max((levels[i] for i in reads), default=-1))
    return tuple(levels)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _tiles(st: DagStage, tile: int) -> int:
    return _cdiv(st.m, tile) * _cdiv(st.n, tile)


def _plane(st: DagStage) -> int:
    """fp32 elements of one split's partials: m n in whole float4s."""
    return _cdiv(st.m * st.n, 4) * 4


def _split(k: int, s: int) -> Tuple[int, int]:
    """(split, k_chunk) nearest ``s`` splits of a contraction of extent
    ``k``: chunks of whole slabs, none empty."""
    kc = _cdiv(_cdiv(k, s), SLAB_K) * SLAB_K
    return _cdiv(k, kc), kc


def _item_costs(st: DagStage, tile: int, split: int, kc: int) -> list:
    """Modelled microseconds of each of a stage's items, in item order
    (split-major, as the kernel numbers them)."""
    out = []
    for sp in range(split):
        slabs = _cdiv(min(st.k, (sp + 1) * kc) - sp * kc, SLAB_K)
        out += [(slabs + ITEM_SLABS) * SLAB_US[tile]] * _tiles(st, tile)
    return out


def _level_cost(stages, choice: dict, grid: int) -> float:
    """Modelled time of one level: its items dealt round-robin over the
    grid (the busiest CTA), then the split sums."""
    costs = np.array([c for j, (t, s, kc) in choice.items()
                      for c in _item_costs(stages[j], t, s, kc)])
    costs = np.pad(costs, (0, -len(costs) % grid))
    busiest = float(costs.reshape(-1, grid).sum(axis=0).max())
    sums = [j for j, (_, s, _) in choice.items() if s > 1]
    if not sums:
        return busiest
    rows = all(_ep.has_softmax(stages[j].epilogue) for j in sums)
    return busiest + (0.0 if rows else SYNC_US) + sum(
        4.0 * (2 * choice[j][1] + 1) * stages[j].m * stages[j].n
        for j in sums) / SUM_BYTES_PER_US


def _choose(stages, dots: list, grid: int, tiles: Tuple[int, ...]
            ) -> dict:
    """Tile and split of each dot stage of one level: 128-wide tiles and
    no split where the level's 128-tiles fill a wave of the grid.  Else
    the options that minimise the level's modelled time: first one tile
    and split count for every stage, then stage by stage (two passes;
    ties keep the wider tile and the fewer splits)."""
    if sum(_tiles(stages[j], tiles[0]) for j in dots) >= grid:
        return {j: (tiles[0], *_split(stages[j].k, 1)) for j in dots}
    options = [(t, s) for t in tiles for s in range(1, MAX_SPLIT + 1)]

    def cost(choice):
        return _level_cost(stages, choice, grid)
    choice = min(({j: (t, *_split(stages[j].k, s)) for j in dots}
                  for t, s in options), key=cost)
    for _ in range(2):
        for j in dots:
            choice[j] = min(((t, *_split(stages[j].k, s))
                             for t, s in options),
                            key=lambda o: cost({**choice, j: o}))
    return choice


def launch_plan(stages: Sequence[DagStage], sms: int,
                ctas_per_sm: int = 1,
                tiles: Tuple[int, ...] = TILES) -> LaunchPlan:
    """Lay out one cooperative launch of ``stages`` (``DagStage`` specs:
    shapes, sources and epilogues are read) on ``sms`` SMs holding
    ``ctas_per_sm`` CTAs each, with CTA tiles from ``tiles`` (widest
    first).  Pure: the CPU tests check it."""
    stages = tuple(stages)
    grid = sms * ctas_per_sm
    levels = dependency_levels(stages)
    order = tuple(sorted(range(len(stages)),
                         key=lambda j: (levels[j], stages[j].kind != "dot",
                                        j)))
    plans: dict = {}
    phases = []
    ws_elems = 0
    for lv in range(max(levels) + 1):
        members = [j for j in order if levels[j] == lv]
        dots = [j for j in members if stages[j].kind == "dot"]
        choice = _choose(stages, dots, grid, tiles)
        items = part_end = 0
        for j in dots:
            st = stages[j]
            tile, split, kc = choice[j]
            part = -1
            if split > 1 or _ep.has_softmax(st.epilogue):
                part, part_end = part_end, part_end + split * _plane(st)
            plans[j] = StagePlan(lv, tile, split, kc,
                                 _tiles(st, tile) * split, items, part)
            items += plans[j].items
        for j in members[len(dots):]:     # batched rows: past every item
            st = stages[j]
            part = -1
            if _ep.has_softmax(st.epilogue):
                part, part_end = part_end, part_end + _plane(st)
            plans[j] = StagePlan(lv, 0, *_split(st.k, 1), 0, items, part)
        ws_elems = max(ws_elems, part_end)
        first = order.index(members[0])
        phases.append((first, first + len(members), items,
                       int(any(plans[j].part >= 0 for j in members))))
    return LaunchPlan(grid, tuple(plans[j] for j in range(len(stages))),
                      order, tuple(phases), ws_elems)


def chain_as_dag(stages: Sequence[ChainStage], m: int
                 ) -> Tuple[DagStage, ...]:
    """A chain's stages as the DAG stages :func:`launch_plan` reads:
    stage j's lhs is stage j - 1's output (the group's lhs for j = 0)."""
    return tuple(DagStage(m, st.k, st.n,
                          lhs=("ext", 0) if j == 0 else ("scr", j - 1),
                          rhs=("ext", j + 1), epilogue=st.epilogue)
                 for j, st in enumerate(stages))


_CARD_GRIDS: dict = {}
#: plans by (stages, SMs, CTAs an SM): a plan takes tens of milliseconds
#: of Python to search, a launch tens of microseconds
_cached_plan = functools.lru_cache(maxsize=256)(launch_plan)


def card_plan(stages: Sequence[DagStage], dtype: torch.dtype,
              device) -> LaunchPlan:
    """:func:`launch_plan` on the card of ``device``: its SM count and the
    kernel's CTAs an SM for ``dtype`` (asked once), each stage list
    planned once."""
    lib = _build.library("fused_chain")   # raises first where none builds
    device = torch.device(device)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    key = (index, dtype)
    if key not in _CARD_GRIDS:
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        per_sm = lib.fused_ctas_per_sm(_DTYPE_CODES[dtype])
        if per_sm < 1:
            raise RuntimeError(f"the fused kernel fits no CTA on an SM "
                               f"(code {per_sm})")
        _CARD_GRIDS[key] = (sms, per_sm)
    return _cached_plan(tuple(stages), *_CARD_GRIDS[key], TILES)


# ---------------------------------------------------------------------------
# kernel launch plumbing: the stage table
# ---------------------------------------------------------------------------

#: stage-table word offsets (``Field`` in csrc/fused_chain.cu)
FIELDS = ("kind", "m", "k", "n", "lhs", "ls0", "ls1", "ls2", "rhs", "rs0",
          "rs1", "res", "res0", "res1", "res_f32", "bias", "out", "tap",
          "tile", "split", "k_chunk", "item0", "part", "n_ops")
_F = {name: i for i, name in enumerate(FIELDS)}
_F_CODE = len(FIELDS)
_F_PARAM = _F_CODE + _ep.MAX_OPS
STAGE_WORDS = _F_PARAM + _ep.MAX_OPS
#: phase-table words (``PhaseField``): first row, end row, items, post
PHASE_WORDS = 4


def _strides(t: torch.Tensor, rank: int) -> Tuple[int, ...]:
    return tuple(t.stride()) + (0,) * (3 - rank)


def _stage_row(kind: str, m: int, k: int, n: int, lhs: torch.Tensor,
               rhs: torch.Tensor, res: Optional[torch.Tensor],
               bias: Optional[torch.Tensor], out: torch.Tensor,
               tap: Optional[torch.Tensor], sp: StagePlan,
               epilogue: Tuple[str, ...]) -> list:
    """One stage's table words: shapes, operand pointers and strides (in
    elements), its plan (tile, split, item range, workspace offset), the
    epilogue's opcodes and float parameters (as bits)."""
    codes, params = _ep.encode(epilogue)
    row = [0] * STAGE_WORDS
    row[_F["kind"]] = 0 if kind == "dot" else 1
    row[_F["m"]], row[_F["k"]], row[_F["n"]] = m, k, n
    row[_F["lhs"]] = lhs.data_ptr()
    (row[_F["ls0"]], row[_F["ls1"]],
     row[_F["ls2"]]) = _strides(lhs, lhs.dim())
    row[_F["rhs"]] = rhs.data_ptr()
    row[_F["rs0"]], row[_F["rs1"]] = rhs.stride()
    if res is not None:
        row[_F["res"]] = res.data_ptr()
        row[_F["res0"]], row[_F["res1"]] = res.stride()
        row[_F["res_f32"]] = int(res.dtype == torch.float32)
    row[_F["bias"]] = 0 if bias is None else bias.data_ptr()
    row[_F["out"]] = out.data_ptr()
    row[_F["tap"]] = 0 if tap is None else tap.data_ptr()
    (row[_F["tile"]], row[_F["split"]], row[_F["k_chunk"]],
     row[_F["item0"]], row[_F["part"]]) = (sp.tile, sp.split, sp.k_chunk,
                                          sp.item0, sp.part)
    row[_F["n_ops"]] = len(codes)
    row[_F_CODE:_F_CODE + len(codes)] = codes
    bits = np.asarray(params, dtype=np.float32).view(np.int32)
    row[_F_PARAM:_F_PARAM + len(codes)] = [int(b) for b in bits]
    return row


def _scratch(shapes: Sequence[Tuple[int, int]], dtype: torch.dtype,
             device) -> list:
    """Views ``(m, n)`` of one workspace allocation, each starting on a
    ``SCRATCH_ALIGN`` boundary."""
    step = SCRATCH_ALIGN // torch.empty((), dtype=dtype).element_size()
    offs, off = [], 0
    for m, n in shapes:
        offs.append(off)
        off += _cdiv(m * n, step) * step
    buf = torch.empty(off, dtype=dtype, device=device)
    return [buf[o:o + m * n].view(m, n) for o, (m, n) in zip(offs, shapes)]


def _launch(entry: str, dtype: torch.dtype, rows: list, plan: LaunchPlan,
            device, *extra) -> None:
    """Copy the stage and phase tables to the device and launch
    ``entry`` on the plan's grid."""
    lib = _build.library("fused_chain")
    if (lib.fused_stage_words(), lib.fused_phase_words()) != (
            STAGE_WORDS, PHASE_WORDS):
        raise RuntimeError("stage-table layout differs between "
                           "kernels/fused_chain.py and csrc/fused_chain.cu")
    words = [w for j in plan.order for w in rows[j]]
    words += [w for phase in plan.phases for w in phase]
    # through pinned memory, so that the copy does not wait for the
    # stream's earlier work
    table = torch.tensor(words, dtype=torch.int64).pin_memory().to(
        device, non_blocking=True)
    ws = (torch.empty(plan.ws_elems, dtype=torch.float32, device=device)
          if plan.ws_elems else None)
    _build.check(getattr(lib, entry)(
        _DTYPE_CODES[dtype], table.data_ptr(), len(rows), len(plan.phases),
        None if ws is None else ws.data_ptr(), *extra, plan.grid,
        _stream()), entry)


def _check_cuda_dtype(dtype, what: str) -> None:
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"the fused kernels take float32 or bfloat16 "
                         f"{what}, got {dtype}")


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def fused_chain_matmul(lhs: torch.Tensor,
                       rhss: Sequence[torch.Tensor],
                       biases: Sequence[torch.Tensor] = (), *,
                       stages: Sequence[ChainStage],
                       bm: Optional[int] = None,
                       interleave: str = "chain",
                       out_dtype=None) -> torch.Tensor:
    """Run a fused gemm chain as one kernel launch.

    ``lhs`` is ``(m, k_0)``; ``rhss[j]`` is stage j's kernel-facing
    ``(k_j, n_j)`` operand (any strides: gemm's ``(n, k)`` storage is
    passed as its transposed view); ``biases`` holds one ``(n_j,)``
    vector per ``has_bias`` stage, in stage order.  ``bm=None`` means
    ``bm = m``.  The graph planner gates on :func:`chain_vmem_bytes`
    before it merges a group; this wrapper runs what it is given.
    """
    m, k0 = lhs.shape
    stages = validate_chain(stages, k0)
    if interleave not in FUSED_INTERLEAVES:
        raise ValueError(f"interleave must be one of {FUSED_INTERLEAVES}, "
                         f"got {interleave!r}")
    if len(rhss) != len(stages):
        raise ValueError(f"{len(stages)} stages need {len(stages)} rhs "
                         f"operands, got {len(rhss)}")
    n_bias = sum(1 for st in stages if st.has_bias)
    if len(biases) != n_bias:
        raise ValueError(f"chain has {n_bias} bias stage(s) but "
                         f"{len(biases)} bias vector(s) were given")
    for j, (st, r) in enumerate(zip(stages, rhss)):
        if tuple(r.shape) != (st.k, st.n):
            raise ValueError(f"stage {j} rhs must be ({st.k}, {st.n}), "
                             f"got {tuple(r.shape)}")
    bm = m if bm is None else max(1, min(int(bm), m))
    out_dtype = out_dtype or lhs.dtype
    bias_rows = []
    bi = 0
    for st in stages:
        if st.has_bias:
            b = torch.as_tensor(biases[bi], device=lhs.device)
            bi += 1
            if tuple(b.shape) != (st.n,):
                raise ValueError(f"bias for a (*, {st.n}) stage must be "
                                 f"rank-1 of length {st.n}, got "
                                 f"{tuple(b.shape)}")
            bias_rows.append(b.to(torch.float32).contiguous())
    if _on_cpu(lhs, *rhss, *bias_rows):
        return chain_reference(lhs, *rhss, *bias_rows, stages=stages,
                               out_dtype=out_dtype)
    _no_backward("the fused chain kernel", LATER_TRAINING, lhs, *rhss,
                 *bias_rows)
    _check_cuda_dtype(lhs.dtype, "chain operands")
    if out_dtype != lhs.dtype or any(r.dtype != lhs.dtype for r in rhss):
        raise ValueError(f"the fused chain kernel takes rhs operands and "
                         f"writes its output in the lhs dtype {lhs.dtype}")
    out = torch.empty((m, stages[-1].n), dtype=out_dtype, device=lhs.device)
    ys = _scratch([(m, st.n) for st in stages[:-1]], lhs.dtype,
                  lhs.device) + [out]
    plan = card_plan(chain_as_dag(stages, m), lhs.dtype, lhs.device)
    rows, bi = [], 0
    x = lhs
    for j, st in enumerate(stages):
        b = None
        if st.has_bias:
            b, bi = bias_rows[bi], bi + 1
        rows.append(_stage_row("dot", m, st.k, st.n, x, rhss[j], None, b,
                               ys[j], None, plan.stages[j], st.epilogue))
        x = ys[j]
    _launch("fused_chain_launch", lhs.dtype, rows, plan, lhs.device,
            int(interleave == "stage"))
    launches["fused_chain"] += 1
    return out


def fused_dag(exts: Sequence[torch.Tensor], *,
              stages: Sequence[DagStage],
              out_dtype=None) -> Tuple[torch.Tensor, ...]:
    """Run a fused DAG group as one kernel launch.

    ``exts`` are the external operands in *kernel-facing* layout (the
    caller applies role casts: a landed external rhs is ``(k, n)`` — any
    strides —, residual streams fp32, bias rows ``(1, n)`` fp32).
    Returns ``(result, *taps)`` — the final stage's output followed by
    the tapped intermediates in tap-slot order.
    """
    stages = validate_dag(stages)
    exts = tuple(exts)
    out_dtype = out_dtype or exts[0].dtype
    if _on_cpu(*exts):
        return dag_reference(exts, stages=stages, out_dtype=out_dtype)
    _no_backward("the fused DAG kernel", LATER_TRAINING, *exts)
    _check_cuda_dtype(out_dtype, "chain dtype")
    dev = exts[0].device
    last = stages[-1]
    out = torch.empty((last.m, last.n), dtype=out_dtype, device=dev)
    ys = _scratch([(st.m, st.n) for st in stages[:-1]], out_dtype,
                  dev) + [out]
    taps = {st.tap: torch.empty((st.m, st.n), dtype=out_dtype, device=dev)
            for st in stages if st.tap >= 0}
    plan = card_plan(stages, out_dtype, dev)
    rows = []

    def fetch(src, transpose=False):
        where, idx = src
        buf = exts[idx] if where == "ext" else ys[idx]
        return buf.T if transpose else buf

    for j, st in enumerate(stages):
        lhs = fetch(st.lhs)
        rhs = fetch(st.rhs, transpose=st.kind == "dot"
                    and st.rhs[0] == "scr")
        want_lhs = ((st.m, st.k, st.n) if st.kind == "batched"
                    else (st.m, st.k))
        want_rhs = (st.m, st.k) if st.kind == "batched" else (st.k, st.n)
        if tuple(lhs.shape) != want_lhs or tuple(rhs.shape) != want_rhs:
            raise ValueError(f"stage {j}: operands {tuple(lhs.shape)} x "
                             f"{tuple(rhs.shape)} do not match "
                             f"{want_lhs} x {want_rhs}")
        if lhs.dtype != out_dtype or rhs.dtype != out_dtype:
            raise ValueError(f"stage {j}: lhs/rhs must be in the chain "
                             f"dtype {out_dtype}")
        res = None if st.res is None else fetch(st.res)
        if res is not None and res.dtype not in (torch.float32, out_dtype):
            raise ValueError(f"stage {j}: a residual streams in float32 or "
                             f"the chain dtype, got {res.dtype}")
        bias = None
        if st.has_bias:
            bias = exts[st.bias]
            if bias.dtype != torch.float32 or not bias.is_contiguous():
                raise ValueError(f"stage {j}: the bias row must be a "
                                 f"contiguous float32 tensor")
        rows.append(_stage_row(st.kind, st.m, st.k, st.n, lhs, rhs, res,
                               bias, ys[j], taps.get(st.tap),
                               plan.stages[j], st.epilogue))
    _launch("fused_dag_launch", out_dtype, rows, plan, dev)
    launches["fused_dag"] += 1
    return (out,) + tuple(taps[i] for i in sorted(taps))
