"""Generic CommPlan interpreter: any generated CommPlan -> a mesh program
over ``torch.distributed`` ranks.

The port of the reference's ``dist/comm_engine.py``.  ``compile_comm_plan``
takes the CommPlan that ``plan.comm_plan_for`` generated from the dataflow
classification plus the algebra's :class:`~repro_torch.compile.LoweredForm`,
and returns a :class:`MeshProgram` over a 2-D ``DeviceMesh`` — the
chip-level realization of the paper's claim that one transformation matrix
yields the complete accelerator, module selection *and connection*.

Every placement, motion and degradation comes from ``plan.solve_partition``
(the :class:`~repro_torch.core.plan.PartitionSolution`); this module only
materializes it, path for path as the reference does:

    * stored layouts        -> one :class:`Spec` per side,
    * ``all_gather`` motion -> ``dist.all_gather`` over the axis's group,
    * ``ppermute_ring``     -> one ``batch_isend_irecv`` per rotation step,
    * ``psum`` reductions   -> ``dist.all_reduce`` over each k axis,
    * compressed sides      -> per-rank BSR payload + block-COO coordinate
      lists shipped through the same gathers/rings (never densified),
    * input-systolic dt     -> the staggered accumulate-rotate schedule
      (``k_spatial_stagger``): rank r adds its partial for output chunk
      ``(r - t) mod S`` at step t and forwards it, so the mobile tensor
      stores 1/S per rank instead of a full replica.

One process is one mesh position (the counterpart of one ``shard_map``
device).  Every rank of the mesh calls the program with the same global
``(lhs, rhs)``, as ``shard_map`` takes global arrays; each rank pads the
operands with the reference's multiples, slices out its own shard from its
mesh coordinate and its side's spec, runs the body, and rebuilds the
global output by gathering the output shards over the axes ``out_spec``
names (along the others it is already replicated).  Ranks outside the
mesh must not call it.

Transport follows the group's backend (``dist.get_backend``): NCCL moves
device tensors; gloo moves host copies (several ranks may share one card
that way).  Compute stays on the rank's device either way.  The per-shard
products run in fp32 (``kernels.ref.matmul_ref``: bf16 shards upcast
first, TF32 off), as the reference's ``preferred_element_type=float32``
einsums, and cast to the kernel dtype at the end.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core import plan as plan_mod
from ..core.plan import CommPlan, PartitionSolution, TensorPartition
from ..kernels.ref import matmul_ref


class Spec(tuple):
    """A side's stored layout: one entry per array dim — ``None`` (whole),
    a mesh axis, or a tuple of axes (major to minor: ``("x", "y")`` is
    shard ``i * |y| + j``).  Prints as ``jax.sharding.PartitionSpec``
    does, so ``describe()`` reads as the reference's."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)

    __str__ = __repr__


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _pad_dim(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    """Pad ``axis`` (negative axes address from the last dim) with zeros
    up to a multiple of ``mult``."""
    axis %= x.ndim
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    # F.pad lists (left, right) pairs from the last dim backwards
    return F.pad(x, [0, 0] * (x.ndim - 1 - axis) + [0, pad])


def _skew(m: torch.Tensor, s: int, roll_axis: int, block_axis: int
          ) -> torch.Tensor:
    """Cannon's initial alignment: roll block row/col ``i`` of ``m`` by
    ``i`` k-blocks along ``roll_axis``."""
    kb = m.shape[roll_axis] // s
    blocks = torch.split(m, m.shape[block_axis] // s, dim=block_axis)
    rolled = [torch.roll(blk, -i * kb, dims=roll_axis)
              for i, blk in enumerate(blocks)]
    return torch.cat(rolled, dim=block_axis)


def _contract(l: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """out[..., m, n] = l[..., m, k] @ r[..., k, n] in fp32, broadcasting
    a leading batch dim carried by either operand."""
    return matmul_ref(l, r, torch.float32)


def _acc_init(l: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """fp32 accumulator matching ``_contract(l, r)``'s shape."""
    bshape = torch.broadcast_shapes(l.shape[:-2], r.shape[:-2])
    return torch.zeros((*bshape, l.shape[-2], r.shape[-1]),
                       dtype=torch.float32, device=l.device)


def _ring_perm(size: int) -> list:
    """Rotate data one hop backwards: position r receives block r+1."""
    return [(j, (j - 1) % size) for j in range(size)]


def _fwd_perm(size: int) -> list:
    """Rotate data one hop forwards: position r sends to r+1 (the
    staggered accumulator schedule's direction)."""
    return [(j, (j + 1) % size) for j in range(size)]


def _spec_of(tp: TensorPartition) -> Spec:
    """The stored layout of one side."""
    return Spec(*tp.placement)


#: the backend a ``fake`` default group stands for, innermost last
#: (``launch.mesh.fake_world`` pushes it): the collectives take its path
FAKE_BACKEND: list = []


def fake_world() -> bool:
    """Whether the default group is PyTorch's ``fake`` one: collectives
    move nothing and a rank's tensors are ``meta``."""
    return dist.is_initialized() and dist.get_backend() == "fake"


def mesh_device(mesh) -> torch.device:
    """The device this rank computes on for ``mesh``: ``meta`` in a fake
    world."""
    if fake_world():
        return torch.device("meta")
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


# ---------------------------------------------------------------------------
# This rank's view of the mesh: coordinate, axis groups, collectives
# ---------------------------------------------------------------------------

class RankMesh:
    """One rank's position on a 2-D ``DeviceMesh`` and the collectives
    the interpreter runs along its axes (the counterparts of
    ``jax.lax.all_gather`` / ``psum`` / ``ppermute`` / ``axis_index``)."""

    def __init__(self, mesh):
        self.axes: Tuple[str, ...] = tuple(mesh.mesh_dim_names)
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError(
                f"rank {dist.get_rank()} is not a position of this mesh: "
                "only the mesh's own ranks run its program")
        self.coord = dict(zip(self.axes, coord))
        self.sizes = dict(zip(self.axes, tuple(mesh.shape)))
        self.device = mesh_device(mesh)
        self.groups = {a: mesh.get_group(a) for a in self.axes}
        grid = mesh.mesh
        self.ranks: Dict[str, list] = {}
        for d, a in enumerate(self.axes):
            ranks = dist.get_process_group_ranks(self.groups[a])
            idx = [slice(None) if e == d else coord[e]
                   for e in range(len(self.axes))]
            line = grid[tuple(idx)].tolist()
            if ranks != line:
                # the gathers concatenate in group-rank order, which must
                # be the mesh coordinate's order
                raise ValueError(f"mesh axis {a!r}: group ranks {ranks} are "
                                 f"not in coordinate order {line}")
            self.ranks[a] = ranks
        have = {a: dist.get_backend(g) for a, g in self.groups.items()}
        #: each axis's collective path: its group's backend, or the one a
        #: fake group stands for
        self.backend = {a: (FAKE_BACKEND[-1] if FAKE_BACKEND else "nccl")
                        if b == "fake" else b for a, b in have.items()}
        #: gloo stages through host memory; NCCL moves device tensors and
        #: a fake group moves nothing
        self.host = {a: b == "gloo" for a, b in have.items()}

    def axis_index(self, axis: str) -> int:
        return self.coord[axis]

    def _wire(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        x = x.contiguous()
        return x.cpu() if self.host[axis] else x

    def all_gather(self, x: torch.Tensor, axis: str, dim: int
                   ) -> torch.Tensor:
        """Concatenate the shards of ``x`` along ``dim`` over ``axis`` in
        coordinate order (``all_gather(..., tiled=True)``)."""
        w = self._wire(x, axis)
        parts = [torch.empty_like(w) for _ in range(self.sizes[axis])]
        dist.all_gather(parts, w, group=self.groups[axis])
        return torch.cat(parts, dim=dim).to(self.device)

    def psum(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """Sum ``x`` over every rank of ``axes`` (one all_reduce an
        axis)."""
        for a in axes:
            w = self._wire(x, a)
            if w is x:
                w = w.clone()
            dist.all_reduce(w, group=self.groups[a])
            x = w.to(self.device)
        return x

    def ppermute(self, x: torch.Tensor, axis: str, perm: list
                 ) -> torch.Tensor:
        """Send ``x`` to ``perm``'s destination along ``axis`` and receive
        from its source, in one ``batch_isend_irecv`` (a ring of one
        position is a no-op)."""
        if self.sizes[axis] == 1:
            return x
        me = self.coord[axis]
        dst = next(d for s, d in perm if s == me)
        src = next(s for s, d in perm if d == me)
        w = self._wire(x, axis)
        buf = torch.empty_like(w)
        g, ranks = self.groups[axis], self.ranks[axis]
        ops = [dist.P2POp(dist.isend, w, ranks[dst], g),
               dist.P2POp(dist.irecv, buf, ranks[src], g)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return buf.to(self.device)

    def reduce_scatter(self, x: torch.Tensor, axis: str, dim: int
                       ) -> torch.Tensor:
        """Sum ``x`` over ``axis`` and keep this rank's block along
        ``dim``: ``dist.reduce_scatter_tensor`` on an NCCL axis, one
        all_reduce and the rank's slice on a gloo one (gloo's
        reduce-scatter differs across PyTorch releases)."""
        n, idx = self.sizes[axis], self.coord[axis]
        if n == 1:
            return x
        if self.backend[axis] == "gloo":
            step = x.shape[dim] // n
            return self.psum(x, (axis,)).narrow(dim, idx * step,
                                                step).contiguous()
        src = x.movedim(dim, 0).contiguous()
        out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        dist.reduce_scatter_tensor(out, src, group=self.groups[axis])
        return out.movedim(0, dim).contiguous()

    # -- shards -----------------------------------------------------------
    def shard_of(self, entry) -> Tuple[int, int]:
        """(index, count) of this rank's shard for one spec entry."""
        idx, count = 0, 1
        for a in _axes_of(entry):
            idx = idx * self.sizes[a] + self.coord[a]
            count *= self.sizes[a]
        return idx, count

    def local(self, x: torch.Tensor, spec: Spec) -> torch.Tensor:
        """This rank's block of the global (padded) ``x``."""
        for d, entry in enumerate(spec):
            idx, count = self.shard_of(entry)
            if count > 1:
                if x.shape[d] % count:
                    raise ValueError(f"dim {d} of extent {x.shape[d]} does "
                                     f"not split {count} ways")
                step = x.shape[d] // count
                x = x.narrow(d, idx * step, step)
        return x

    def gather_global(self, x: torch.Tensor, spec: Spec) -> torch.Tensor:
        """The global array from every rank's block: gather each dim over
        the axes its spec entry names, minor axis first."""
        for d, entry in enumerate(spec):
            for a in reversed(_axes_of(entry)):
                x = self.all_gather(x, a, dim=d)
        return x


# ---------------------------------------------------------------------------
# The compiled program
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshProgram:
    """A compiled CommPlan: the specs + ring structure chosen for one
    (CommPlan, LoweredForm, mesh) triple.  ``fn`` maps *global*
    (lhs2d, rhs2d) -> global out on every rank of the mesh; ``solution``
    is the partition the program materializes."""

    strategy: str                       # summa | cannon | ring | k_spatial...
    in_specs: Tuple[Spec, Spec]
    out_spec: Spec
    ring_axes: Tuple[str, ...]
    pads: Tuple[int, int, int]          # padding multiples for (m, n, k)
    solution: PartitionSolution = None
    fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = (
        dataclasses.field(repr=False, default=None))

    def __call__(self, lhs: torch.Tensor, rhs: torch.Tensor
                 ) -> torch.Tensor:
        return self.fn(lhs, rhs)

    def footprint(self, form, elem_bytes: int = 4) -> Dict[str, float]:
        """Per-device stored bytes per side (the solver's accounting)."""
        return self.solution.per_device_bytes(form, elem_bytes)


def _check_mesh(mesh, device) -> None:
    names = mesh.mesh_dim_names
    if mesh.ndim != 2 or names is None:
        raise ValueError(f"comm_engine needs a 2-D mesh, got axes {names}")
    if device is not None and torch.device(device).type != mesh.device_type:
        raise ValueError(
            f"the mesh's devices are {mesh.device_type!r} but the kernel "
            f"runs on {torch.device(device).type!r}")


def compile_comm_plan(comm: CommPlan, form, mesh,
                      dtype: torch.dtype = torch.float32, *,
                      shard_batch: bool = True, sparse: str = "auto",
                      device=None) -> MeshProgram:
    """Compile a generated CommPlan into an executable mesh program.

    The returned program computes ``out[b?, m, n] = lhs @ rhs`` (the
    algebra's LoweredForm view) with every inter-rank transfer prescribed
    by the :class:`~repro_torch.core.plan.PartitionSolution` the plan
    solves to: batch grid dims shard a mesh axis, structured block-sparse
    operands ship compressed, and systolic plans run their rotation
    schedules.

    ``shard_batch=False`` requests the replicating-batch baseline and
    ``sparse="dense"`` the masked-dense shipping baseline (both kept for
    footprint A/B comparisons); ``sparse="auto"``/``"bsr"`` ship the
    structured operand compressed whenever the form has one.  ``device``
    (the kernel's) must be of the mesh's device type.  Must be called on
    a rank of ``mesh``.
    """
    _check_mesh(mesh, device)
    if sparse not in ("auto", "bsr", "dense"):
        raise ValueError(f"sparse must be 'auto', 'bsr' or 'dense', "
                         f"got {sparse!r}")
    compressed = None if sparse == "auto" else (sparse == "bsr")
    sol = plan_mod.solve_partition(
        comm, form, axes=tuple(mesh.mesh_dim_names),
        shape=tuple(mesh.shape), shard_batch=shard_batch,
        compressed=compressed)
    if sparse == "bsr" and not (sol.lhs.compressed or sol.rhs.compressed):
        raise ValueError(
            "sparse='bsr' requested but the solved partition ships no "
            "compressed side (no structured 2-D sparse operand); use "
            "sparse='auto' or 'dense'")
    rm = RankMesh(mesh)
    if sol.strategy in ("summa", "cannon", "ring_hybrid",
                        "multicast_hybrid", "local"):
        return _build_out_stationary(sol, form, rm, dtype)
    return _build_k_spatial(sol, form, rm, dtype)


# ---------------------------------------------------------------------------
# Compressed-operand shipping: per-device BSR payload + coordinate lists
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Compressed:
    """Static partition of a structured sparse side.

    The dense prepared operand is decomposed into its pattern's blocks and
    each device's nonzero blocks are collected as (payload, stat-coord,
    k-coord) triples — the stationary-dim coordinate is local to the
    device's shard, the contraction-dim coordinate is in ``k_frame``
    ("global": the frame of a full-k dense side at contract time, i.e.
    gathered/resident; "local": the frame of a k-spatial shard).  Payload
    rows are padded per device to the max nnz (``n_max``); padded entries
    are zeroed so they contribute nothing downstream.
    """

    side: str                       # lhs | rhs
    block: Tuple[int, int]
    d0_pad: int                     # padded operand dims
    d1_pad: int
    n_max: int
    flat_ids: np.ndarray            # (s0, s1, n_max) block ids, padded w/ 0
    stat_c: np.ndarray              # (s0, s1, n_max) local stationary coords
    k_c: np.ndarray                 # (s0, s1, n_max) contraction coords
    valid: np.ndarray               # (s0, s1, n_max) bool
    counts: np.ndarray              # (s0, s1) nnz per device

    @property
    def grid_pad(self) -> Tuple[int, int]:
        return (self.d0_pad // self.block[0], self.d1_pad // self.block[1])


def _splits(ax, sizes: Dict[str, int]) -> int:
    return plan_mod._axis_factor(ax, sizes)


def _compress_partition(form, sol: PartitionSolution, k_frame: str,
                        k_extra: int = 1) -> _Compressed:
    """Partition the pattern's block-COO list per device (numpy, static;
    the reference's, line for line).

    ``k_extra`` is the dense side's contraction-dim split factor: the
    padded k extent must be divisible by it too, so the gathered /
    resident dense side and the payload's k-coordinate frame agree."""
    osp = form.sparse
    tp = sol.lhs if osp.side == "lhs" else sol.rhs
    axes, (s0, s1) = sol.axes, sol.shape
    sizes = sol.sizes
    b0, b1 = osp.block
    if osp.side == "lhs":
        stat_dim, k_dim = "m", "k"
        d0_ext, d1_ext = form.m, form.k
        stat_pos = 0                       # rows are the stationary dim
    else:
        stat_dim, k_dim = "n", "k"
        d0_ext, d1_ext = form.k, form.n
        stat_pos = 1                       # cols are the stationary dim
    stat_ax = tp.axis_of.get(stat_dim)
    k_ax = tp.axis_of.get(k_dim)
    f_stat = _splits(stat_ax, sizes)
    f_k = _splits(k_ax, sizes)

    # pad operand dims so every shard is a whole number of blocks (and the
    # contraction dim also divides the dense side's split)
    def padded(ext, blk, splits, extra=1):
        step = math.lcm(blk * splits, extra)
        return step * math.ceil(ext / step)

    if stat_pos == 0:
        d0_pad = padded(d0_ext, b0, f_stat)
        d1_pad = padded(d1_ext, b1, f_k, k_extra)
        g_stat, g_k = d0_pad // b0, d1_pad // b1
    else:
        d0_pad = padded(d0_ext, b0, f_k, k_extra)
        d1_pad = padded(d1_ext, b1, f_stat)
        g_k, g_stat = d0_pad // b0, d1_pad // b1
    g1 = d1_pad // b1
    stat_per, k_per = g_stat // f_stat, g_k // f_k

    def shard_of(ax, i, j):
        if ax is None:
            return 0
        if isinstance(ax, tuple):
            coords = {axes[0]: i, axes[1]: j}
            idx = 0
            for a in ax:
                idx = idx * sizes[a] + coords[a]
            return idx
        return i if ax == axes[0] else j

    per_dev = [[[] for _ in range(s1)] for _ in range(s0)]
    for (r, c) in osp.coords:
        stat_id, k_id = (r, c) if stat_pos == 0 else (c, r)
        si, ki = stat_id // stat_per, k_id // k_per
        for i in range(s0):
            for j in range(s1):
                if shard_of(stat_ax, i, j) != si and stat_ax is not None:
                    continue
                if shard_of(k_ax, i, j) != ki and k_ax is not None:
                    continue
                stat_local = (stat_id - (si if stat_ax is not None else 0)
                              * stat_per)
                k_out = (k_id if k_frame == "global" else
                         k_id - (ki if k_ax is not None else 0) * k_per)
                per_dev[i][j].append((r * g1 + c, stat_local, k_out))

    counts = np.array([[len(per_dev[i][j]) for j in range(s1)]
                       for i in range(s0)], np.int32)
    n_max = max(1, int(counts.max()))
    flat_ids = np.zeros((s0, s1, n_max), np.int64)
    stat_c = np.zeros((s0, s1, n_max), np.int64)
    k_c = np.zeros((s0, s1, n_max), np.int64)
    valid = np.zeros((s0, s1, n_max), bool)
    for i in range(s0):
        for j in range(s1):
            for t, (fid, sc, kc) in enumerate(per_dev[i][j]):
                flat_ids[i, j, t] = fid
                stat_c[i, j, t] = sc
                k_c[i, j, t] = kc
                valid[i, j, t] = True
    return _Compressed(osp.side, (b0, b1), d0_pad, d1_pad, n_max,
                       flat_ids, stat_c, k_c, valid, counts)


@dataclasses.dataclass(frozen=True)
class _Triple:
    """This rank's static coordinate lists and payload selection."""

    ids: torch.Tensor               # (n_max,) block ids
    valid: torch.Tensor             # (n_max, 1, 1) bool
    sc: torch.Tensor                # (n_max,) stationary coords
    kc: torch.Tensor                # (n_max,) contraction coords


def _rank_triple(comp: _Compressed, rm: RankMesh, axes) -> _Triple:
    i, j = rm.coord[axes[0]], rm.coord[axes[1]]

    def t(a):
        return torch.as_tensor(a[i, j], device=rm.device)

    return _Triple(t(comp.flat_ids), t(comp.valid)[:, None, None],
                   t(comp.stat_c), t(comp.k_c))


def _pack_payload(dense2d: torch.Tensor, comp: _Compressed, tri: _Triple
                  ) -> torch.Tensor:
    """This rank's blocks of the padded dense operand, zeroed on padded
    entries: (n_max, b0, b1)."""
    b0, b1 = comp.block
    g0, g1 = comp.grid_pad
    x = _pad_dim(_pad_dim(dense2d, -2, comp.d0_pad), -1, comp.d1_pad)
    x = x[:comp.d0_pad, :comp.d1_pad]
    flat = x.reshape(g0, b0, g1, b1).transpose(1, 2).reshape(g0 * g1, b0, b1)
    pay = flat[tri.ids]
    return torch.where(tri.valid, pay,
                       torch.zeros((), dtype=pay.dtype, device=pay.device))


def _segment_sum(parts: torch.Tensor, seg: torch.Tensor, n_seg: int
                 ) -> torch.Tensor:
    """``segment_sum`` in a fixed order: a one-hot (n_seg, N) product
    (no atomics, so a second call gives the same bits)."""
    onehot = (seg[None, :] == torch.arange(n_seg, device=seg.device)[:, None]
              ).to(torch.float32)
    flat = parts.reshape(parts.shape[0], -1)
    return matmul_ref(onehot, flat, torch.float32).reshape(
        n_seg, *parts.shape[1:])


def _bsr_contract(pay: torch.Tensor, stat_c: torch.Tensor,
                  k_c: torch.Tensor, dense: torch.Tensor, side: str,
                  stat_blocks: int, b_stat: int, b_k: int) -> torch.Tensor:
    """One compressed contraction: nonzero blocks against a dense side.

    ``side == 'lhs'``: pay (N, bm, bk) x dense (K, n) -> (stat_blocks*bm, n)
    ``side == 'rhs'``: dense (m, K) x pay (N, bk, bn) -> (m, stat_blocks*bn)

    ``dense``'s contraction extent K must be in the same frame as ``k_c``
    (full-k at contract time for gathered/resident sides, the local shard
    for k-spatial).  Padded payload entries are zero, so their (0, 0)
    coordinates contribute nothing.
    """
    if side == "lhs":
        n = dense.shape[-1]
        rb = dense.reshape(-1, b_k, n)[k_c]                # (N, bk, n)
        parts = matmul_ref(pay, rb, torch.float32)         # (N, bm, n)
        out = _segment_sum(parts, stat_c, stat_blocks)
        return out.reshape(stat_blocks * b_stat, n)
    m = dense.shape[-2]
    lb = dense.reshape(m, -1, b_k)[:, k_c].transpose(0, 1)  # (N, m, bk)
    parts = matmul_ref(lb, pay, torch.float32)              # (N, m, bn)
    out = _segment_sum(parts, stat_c, stat_blocks)
    return out.transpose(0, 1).reshape(m, stat_blocks * b_stat)


# ---------------------------------------------------------------------------
# Strategy family 1: output blocks stationary (shard / stream output)
# ---------------------------------------------------------------------------

def _build_out_stationary(sol: PartitionSolution, form, rm: RankMesh,
                          dtype) -> MeshProgram:
    """Output (b?, m, n) blocks resident on their rank; the contraction is
    delivered by the motions the solver assigned: gathers (multicast
    wires), rings (systolic wires), or local full-k residency."""
    sizes = sol.sizes
    s0, s1 = sol.shape
    lhs_tp, rhs_tp, out_tp = sol.lhs, sol.rhs, sol.out
    double_ring = sol.strategy == "cannon"
    lhs_ring = lhs_tp.motion == "ppermute_ring"
    rhs_ring = rhs_tp.motion == "ppermute_ring"
    S = s1 if lhs_ring else (s0 if rhs_ring else 1)

    comp = None
    if lhs_tp.compressed or rhs_tp.compressed:
        dn_tp = rhs_tp if lhs_tp.compressed else lhs_tp
        comp = _compress_partition(
            form, sol, k_frame="global",
            k_extra=plan_mod._axis_factor(dn_tp.axis_of.get("k"), sizes))

    in_specs = (_spec_of(lhs_tp), _spec_of(rhs_tp))
    out_spec = _spec_of(out_tp)
    kmult = math.lcm(
        s1 if lhs_tp.axis_of.get("k") else 1,
        s0 if rhs_tp.axis_of.get("k") else 1, max(S, 1))
    f_b = plan_mod._axis_factor(sol.batch_axis, sizes)
    f_m = plan_mod._axis_factor(sol.grid.get("m"), sizes)
    f_n = plan_mod._axis_factor(sol.grid.get("n"), sizes)

    if comp is None:
        fn = _dense_out_stationary_fn(
            sol, form, rm, dtype, in_specs, out_spec, kmult,
            f_b, f_m, f_n, S, double_ring)
    else:
        fn = _compressed_out_stationary_fn(
            sol, form, rm, dtype, comp, out_spec, f_m, f_n, S)
    return MeshProgram(sol.strategy, in_specs, out_spec, sol.ring_axes,
                       (f_m, f_n, kmult), sol, fn)


def _dense_out_stationary_fn(sol, form, rm, dtype, in_specs, out_spec,
                             kmult, f_b, f_m, f_n, S, double_ring):
    ax0, ax1 = sol.axes
    s0, s1 = sol.shape
    lhs_tp, rhs_tp = sol.lhs, sol.rhs
    lhs_ring = lhs_tp.motion == "ppermute_ring"
    rhs_ring = rhs_tp.motion == "ppermute_ring"
    lhs_gather = lhs_tp.motion == "all_gather"
    rhs_gather = rhs_tp.motion == "all_gather"

    def body(l, r):
        if lhs_gather:
            l = rm.all_gather(l, ax1, dim=l.ndim - 1)
        if rhs_gather:
            r = rm.all_gather(r, ax0, dim=r.ndim - 2)
        if not (lhs_ring or rhs_ring):
            return _contract(l, r).to(dtype)

        acc = _acc_init(l, r)
        if double_ring:
            left, up = _ring_perm(s1), _ring_perm(s0)
            for t in range(S):
                acc += _contract(l, r)
                if t + 1 < S:          # the last rotation feeds nothing
                    l = rm.ppermute(l, ax1, left)
                    r = rm.ppermute(r, ax0, up)
            return acc.to(dtype)

        # single ring: one side circulates its k-blocks; the other side
        # holds full k (gathered or resident) and slices the block that is
        # currently aligned with the ring position.
        ax_ring = ax1 if lhs_ring else ax0
        perm = _ring_perm(S)
        pos = rm.axis_index(ax_ring)
        mov = l if lhs_ring else r
        kb = mov.shape[-1] if lhs_ring else mov.shape[-2]
        for t in range(S):
            idx = ((pos + t) % S) * kb
            if lhs_ring:
                acc += _contract(mov, r.narrow(r.ndim - 2, idx, kb))
            else:
                acc += _contract(l.narrow(l.ndim - 1, idx, kb), mov)
            if t + 1 < S:
                mov = rm.ppermute(mov, ax_ring, perm)
        return acc.to(dtype)

    batched = bool(form.batch)

    def run(lhs, rhs):
        b, m, n = form.batch_size, lhs.shape[-2], rhs.shape[-1]
        lhs = _pad_dim(_pad_dim(lhs, -2, f_m), -1, kmult)
        rhs = _pad_dim(_pad_dim(rhs, -1, f_n), -2, kmult)
        if batched:
            if form.lhs_batched:
                lhs = _pad_dim(lhs, -3, f_b)
            if form.rhs_batched:
                rhs = _pad_dim(rhs, -3, f_b)
        if double_ring:
            lhs = _skew(lhs, s0, roll_axis=-1, block_axis=-2)
            rhs = _skew(rhs, s1, roll_axis=-2, block_axis=-1)
        out = body(rm.local(lhs, in_specs[0]), rm.local(rhs, in_specs[1]))
        out = rm.gather_global(out, out_spec)[..., :m, :n]
        return out[:b] if batched else out

    return run


def _compressed_out_stationary_fn(sol, form, rm, dtype, comp, out_spec,
                                  f_m, f_n, S):
    """The sparse side ships as (payload, stat-coords, k-coords) through
    the motion the solver assigned (gather or single ring — the solver
    never emits a compressed double ring); the dense side moves exactly as
    in the dense program and is full-k at contract time, so the global
    k-coordinates the payload carries need no realignment."""
    ax0, ax1 = sol.axes
    sp_side = comp.side
    sp_tp = sol.lhs if sp_side == "lhs" else sol.rhs
    dn_tp = sol.rhs if sp_side == "lhs" else sol.lhs
    dn_gather = dn_tp.motion == "all_gather"
    sp_gather = sp_tp.motion == "all_gather"
    sp_ring = sp_tp.motion == "ppermute_ring"
    b0, b1 = comp.block
    b_stat, b_k = (b0, b1) if sp_side == "lhs" else (b1, b0)
    stat_ax = sp_tp.axis_of.get("m" if sp_side == "lhs" else "n")
    f_stat = plan_mod._axis_factor(stat_ax, sol.sizes)
    stat_blocks = ((comp.d0_pad if sp_side == "lhs" else comp.d1_pad)
                   // (b_stat * f_stat))
    # the sparse side's motion axis (k split) and the dense side's
    dn_ax = ax0 if sp_side == "lhs" else ax1
    sp_ax = ax1 if sp_side == "lhs" else ax0
    dense_spec = _spec_of(dn_tp)
    tri = _rank_triple(comp, rm, sol.axes)

    def body(pay, sc, kc, dense):
        if dn_gather:
            dim = dense.ndim - 2 if sp_side == "lhs" else dense.ndim - 1
            dense = rm.all_gather(dense, dn_ax, dim=dim)
        if sp_gather:
            pay = rm.all_gather(pay, sp_ax, dim=0)
            sc = rm.all_gather(sc, sp_ax, dim=0)
            kc = rm.all_gather(kc, sp_ax, dim=0)
        if not sp_ring:
            return _bsr_contract(pay, sc, kc, dense, sp_side,
                                 stat_blocks, b_stat, b_k).to(dtype)

        perm = _ring_perm(S)
        if sp_side == "lhs":
            shape = (stat_blocks * b_stat, dense.shape[-1])
        else:
            shape = (dense.shape[-2], stat_blocks * b_stat)
        acc = torch.zeros(shape, dtype=torch.float32, device=dense.device)
        for t in range(S):
            acc += _bsr_contract(pay, sc, kc, dense, sp_side,
                                 stat_blocks, b_stat, b_k)
            if t + 1 < S:
                pay = rm.ppermute(pay, sp_ax, perm)
                sc = rm.ppermute(sc, sp_ax, perm)
                kc = rm.ppermute(kc, sp_ax, perm)
        return acc.to(dtype)

    def run(lhs, rhs):
        m, n = lhs.shape[-2], rhs.shape[-1]
        sp2d, dn2d = (lhs, rhs) if sp_side == "lhs" else (rhs, lhs)
        pay = _pack_payload(sp2d, comp, tri)
        if sp_side == "lhs":
            dn2d = _pad_dim(_pad_dim(dn2d, -1, f_n), -2, comp.d1_pad)
            dn2d = dn2d[:comp.d1_pad]
        else:
            dn2d = _pad_dim(_pad_dim(dn2d, -2, f_m), -1, comp.d0_pad)
            dn2d = dn2d[:, :comp.d0_pad]
        out = body(pay, tri.sc, tri.kc, rm.local(dn2d, dense_spec))
        return rm.gather_global(out, out_spec)[..., :m, :n]

    return run


# ---------------------------------------------------------------------------
# Strategy family 2: contraction spatial over mesh axes (psum / staggered
# output ring / broadcast-reduction outputs)
# ---------------------------------------------------------------------------

def _build_k_spatial(sol: PartitionSolution, form, rm: RankMesh,
                     dtype) -> MeshProgram:
    """The contraction dim is sharded over ``sol.k_axes``; each rank
    computes a partial product and the reduction runs over those axes —
    one ``psum`` (reduction-class outputs) or the staggered
    accumulate-rotate ppermute schedule (systolic-class outputs, the
    executed dt: the output is the mobile tensor and stores 1/S per
    rank)."""
    sizes = sol.sizes
    k_axes = sol.k_axes
    lhs_tp, rhs_tp, out_tp = sol.lhs, sol.rhs, sol.out
    kmult = math.prod(sizes[a] for a in k_axes)
    f_b = plan_mod._axis_factor(sol.batch_axis, sizes)
    f_m = plan_mod._axis_factor(sol.grid.get("m"), sizes)
    f_n = plan_mod._axis_factor(sol.grid.get("n"), sizes)
    S = sizes[k_axes[0]] if sol.stagger else 0

    comp = None
    if lhs_tp.compressed or rhs_tp.compressed:
        comp = _compress_partition(form, sol, k_frame="local",
                                   k_extra=kmult)

    in_specs = (_spec_of(lhs_tp), _spec_of(rhs_tp))
    out_spec = _spec_of(out_tp)
    ring_ax = k_axes[0] if sol.stagger else None

    def reduce_partial(part):
        """Partial (b?, m_pad, n_loc) fp32 -> reduced output block: one
        psum over the k axes, or — for systolic-class outputs — the
        staggered accumulate-rotate schedule (the executed dt): at step t
        rank r adds its k-shard's partial for output chunk
        ``(r - t) mod S`` to the chunk passing by and forwards it, so
        after S rotations chunk r has visited every k-shard and lands on
        rank r — the mobile tensor stores 1/S per rank instead of a full
        replica."""
        if not sol.stagger:
            return rm.psum(part, k_axes)
        pos = rm.axis_index(ring_ax)
        chunk = part.shape[-2] // S
        perm = _fwd_perm(S)
        acc = torch.zeros((*part.shape[:-2], chunk, part.shape[-1]),
                          dtype=torch.float32, device=part.device)
        for t in range(S):
            c = (pos - t) % S
            pc = part.narrow(part.ndim - 2, c * chunk, chunk)
            acc = rm.ppermute(acc + pc, ring_ax, perm)
        return acc

    m_mult = S if sol.stagger else f_m
    if comp is not None:
        fn = _compressed_k_spatial_fn(sol, rm, dtype, comp, out_spec, f_m,
                                      f_n, m_mult, reduce_partial)
    else:
        fn = _dense_k_spatial_fn(form, rm, dtype, in_specs, out_spec,
                                 kmult, f_b, f_n, m_mult, reduce_partial)
    return MeshProgram(sol.strategy, in_specs, out_spec,
                       sol.ring_axes, (f_m, f_n, kmult), sol, fn)


def _dense_k_spatial_fn(form, rm, dtype, in_specs, out_spec, kmult, f_b,
                        f_n, m_mult, reduce_partial):
    batched = bool(form.batch)

    def run(lhs, rhs):
        b, m, n = form.batch_size, lhs.shape[-2], rhs.shape[-1]
        lhs = _pad_dim(_pad_dim(lhs, -1, kmult), -2, m_mult)
        rhs = _pad_dim(_pad_dim(rhs, -2, kmult), -1, f_n)
        if batched:
            if form.lhs_batched:
                lhs = _pad_dim(lhs, -3, f_b)
            if form.rhs_batched:
                rhs = _pad_dim(rhs, -3, f_b)
        part = _contract(rm.local(lhs, in_specs[0]),
                         rm.local(rhs, in_specs[1]))
        out = reduce_partial(part).to(dtype)
        out = rm.gather_global(out, out_spec)[..., :m, :n]
        return out[:b] if batched else out

    return run


def _compressed_k_spatial_fn(sol, rm, dtype, comp, out_spec, f_m, f_n,
                             m_mult, reduce_partial):
    """Compressed operand under a k-spatial plan: every rank holds only
    the nonzero blocks of its own (stat-shard, k-shard) tile — local-frame
    k coordinates against the dense side's k-shard — and the reduction
    (psum tree or staggered output ring) runs on the partial products."""
    sp_side = comp.side
    sp_tp = sol.lhs if sp_side == "lhs" else sol.rhs
    b0, b1 = comp.block
    b_stat, b_k = (b0, b1) if sp_side == "lhs" else (b1, b0)
    stat_ax = sp_tp.axis_of.get("m" if sp_side == "lhs" else "n")
    f_stat = plan_mod._axis_factor(stat_ax, sol.sizes)
    stat_blocks = ((comp.d0_pad if sp_side == "lhs" else comp.d1_pad)
                   // (b_stat * f_stat))
    dn_tp = sol.rhs if sp_side == "lhs" else sol.lhs
    dense_spec = _spec_of(dn_tp)
    tri = _rank_triple(comp, rm, sol.axes)

    def run(lhs, rhs):
        m, n = lhs.shape[-2], rhs.shape[-1]
        sp2d, dn2d = (lhs, rhs) if sp_side == "lhs" else (rhs, lhs)
        pay = _pack_payload(sp2d, comp, tri)
        if sp_side == "lhs":
            dn2d = _pad_dim(_pad_dim(dn2d, -1, f_n), -2, comp.d1_pad)
            dn2d = dn2d[:comp.d1_pad]
        else:
            dn2d = _pad_dim(_pad_dim(dn2d, -2, max(f_m, m_mult)),
                            -1, comp.d0_pad)
            dn2d = dn2d[:, :comp.d0_pad]
        part = _bsr_contract(pay, tri.sc, tri.kc, rm.local(dn2d, dense_spec),
                             sp_side, stat_blocks, b_stat, b_k)
        if sol.stagger and part.shape[-2] % m_mult:
            part = _pad_dim(part, -2, m_mult)
        out = reduce_partial(part).to(dtype)
        return rm.gather_global(out, out_spec)[..., :m, :n]

    return run


# ---------------------------------------------------------------------------
# Introspection: kind -> spec table for one plan (used by docs and tests)
# ---------------------------------------------------------------------------

def describe(comm: CommPlan, form, mesh) -> Dict[str, str]:
    """Human-readable per-tensor realization of a CommPlan on a mesh
    (call on a rank of ``mesh``)."""
    prog = compile_comm_plan(comm, form, mesh)
    lines = {"strategy": prog.strategy,
             "lhs_spec": str(prog.in_specs[0]),
             "rhs_spec": str(prog.in_specs[1]),
             "out_spec": str(prog.out_spec)}
    lines.update(prog.solution.describe())
    for t in comm.tensors:
        ax = ",".join(t.mesh_axes) if t.mesh_axes else "-"
        lines[t.tensor] = f"{t.kind}[{ax}]"
    return lines
