"""Mesh cases: one description, run the same way by every rank.

The selftests, the tests and the card check describe what to run as
:class:`Case` values (plain, picklable data) and hand them to
:func:`run_cases` inside ranks started by ``spawn.run_ranks``.  Every
rank builds every mesh the cases name (mesh construction is collective
over the world), then runs each case whose mesh it belongs to; ranks
outside a case's mesh skip it.  Each case yields a record on rank 0:
the solved partition, the interpreter's ``describe()``, the per-device
footprint, rank 0's output, whether every rank of the mesh rebuilt the
same output bits, and each rank's host seconds for the call.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core import algebra as algebra_mod
from ..core import linalg, stt
from ..core.algebra import Sparsity
from ..launch.mesh import make_mesh
from . import comm_engine

#: a K-spatial GEMM STT: space = (k, n), time = m -> C is a reduction
#: (psum) output, B stationary, A multicast — the ring-reduce family
K_SPATIAL_T = ((0, 0, 1), (0, 1, 0), (1, 0, 0))

NAMED_DATAFLOWS = ("identity", "output_stationary", "weight_stationary",
                   "input_stationary")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class Case:
    """One accelerator on one mesh.

    ``dataflow`` is a named STT or an STT matrix (tuple of rows) applied
    to the algebra's first three loops.  ``sparsity`` holds
    ``("random", tensor, shape, block, density, seed)`` or
    ``("coords", tensor, block, coords)`` entries.  ``operands`` is
    ``"int"`` (``alg.random_operands``) or ``"normal"`` (standard normal,
    masked by the patterns)."""

    label: str
    algebra: str
    bounds: Tuple[Tuple[str, int], ...]
    dataflow: object
    mesh: Tuple[int, int]
    sparsity: Tuple[tuple, ...] = ()
    operands: str = "int"
    seed: int = 3
    dtype: str = "float32"
    sparse: str = "auto"
    shard_batch: bool = True

    def build_algebra(self):
        alg = algebra_mod.get_algebra(self.algebra, **dict(self.bounds))
        pats = {}
        for entry in self.sparsity:
            if entry[0] == "random":
                _, name, shape, block, density, seed = entry
                pats[name] = Sparsity.random(shape, block, density,
                                             seed=seed)
            else:
                _, name, block, coords = entry
                pats[name] = Sparsity(block, coords)
        return alg.with_sparsity(**pats) if pats else alg

    def build_dataflow(self, alg):
        if isinstance(self.dataflow, str):
            return self.dataflow
        return stt.apply_stt(alg, alg.loops[:3], linalg.mat(
            [list(r) for r in self.dataflow]))

    def build_operands(self, alg) -> Dict[str, np.ndarray]:
        if self.operands == "int":
            return alg.random_operands(seed=self.seed)
        rng = np.random.default_rng(self.seed)
        out = {}
        for t in alg.inputs:
            v = rng.standard_normal(alg.tensor_shape(t))
            sp = alg.sparsity_of(t.name)
            if sp is not None:
                v = v * sp.element_mask(alg.tensor_shape(t))
            out[t.name] = v
        return out


def case(label: str, algebra: str, bounds: dict, dataflow, mesh,
         **kw) -> Case:
    """A :class:`Case` from a bounds dict."""
    return Case(label, algebra, tuple(sorted(bounds.items())), dataflow,
                tuple(mesh), **kw)


def digest(t: torch.Tensor) -> str:
    """The output's bits, as a hash."""
    return hashlib.sha256(t.detach().cpu().contiguous().view(torch.uint8)
                          .numpy().tobytes()).hexdigest()


def mesh_gather(obj, mesh) -> list:
    """``obj`` from every rank of a 2-D mesh (row-major), on every rank
    of it."""
    ax0, ax1 = mesh.mesh_dim_names
    row = [None] * mesh.shape[1]
    dist.all_gather_object(row, obj, group=mesh.get_group(ax1))
    rows = [None] * mesh.shape[0]
    dist.all_gather_object(rows, row, group=mesh.get_group(ax0))
    return [o for r in rows for o in r]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_meshes(shapes, *, device, backend: Optional[str] = None) -> dict:
    """Every ("x", "y") mesh of ``shapes``, built on every rank in one
    order."""
    return {s: make_mesh(s, ("x", "y"), device=device, backend=backend)
            for s in sorted(set(shapes))}


def run_case(c: Case, mesh, *, device, keep_out: bool = True,
             repeat: int = 1, single: bool = False) -> Optional[dict]:
    """Run one case on this rank (every rank of ``mesh`` must call);
    the record on the mesh's first rank, None elsewhere.  ``single``
    also runs the unbound (one-device) accelerator on this rank and
    records whether every rank's mesh output equals it exactly."""
    import repro_torch

    alg = c.build_algebra()
    acc = repro_torch.generate(alg, c.build_dataflow(alg),
                               dtype=DTYPES[c.dtype], device=device,
                               validate=False)
    sh = acc.sharded(mesh, sparse=c.sparse, shard_batch=c.shard_batch)
    ops = c.build_operands(alg)
    prog = sh._program()
    dev = comm_engine.mesh_device(mesh)
    outs, secs = [], []
    for _ in range(repeat):
        sync(dev)
        t0 = time.perf_counter()
        out = sh(ops)
        sync(dev)
        secs.append(time.perf_counter() - t0)
        outs.append(out)
    out = outs[0]
    form = acc.kernel.form
    sol = prog.solution
    bits = digest(out)
    info = {"digest": bits,
            "repeat_same": all(digest(o) == bits for o in outs[1:]),
            "seconds": secs, "device": str(out.device),
            "on_mesh_device": out.device.type == mesh.device_type}
    if single:
        info["equal_single"] = bool(torch.equal(out, acc(ops)))
    every = mesh_gather(info, mesh)
    if any(mesh.get_coordinate()):
        return None
    eb = acc.kernel.dtype.itemsize
    rec = {
        "strategy": prog.strategy, "ring_axes": prog.ring_axes,
        "in_specs": tuple(str(s) for s in prog.in_specs),
        "out_spec": str(prog.out_spec), "pads": prog.pads,
        "describe": comm_engine.describe(acc.plan.comm, form, mesh),
        "solution": sol.describe(), "batch_axis": sol.batch_axis,
        "replicated_inputs": sol.replicated_inputs(),
        "lhs_compressed": sol.lhs.compressed,
        "rhs_compressed": sol.rhs.compressed,
        "footprint": prog.footprint(form, eb), "sizes": sol.sizes,
        "out_motion": sol.out.motion,
        "out_m_axis": sol.out.axis_of.get("m"), "m": form.m, "n": form.n,
        "agree": len({e["digest"] for e in every}) == 1,
        "repeat_same": all(e["repeat_same"] for e in every),
        "on_mesh_device": all(e["on_mesh_device"] for e in every),
        "devices": [e["device"] for e in every],
        "seconds": [e["seconds"] for e in every],
    }
    if single:
        rec["equal_single"] = all(e["equal_single"] for e in every)
    if keep_out:
        rec["out"] = out.to(torch.float32).cpu().numpy()
    return rec


def run_cases(cases: Sequence[Case], device: str = "cpu",
              backend: Optional[str] = None, keep_out: bool = True,
              repeat: int = 1, single: bool = False) -> Dict[str, dict]:
    """Rank function: every case on its mesh; rank 0's records by
    label (see :func:`run_case`)."""
    dev = torch.device(device)
    meshes = build_meshes([c.mesh for c in cases], device=dev,
                          backend=backend)
    out = {}
    for c in cases:
        mesh = meshes[c.mesh]
        if mesh.get_coordinate() is None:
            continue
        rec = run_case(c, mesh, device=dev, keep_out=keep_out,
                       repeat=repeat, single=single)
        if rec is not None:
            out[c.label] = rec
    return out
