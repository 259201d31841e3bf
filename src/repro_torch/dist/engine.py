"""Hand-written classic GEMM schedules — kept as test oracles.

The port of the reference's ``dist/engine.py``, written directly on
``torch.distributed`` and independent of ``comm_engine``: production mesh
execution goes through the generic CommPlan interpreter
(``comm_engine.compile_comm_plan``, what ``generate(...).sharded`` runs);
these three survive because they are independently-derived realizations
of the classic algorithms the interpreter must recover as special cases:

    summa_matmul        = what gemm x MMT must compute
    cannon_matmul       = what gemm x SST must compute
    ring_reduce_matmul  = what gemm x a K-spatial STT must compute

Mesh axes are ("x", "y") — the chip-level analogue of the paper's 2-D PE
array.  Every rank of the mesh calls each function with the same global
``a`` (M, K) and ``b`` (K, N), extents divisible by the mesh, and gets
the global product back.  gloo groups move host copies, NCCL groups
device tensors.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..launch.mesh import make_mesh


def square_submesh(n: int = 2, *, device=None,
                   backend: Optional[str] = None):
    """An (n, n) ("x", "y") mesh over the first n*n ranks (Cannon needs
    square); every rank of the world must call it."""
    return make_mesh((n, n), ("x", "y"), device=device, backend=backend)


def _device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _host(group) -> bool:
    return dist.get_backend(group) != "nccl"


def _gather(x: torch.Tensor, group, dim: int, device) -> torch.Tensor:
    w = x.contiguous()
    w = w.cpu() if _host(group) else w
    parts = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, w, group=group)
    return torch.cat(parts, dim=dim).to(device)


def _sum(x: torch.Tensor, group, device) -> torch.Tensor:
    w = x.cpu() if _host(group) else x.clone()
    dist.all_reduce(w, group=group)
    return w.to(device)


def _shift_back(x: torch.Tensor, group, device) -> torch.Tensor:
    """Position r receives position r+1's block (one hop backwards)."""
    ranks = dist.get_process_group_ranks(group)
    size = len(ranks)
    if size == 1:
        return x
    me = ranks.index(dist.get_rank())
    w = x.contiguous()
    w = w.cpu() if _host(group) else w
    buf = torch.empty_like(w)
    ops = [dist.P2POp(dist.isend, w, ranks[(me - 1) % size], group),
           dist.P2POp(dist.irecv, buf, ranks[(me + 1) % size], group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return buf.to(device)


def _block(x: torch.Tensor, i: int, si: int, j: int, sj: int
           ) -> torch.Tensor:
    r, c = x.shape[0] // si, x.shape[1] // sj
    return x[i * r:(i + 1) * r, j * c:(j + 1) * c]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def summa_matmul(a: torch.Tensor, b: torch.Tensor, mesh) -> torch.Tensor:
    """SUMMA (MMT-class: inputs all_gather, output sharded/stationary).

    Both operands are fully sharded over the mesh; each (i, j) rank
    all_gathers A's row panel along y and B's column panel along x — the
    mesh realization of the multicast wires — then computes its resident
    C block with no further communication.
    """
    dev = _device(mesh)
    (i, j), (s0, s1) = mesh.get_coordinate(), tuple(mesh.shape)
    gx, gy = mesh.get_group("x"), mesh.get_group("y")
    a_row = _gather(_block(a.to(dev), i, s0, j, s1), gy, 1, dev)
    b_col = _gather(_block(b.to(dev), i, s0, j, s1), gx, 0, dev)
    c = _dot(a_row, b_col).to(a.dtype)
    return _gather(_gather(c, gy, 1, dev), gx, 0, dev)


def ring_reduce_matmul(a: torch.Tensor, b: torch.Tensor, mesh
                       ) -> torch.Tensor:
    """Reduction-class schedule (K spatial: output psum, operands sharded).

    The contraction dimension is sharded over the whole mesh (shard
    ``i * |y| + j``); every rank computes a full-size partial product and
    the reduction tree sums it over both axes.
    """
    dev = _device(mesh)
    (i, j), (s0, s1) = mesh.get_coordinate(), tuple(mesh.shape)
    idx, parts = i * s1 + j, s0 * s1
    kb = a.shape[1] // parts
    partial = _dot(a.to(dev)[:, idx * kb:(idx + 1) * kb],
                   b.to(dev)[idx * kb:(idx + 1) * kb])
    partial = _sum(partial, mesh.get_group("x"), dev)
    return _sum(partial, mesh.get_group("y"), dev).to(a.dtype)


def _skew_blocks(m: torch.Tensor, s: int, axis: int, by_axis: int
                 ) -> torch.Tensor:
    """Cannon's initial alignment: roll block row/col ``i`` by ``i``
    blocks (on the global array; the steady-state rotation is the
    systolic ring)."""
    blocks = torch.split(m, m.shape[by_axis] // s, dim=by_axis)
    rolled = [torch.roll(blk, -i * (m.shape[axis] // s), dims=axis)
              for i, blk in enumerate(blocks)]
    return torch.cat(rolled, dim=by_axis)


def cannon_matmul(a: torch.Tensor, b: torch.Tensor, mesh) -> torch.Tensor:
    """Cannon (SST-class: inputs on ppermute rings, output stationary).

    Blocks of A circulate left along x-rows and blocks of B circulate up
    along y-columns — the chip-mesh realization of the systolic
    nearest-neighbour wires — while each rank's C block stays resident.
    """
    s = tuple(mesh.shape)[0]
    if tuple(mesh.shape) != (s, s):
        raise ValueError("Cannon needs a square mesh")
    dev = _device(mesh)
    i, j = mesh.get_coordinate()
    gx, gy = mesh.get_group("x"), mesh.get_group("y")
    a_c = _block(_skew_blocks(a.to(dev), s, axis=1, by_axis=0), i, s, j, s)
    b_c = _block(_skew_blocks(b.to(dev), s, axis=0, by_axis=1), i, s, j, s)
    acc = torch.zeros((a_c.shape[0], b_c.shape[1]), dtype=torch.float32,
                      device=dev)
    for _ in range(s):
        acc += _dot(a_c, b_c)
        a_c = _shift_back(a_c, gy, dev)
        b_c = _shift_back(b_c, gx, dev)
    c = acc.to(a.dtype)
    return _gather(_gather(c, gy, 1, dev), gx, 0, dev)
