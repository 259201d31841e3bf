"""Mesh construction over the default process group.

The port of the reference's ``launch/mesh.py``: the same shapes and axis
names, as a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of the default process group (row-major: position ``(i, j)`` is rank
``i * cols + j``).  Functions, not module-level constants: importing
this module touches no process group.

Every rank of the world must build every mesh, including the sub-meshes
it is not part of (DeviceMesh creates one process group per mesh row and
column, and group creation is collective over the world).

The device defaults to the card and the backend to NCCL; ``device="cpu"``
takes gloo, and a caller that wants gloo ranks on a card (several ranks
sharing one) passes ``backend="gloo"``.  A missing card or a default
group that runs another backend raises; nothing switches on its own.

:func:`set_mesh` / :func:`current_mesh` are the models' ambient mesh,
the counterparts of the reference's ``jax_compat.set_mesh`` /
``get_abstract_mesh``: ``models.explicit_tp`` and the model entry points
read it.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..kernels.ops import resolve_device


def resolve_backend(device: torch.device, backend: Optional[str]) -> str:
    """``backend`` checked against ``device``; by default NCCL for the
    card, gloo for the CPU."""
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("NCCL moves CUDA tensors only: a CPU rank needs "
                         "backend='gloo'")
    return backend


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, device=None,
              backend: Optional[str] = None) -> DeviceMesh:
    """A ``shape`` mesh named ``axes`` over the first ``prod(shape)``
    ranks of the default process group.  In a :func:`fake_world` the
    mesh's groups are fake (``device`` and ``backend`` are the world's)."""
    fake = dist.is_initialized() and dist.get_backend() == "fake"
    if fake:
        device = torch.device("cpu")
    else:
        device = resolve_device(device)
        backend = resolve_backend(device, backend)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} and axes "
                         f"{tuple(axes)} differ in length")
    if not dist.is_initialized():
        raise RuntimeError(
            "no default process group: start the ranks with "
            "repro_torch.dist.spawn.run_ranks (or single_rank), or call "
            "torch.distributed.init_process_group first")
    have = dist.get_backend()
    if not fake and have != backend:
        raise RuntimeError(f"the default process group runs {have!r}; this "
                           f"mesh asks for {backend!r}")
    n = math.prod(shape)
    if n > dist.get_world_size():
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks, the "
                         f"world has {dist.get_world_size()}")
    return DeviceMesh(device.type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None,
                         backend: Optional[str] = None) -> DeviceMesh:
    """16x16 positions per pod; 2 pods when ``multi_pod``.

    Axes: ('data', 'model') single-pod; ('pod', 'data', 'model')
    multi-pod.  DP runs over (pod, data); FSDP over data; TP/SP/EP over
    model.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device, backend=backend)


def make_host_mesh(data: int = 1, model: int = 1, *, device=None,
                   backend: Optional[str] = None) -> DeviceMesh:
    """A small ('data', 'model') mesh over the first ``data * model``
    ranks — what tests and the examples use."""
    return make_mesh((data, model), ("data", "model"), device=device,
                     backend=backend)


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0, backend: str = "nccl"
               ) -> Iterator[None]:
    """Open PyTorch's ``fake`` default process group of ``world`` ranks,
    this process being ``rank``, for the ``with`` block: the counterpart
    of the reference's ``--xla_force_host_platform_device_count``.  One
    process then stands for one rank of a mesh of any size: meshes build
    as on a real world, a rank's tensors are ``meta``
    (``dist.comm_engine.mesh_device``) and its collectives move nothing,
    taking the path of ``backend`` (``"nccl"``, the card's, or
    ``"gloo"``).  One process holds one default group: the block needs
    none open, and closes its own."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from ..dist.comm_engine import FAKE_BACKEND
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"a fake world stands for 'nccl' or 'gloo', got "
                         f"{backend!r}")
    if dist.is_initialized():
        raise RuntimeError("a default process group is open: a fake world "
                           "needs the process to itself")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    FAKE_BACKEND.append(backend)
    try:
        yield
    finally:
        FAKE_BACKEND.pop()
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the ambient mesh of the models (``jax_compat.set_mesh`` /
# ``get_abstract_mesh``)
# ---------------------------------------------------------------------------

#: the meshes entered with :func:`set_mesh`, innermost last.  One process
#: is one rank, so the ambient mesh is the process's, not a thread's: a
#: serving thread started inside the block sees it too.
_MESHES: list = []


@contextlib.contextmanager
def set_mesh(mesh) -> Iterator:
    """Run the models on ``mesh`` for the ``with`` block: the counterpart
    of ``jax.sharding.set_mesh``.  ``mesh`` is a ``DeviceMesh`` (from
    :func:`make_mesh`) or this rank's ``dist.comm_engine.RankMesh`` of
    one; its axis names are the reference's (``pod``, ``data``,
    ``model``: the batch shards over ``pod`` x ``data``, the model's
    tensor-parallel collectives run over ``model``; other names split
    nothing).  Yields the rank's ``RankMesh``.  Only the mesh's own ranks
    may enter it."""
    from ..dist.comm_engine import RankMesh
    rank_mesh = mesh if isinstance(mesh, RankMesh) else RankMesh(mesh)
    _MESHES.append(rank_mesh)
    try:
        yield rank_mesh
    finally:
        _MESHES.pop()


def current_mesh():
    """The ``RankMesh`` of the innermost :func:`set_mesh` block, or None
    outside every block (``get_abstract_mesh`` with no axes)."""
    return _MESHES[-1] if _MESHES else None
