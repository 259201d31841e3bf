"""Rank launcher: one process per mesh position.

``shard_map`` runs one program on every device of a mesh inside one
process; on ``torch.distributed`` one *process* is one mesh position.
``run_ranks(fn, world, device=..., backend=...)`` starts ``world`` such
processes (start method ``spawn``), joins them into one process group and
returns rank 0's result:

    from repro_torch.dist import spawn
    out = spawn.run_ranks(my_rank_fn, 8, device="cpu", args=(seed,))

``fn`` must live in an importable module (spawned children re-import it
by name) and is called as ``fn(*args)`` in every rank; it finds its rank
with ``torch.distributed.get_rank()``.  Only rank 0's return value comes
back, pickled, so return plain data (numpy arrays, numbers, strings).

The backend follows the device unless the caller names one: NCCL for
``"cuda"``, gloo for ``"cpu"``.  NCCL allows one rank per card; a caller
that wants several ranks on one card asks for ``backend="gloo"`` (its
collectives then move host copies, ``comm_engine`` stages them).  Nothing
here switches backend or device when one is missing: that raises.

Every run gets a rendezvous of its own (a ``file://`` store in a fresh
temporary directory), so concurrent runs never collide.  A rank that
raises fails the run with its traceback; a run that outlasts ``timeout``
fails too, and every child is stopped before ``run_ranks`` returns.

``single_rank(device=...)`` makes the calling process a one-rank world
for the length of a ``with`` block (a 1x1 mesh without a child process).
"""
from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Iterator, Optional, Sequence

import torch
import torch.distributed as dist

from ..kernels.ops import resolve_device
from ..launch.mesh import resolve_backend

#: seconds a run may take before it fails (and every collective's timeout)
DEFAULT_TIMEOUT = 300.0


def _init_group(rank: int, world: int, store: str, device: torch.device,
                backend: str, timeout: float) -> None:
    if device.type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"file://{store}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout))


def _rank_main(rank: int, world: int, store: str, device: torch.device,
               backend: str, timeout: float, call: str, results) -> None:
    try:
        with open(call, "rb") as f:
            fn, args = pickle.load(f)
        _init_group(rank, world, store, device, backend, timeout)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out if rank == 0 else None))
    except Exception:   # the run's boundary: report, the parent raises
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world: int, *, device=None,
              backend: Optional[str] = None, args: Sequence = (),
              timeout: float = DEFAULT_TIMEOUT) -> Any:
    """Run ``fn(*args)`` in ``world`` ranks of one process group; return
    rank 0's result.  Raises ``RuntimeError`` with the failing rank's
    traceback, ``TimeoutError`` when the ranks outlast ``timeout``."""
    device = resolve_device(device)
    backend = resolve_backend(device, backend)
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    if backend == "nccl" and world > torch.cuda.device_count():
        raise ValueError(
            f"NCCL allows one rank per card: {world} ranks need "
            f"{world} cards, this machine has {torch.cuda.device_count()}; "
            "share a card with backend='gloo'")
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro-ranks-") as tmp:
        store = os.path.join(tmp, "store")
        # the function and its arguments travel in a file: a spawned
        # child reads its start-up data only once its interpreter is up,
        # so data in the start-up pipe would start the ranks one by one
        call = os.path.join(tmp, "call.pkl")
        with open(call, "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, store, device, backend, timeout,
                                   call, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        done = False
        try:
            out = _collect(procs, results, world, timeout)
            done = True
            return out
        finally:
            # a finished run's ranks are exiting; a failed run's are not
            _stop(procs, grace=10.0 if done else 0.0)


def _collect(procs, results, world: int, timeout: float) -> Any:
    done = {}
    deadline = time.monotonic() + timeout
    while len(done) < world:
        try:
            rank, ok, payload = results.get(timeout=0.2)
        except queue.Empty:
            if time.monotonic() > deadline:
                missing = sorted(set(range(world)) - set(done))
                raise TimeoutError(f"ranks {missing} of {world} did not "
                                   f"finish within {timeout:.0f} s")
            for r, p in enumerate(procs):
                if r not in done and p.exitcode not in (None, 0):
                    raise RuntimeError(f"rank {r} of {world} exited with "
                                       f"code {p.exitcode} and no result")
            continue
        if not ok:
            raise RuntimeError(f"rank {rank} of {world} failed:\n{payload}")
        done[rank] = payload
    return done[0]


def _stop(procs, grace: float) -> None:
    for p in procs:
        p.join(timeout=grace)
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(timeout=5)
        if p.is_alive():
            p.kill()
            p.join()


@contextlib.contextmanager
def single_rank(device=None, backend: Optional[str] = None,
                timeout: float = DEFAULT_TIMEOUT) -> Iterator[None]:
    """This process as a one-rank world for the ``with`` block."""
    device = resolve_device(device)
    backend = resolve_backend(device, backend)
    if dist.is_initialized():
        raise RuntimeError("a default process group already exists in "
                           "this process")
    if device.type == "cuda":
        # the device NCCL's communicators bind to
        torch.cuda.set_device(device.index or 0)
    with tempfile.TemporaryDirectory(prefix="repro-rank-") as tmp:
        dist.init_process_group(
            backend, init_method=f"file://{os.path.join(tmp, 'store')}",
            world_size=1, rank=0,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            yield
        finally:
            dist.destroy_process_group()
