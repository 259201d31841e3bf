"""Checkpointing: atomic and async, in the reference's format.

The port of the reference's ``checkpoint/store.py``:

  * layout: ``<dir>/step_XXXXXXXX/arrays.npz`` (leaf path -> array) and
    ``manifest.json`` (step, sorted keys, ``extra``);
  * leaf paths are the reference's ``_flatten_with_paths`` strings: dict
    keys as they are, a named tuple's field as ``.field`` (a train state
    gives ``.params/layers/attn/wq``, ``.opt/.step``, ``.opt/.m/embed``),
    an 8-bit moment's codes and scales as ``/0`` and ``/1``, so a
    checkpoint crosses between the two packages in both directions;
  * atomicity: written to ``<dir>/tmp.<step>`` and published by
    ``os.replace``; a crash mid-save never corrupts the latest one;
  * async: ``AsyncCheckpointer.save_async`` copies the tensors to host
    numpy on the caller's thread and writes on a daemon thread, which
    then keeps the newest ``keep`` checkpoints;
  * elastic: checkpoints carry *logical* arrays only.  A state placed on
    a mesh (``train.trainer.place_state``: each rank holds its blocks) is
    saved with its specs and mesh: the ranks gather one leaf at a time
    to the rank at coordinate 0 of every axis (collective, on the
    caller's thread; the others hold nothing whole), that rank copies it
    to the host, writes and collects old checkpoints, and the others
    wait on a barrier of the mesh's own groups until the checkpoint is
    published.  ``restore(shardings=,
    mesh=)`` reads each whole leaf and keeps this rank's block under the
    *target* specs, so a run saved on one mesh shape restores onto any
    other, or onto one device without specs.  The reference's
    ``NamedSharding`` carries its mesh; here the specs are
    ``dist.comm_engine.Spec`` trees (``trainer.state_shardings``) and the
    mesh comes beside them.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..dist.comm_engine import RankMesh
from ..models import placed
from ..optim.adamw import Q8


def _children(node) -> Optional[list]:
    """(path piece, child) pairs of an inner node (a dict, an 8-bit
    moment, a named tuple), None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, Q8):
        return [("0", node.q), ("1", node.scale)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    return None


def _paths(tree, prefix: str = ""):
    """(path, leaf) of every leaf, the reference's path strings."""
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for piece, child in kids:
        yield from _paths(child, f"{prefix}/{piece}" if prefix else piece)


def to_host(x) -> np.ndarray:
    """A leaf as a host numpy copy (bf16 tensors widened to fp32, which
    numpy has no type for): later edits of the tensor do not reach it."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.to("cpu", copy=True).numpy()
    return np.array(x)


def _flatten_with_paths(tree: Any) -> Dict[str, np.ndarray]:
    return {key: to_host(leaf) for key, leaf in _paths(tree)}


def _writes(rm) -> bool:
    """Whether this rank writes the mesh's checkpoints: the rank at
    coordinate 0 of every axis."""
    return all(c == 0 for c in rm.coord.values())


def _to_writer(x: torch.Tensor, spec, rm) -> Optional[torch.Tensor]:
    """The whole leaf on the writing rank, None on the others, from every
    rank's block: one ``gather`` an axis the spec shards the leaf over,
    to the axis' coordinate 0, each dimension's axes minor first.  Only
    the ranks at coordinate 0 of every replicating axis and of every
    axis gathered before take part, so no block travels twice and
    nothing returns to the device (gloo axes stay on the host)."""
    used = [a for e in spec for a in placed.axes_in(e, rm)]
    holds = not any(rm.coord[a] for a in rm.axes if a not in used)
    for d, entry in enumerate(spec):
        for a in reversed(placed.axes_in(entry, rm)):
            if not holds or rm.sizes[a] == 1:
                continue
            w = rm._wire(x, a)
            root = rm.coord[a] == 0
            parts = ([torch.empty_like(w) for _ in range(rm.sizes[a])]
                     if root else None)
            dist.gather(w, parts, dst=rm.ranks[a][0], group=rm.groups[a])
            x, holds = (torch.cat(parts, dim=d), True) if root else (None,
                                                                     False)
    return x if holds else None


def _gathered(tree: Any, specs: Any, rm) -> Dict[str, np.ndarray]:
    """The whole leaves of a placed ``tree`` as host numpy, on the writing
    rank (an empty dict on the others).  Collective: every rank of the
    mesh takes part in the leaves' gathers in the same order, one leaf at
    a time, and the writer copies each to the host before the next."""
    flat = {}
    for (key, leaf), (_, spec) in zip(_paths(tree), _paths(specs)):
        whole = _to_writer(leaf, spec, rm)
        if whole is not None:
            flat[key] = to_host(whole)
        del whole
    return flat


def _barrier(rm, failed: bool = False) -> bool:
    """Wait for every rank of the mesh (one all_reduce a mesh axis, over
    the mesh's own groups, not the world's); True where any rank passed
    ``failed``."""
    flag = torch.tensor([float(failed)], device=rm.device)
    axes = tuple(a for a in rm.axes if rm.sizes[a] > 1)
    return bool(rm.psum(flag, axes).item() > 0)


def _write(ckpt_dir: str, step: int, flat: Dict[str, np.ndarray],
           extra: Optional[Dict]) -> str:
    """Write the host arrays ``flat`` as checkpoint ``step`` and publish
    it atomically.  Returns the checkpoint path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {"step": step, "keys": sorted(flat), "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                      # atomic publish
    return final


def save(ckpt_dir: str, step: int, tree: Any, *,
         extra: Optional[Dict] = None, specs: Any = None,
         mesh=None) -> str:
    """Synchronous atomic save.  Returns the checkpoint path.

    With ``mesh`` (a ``DeviceMesh`` or this rank's ``RankMesh``),
    ``tree`` holds this rank's blocks under ``specs``: every rank of the
    mesh calls this, the leaves are gathered whole, one rank writes, and
    every rank returns once the checkpoint is published."""
    if mesh is None:
        return _write(ckpt_dir, step, _flatten_with_paths(tree), extra)
    rm = placed.rank_mesh(mesh)
    flat = _gathered(tree, specs, rm)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    error = None
    if _writes(rm):
        try:
            _write(ckpt_dir, step, flat, extra)
        except Exception as e:    # the others must not wait forever
            error = e
    del flat
    if _barrier(rm, error is not None):
        raise error or RuntimeError(f"the mesh's checkpoint writer failed "
                                    f"to save step {step}")
    return final


class AsyncCheckpointer:
    """Snapshot on the caller thread; write on a daemon thread.

    With ``mesh``, every rank of the mesh makes the same calls: the
    snapshot gathers the placed tree (collective), one rank writes, and
    :meth:`wait` ends on the mesh's barrier, so no rank goes on to list
    the directory before the checkpoint is published."""

    def __init__(self, ckpt_dir: str, keep: int = 3, mesh=None):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.mesh = None if mesh is None else placed.rank_mesh(mesh)
        self._thread: Optional[threading.Thread] = None
        self._pending = False
        self.last_error: Optional[BaseException] = None

    def save_async(self, step: int, tree: Any,
                   extra: Optional[Dict] = None, specs: Any = None) -> None:
        """Save ``tree`` (with a mesh: this rank's blocks under
        ``specs``) as checkpoint ``step`` in the background."""
        self.wait()                              # one in flight at a time
        if self.mesh is None:
            host_tree = _flatten_with_paths(tree)    # snapshot now
        else:
            host_tree = _gathered(tree, specs, self.mesh)
        self._pending = True
        if self.mesh is not None and not _writes(self.mesh):
            return

        def work():
            try:
                # the flat snapshot's keys are its leaf paths already
                _write(self.ckpt_dir, step, host_tree, extra)
                self._gc()
            except BaseException as e:           # pragma: no cover
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the checkpoint in flight is published (with a
        mesh: on every rank); re-raise a failed write."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.mesh is not None and self._pending:
            if _barrier(self.mesh, self.last_error is not None) and \
                    self.last_error is None:
                self.last_error = RuntimeError(
                    "the mesh's checkpoint writer failed")
        self._pending = False
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(list_steps(self.ckpt_dir))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)


def list_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and os.path.isfile(
                os.path.join(ckpt_dir, name, "manifest.json")):
            out.append(int(name.split("_")[1]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def _block_shape(shape, spec, rm) -> Tuple[int, ...]:
    """The shape of this rank's block of a whole leaf of ``shape``."""
    out = list(shape)
    for d, entry in enumerate(spec):
        count = 1
        for a in placed.axes_in(entry, rm):
            count *= rm.sizes[a]
        out[d] = shape[d] // count if shape[d] % count == 0 else -1
    return tuple(out)


def _rebuild(like, data, prefix: str, spec=None, rm=None):
    kids = _children(like)
    if kids is None:
        arr = data[prefix]
        want = tuple(like.shape)
        # a placed leaf is this rank's block of the logical array
        if want != tuple(arr.shape) and (
                rm is None or want != _block_shape(arr.shape, spec, rm)):
            raise ValueError(f"shape mismatch for {prefix}: "
                             f"ckpt {arr.shape} vs model {want}")
        if rm is not None:
            whole = torch.from_numpy(np.asarray(arr))
            return placed.local(whole, spec, rm).to(
                device=rm.device, dtype=like.dtype, copy=True).contiguous()
        if isinstance(like, torch.Tensor):
            return torch.from_numpy(np.array(arr)).to(device=like.device,
                                                      dtype=like.dtype)
        return np.asarray(arr).astype(np.asarray(like).dtype)
    specs = ([None] * len(kids) if spec is None
             else [s for _, s in _children(spec)])
    vals = [_rebuild(child, data, f"{prefix}/{piece}" if prefix else piece,
                     s, rm)
            for (piece, child), s in zip(kids, specs)]
    if isinstance(like, dict):
        return {piece: v for (piece, _), v in zip(kids, vals)}
    if isinstance(like, Q8):
        return Q8(vals[0], vals[1], like.shape)
    return type(like)(*vals)


def restore(ckpt_dir: str, tree_like: Any, *, step: Optional[int] = None,
            shardings: Any = None, mesh=None, prefix: str = ""
            ) -> Tuple[Any, int, Dict]:
    """Restore into the structure, shapes, dtypes and devices of
    ``tree_like``.  ``prefix`` reads a subtree (``".params"``: a train
    state's parameters).  A missing directory raises FileNotFoundError,
    a leaf of another shape ValueError.

    ``shardings``: a tree of ``Spec`` beside ``tree_like`` (a train
    state's from ``trainer.state_shardings``, a Q8 moment's ``q`` and
    ``scale`` with their own), and ``mesh`` the target ``DeviceMesh``
    (or this rank's ``RankMesh``): each rank reads every whole leaf and
    keeps its block under the *target* specs, on the mesh's device, so a
    checkpoint restores onto any mesh shape.  ``tree_like``'s leaves may
    be whole (any device, ``meta`` too) or this rank's blocks, as
    ``place_state`` gives them; either is checked against the logical
    shape.  A rank that is not a position of ``mesh`` reads nothing but
    the manifest and gets None for the tree."""
    if shardings is not None and mesh is None:
        raise ValueError("restore(shardings=) places the leaves on a mesh: "
                         "pass mesh= (the specs' DeviceMesh)")
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    extra = manifest.get("extra", {})
    rm = None
    if shardings is not None:
        if not isinstance(mesh, RankMesh) and \
                mesh.get_coordinate() is None:
            return None, step, extra           # not a rank of this mesh
        rm = placed.rank_mesh(mesh)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        out = _rebuild(tree_like, data, prefix, shardings, rm)
    return out, step, extra
