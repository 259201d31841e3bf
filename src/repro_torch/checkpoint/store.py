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
    then keeps the newest ``keep`` checkpoints.

The reference's elastic restore onto another mesh (``shardings=``)
arrives with the model-mesh slice and raises here.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..optim.adamw import Q8

MESH_SLICE = ("restoring onto a mesh (shardings=) arrives with the "
              "model-mesh slice")


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


def save(ckpt_dir: str, step: int, tree: Any, *,
         extra: Optional[Dict] = None) -> str:
    """Synchronous atomic save.  Returns the checkpoint path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten_with_paths(tree)
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


class AsyncCheckpointer:
    """Snapshot on the caller thread; write on a daemon thread."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save_async(self, step: int, tree: Any,
                   extra: Optional[Dict] = None) -> None:
        self.wait()                              # one in flight at a time
        host_tree = _flatten_with_paths(tree)    # snapshot now

        def work():
            try:
                # the flat snapshot's keys are its leaf paths already
                save(self.ckpt_dir, step, host_tree, extra=extra)
                self._gc()
            except BaseException as e:           # pragma: no cover
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
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


def _rebuild(like, data, prefix: str):
    kids = _children(like)
    if kids is None:
        arr = data[prefix]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"shape mismatch for {prefix}: "
                             f"ckpt {arr.shape} vs model {tuple(like.shape)}")
        if isinstance(like, torch.Tensor):
            return torch.from_numpy(np.array(arr)).to(device=like.device,
                                                      dtype=like.dtype)
        return np.asarray(arr).astype(np.asarray(like).dtype)
    vals = [_rebuild(child, data, f"{prefix}/{piece}" if prefix else piece)
            for piece, child in kids]
    if isinstance(like, dict):
        return {piece: v for (piece, _), v in zip(kids, vals)}
    if isinstance(like, Q8):
        return Q8(vals[0], vals[1], like.shape)
    return type(like)(*vals)


def restore(ckpt_dir: str, tree_like: Any, *, step: Optional[int] = None,
            shardings: Any = None, prefix: str = ""
            ) -> Tuple[Any, int, Dict]:
    """Restore into the structure, shapes, dtypes and devices of
    ``tree_like``.  ``prefix`` reads a subtree (``".params"``: a train
    state's parameters).  A missing directory raises FileNotFoundError,
    a leaf of another shape ValueError."""
    if shardings is not None:
        raise NotImplementedError(MESH_SLICE)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        out = _rebuild(tree_like, data, prefix)
    return out, step, manifest.get("extra", {})
