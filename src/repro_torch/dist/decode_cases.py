"""Placed-decode cases: rank functions for prefill and decode on a cache
placed by ``launch.specs.cache_shardings``, run by
``dist.spawn.run_ranks`` in every rank.

The tests (``tests/test_torch_placed_decode.py``) describe what to run
as plain data (:class:`DecodeCase`, numpy tokens, frontends, the
reference's parameters and caches); these functions live in the package
because spawned children re-import them by name.

A case runs on its ``("data", "model")`` mesh; ranks outside it (a 2x2
mesh in an 8-rank world) build the mesh and sit the case out.  Each rank
of the mesh runs three things on the global inputs:

* **own**: ``prefill`` on the mesh, then greedy ``decode_step`` s on the
  cache it returned (the rank's blocks);
* **placed**: the reference's prefill cache cut to the rank's blocks by
  ``cache_shardings`` (``RankMesh.local``), then ``decode_step`` s fed
  the reference's greedy tokens;
* **init**: ``init_cache`` on the mesh (the leaves' shapes).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

#: the mesh axes of every case
AXES = ("data", "model")
#: decode steps after the prefill
STEPS = 8


@dataclasses.dataclass(frozen=True)
class DecodeCase:
    """``arch``'s reduced config with ``overrides`` on a ``mesh``
    (``data``, ``model``)."""

    label: str
    arch: str
    mesh: tuple
    overrides: tuple = ()


def case_config(case: DecodeCase):
    from ..configs import get_config
    return dataclasses.replace(get_config(case.arch).reduced(),
                               **dict(case.overrides))


def cache_specs(case: DecodeCase, batch: int, max_len: int
                ) -> Dict[str, Any]:
    """{leaf path: ``Spec``} of the decode cache, as the cell's
    ``cache_shardings`` places it on the case's mesh."""
    from ..launch import specs
    cfg = case_config(case)
    return flat(specs.cache_shardings(specs.cache_struct(cfg, batch,
                                                         max_len),
                                      cfg, dict(zip(AXES, case.mesh))))


def flat(tree, prefix: str = "") -> Dict[str, Any]:
    """{"a/b": leaf} of a nested dict, ``pos`` left out."""
    out = {}
    for k, v in tree.items():
        if k == "pos":
            continue
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def nest(flat_tree: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat_tree.items():
        *parts, last = key.split("/")
        d = tree
        for p in parts:
            d = d.setdefault(p, {})
        d[last] = v
    return tree


def _numpy(tree) -> Dict[str, np.ndarray]:
    """Copies: decode writes the K/V tensors in place."""
    return {k: v.float().numpy().copy() for k, v in flat(tree).items()}


def _is_copy(t: torch.Tensor) -> bool:
    """Contiguous and alone in its storage: no view of a larger tensor."""
    return (t.is_contiguous() and t.untyped_storage().nbytes()
            == t.numel() * t.element_size())


def _every_rank(rec):
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, rec)
    return out


def run_case(case: DecodeCase, rm, tokens: np.ndarray,
             frontend: Optional[np.ndarray], ref: Dict[str, Any],
             max_len: int, steps: int = STEPS) -> Dict[str, Any]:
    """The case's three runs in this rank of its mesh (module
    docstring): this rank's record.  ``rm`` None: the same on one
    device, the reference's cache whole."""
    from .. import convert
    from ..models import decode as dec
    cfg = case_config(case)
    params = convert.params_from_reference(ref["params"], device="cpu")
    toks = torch.as_tensor(tokens)
    fe = None if frontend is None else torch.as_tensor(frontend)
    b, s = tokens.shape
    rec: Dict[str, Any] = {"coord": {} if rm is None else dict(rm.coord)}

    # own: prefill on the mesh, greedy decode on its cache
    logits, cache = dec.prefill(params, toks, cfg, frontend=fe,
                                max_len=max_len)
    rec["prefill_cache"] = _numpy(cache)
    rec["dtypes"] = {k: str(v.dtype).split(".")[-1]
                     for k, v in flat(cache).items()}
    rec["copies"] = all(_is_copy(t) for t in flat(cache).values())
    got_logits, got_tokens = [logits.float().numpy()], []
    for _ in range(steps):
        nxt = logits.argmax(-1)[:, None]
        got_tokens.append(nxt.numpy())
        logits, cache = dec.decode_step(params, nxt, cache, cfg)
        got_logits.append(logits.float().numpy())
    rec["logits"] = np.stack(got_logits)
    rec["tokens"] = np.concatenate(got_tokens, axis=1)
    rec["cache"] = _numpy(cache)

    # placed: the reference's prefill cache cut by cache_shardings
    spec = cache_specs(case, b, max_len)
    placed = {k: (torch.as_tensor(v) if rm is None else rm.local(
        torch.as_tensor(v), spec[k])).clone(
            memory_format=torch.contiguous_format)
        for k, v in ref["cache"].items()}
    cache_p = dict(nest(placed), pos=s)
    forced = []
    for i in range(steps):
        lg, cache_p = dec.decode_step(
            params, torch.as_tensor(ref["tokens"][:, i:i + 1]).long(),
            cache_p, cfg)
        forced.append(lg.float().numpy())
    rec["forced"] = np.stack(forced)

    # init: the empty cache's leaf shapes on the mesh
    rec["init_shapes"] = {k: tuple(v.shape) for k, v in flat(dec.init_cache(
        params, cfg, b, max_len, frontend=fe, device="cpu")).items()}
    return rec


def placed_battery(cases: Sequence[DecodeCase], tokens: np.ndarray,
                   frontends: Dict[str, np.ndarray],
                   refs: Dict[str, Dict[str, Any]], max_len: int):
    """Every case on its mesh (:func:`run_case`); rank 0 gets {label: the
    records of the mesh's ranks, in rank order}."""
    from ..launch.mesh import make_mesh, set_mesh

    meshes = {shape: make_mesh(shape, AXES, device="cpu")
              for shape in sorted({c.mesh for c in cases})}
    out = {}
    for case in cases:
        rec = None
        if dist.get_rank() < math.prod(case.mesh):
            with torch.no_grad(), set_mesh(meshes[case.mesh]) as rm:
                rec = run_case(case, rm, tokens, frontends.get(case.label),
                               refs[case.label], max_len)
        out[case.label] = rec
    recs = _every_rank(out)
    return {c.label: [r[c.label] for r in recs if r[c.label] is not None]
            for c in cases}
