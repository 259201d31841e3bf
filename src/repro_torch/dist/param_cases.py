"""Placed-parameter cases: rank functions for serving with parameters
placed by ``launch.specs.param_shardings`` (``models.placed``), run by
``dist.spawn.run_ranks`` in every rank.

The tests (``tests/test_torch_placed_params.py``) describe what to run
as plain data (``decode_cases.DecodeCase``, numpy tokens, frontends, the
reference's parameters); these functions live in the package because
spawned children re-import them by name.

A case runs on its ``("data", "model")`` mesh; ranks outside it build
the mesh and sit the case out.  Each rank of the mesh runs prefill and
greedy ``decode_step`` s on the global inputs twice, with the whole
parameters and with its blocks of them (``placed.place_params``),
recording the hidden states handed to the output projection, the
logits, the tokens and the bytes its blocks hold.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .decode_cases import AXES, STEPS, DecodeCase, case_config


@contextlib.contextmanager
def hidden_states(out: list):
    """Record every hidden state ``models.decode`` hands to the output
    projection, ``(rows, d)`` numpy copies, for the ``with`` block."""
    from ..models import decode as dec
    real = dec.logits_from_hidden

    def seen(params, x, cfg):
        out.append(x.float().reshape(x.shape[0], -1).numpy().copy())
        return real(params, x, cfg)
    dec.logits_from_hidden = seen
    try:
        yield
    finally:
        dec.logits_from_hidden = real


def greedy(params, cfg, tokens, frontend, max_len, steps=STEPS):
    """Prefill, then ``steps`` greedy decode steps: (hidden states, logits
    (steps + 1, B, V), tokens (B, steps))."""
    from ..models import decode as dec
    hidden: list = []
    with hidden_states(hidden):
        logits, cache = dec.prefill(params, tokens, cfg, frontend=frontend,
                                    max_len=max_len)
        lg, tk = [logits.float().numpy()], []
        for _ in range(steps):
            nxt = logits.argmax(-1)[:, None]
            tk.append(nxt.numpy())
            logits, cache = dec.decode_step(params, nxt, cache, cfg)
            lg.append(logits.float().numpy())
    return np.stack(hidden), np.stack(lg), np.concatenate(tk, axis=1)


def _own_storages(tree) -> bool:
    """Every leaf contiguous and alone in its storage: no view of a
    whole parameter."""
    from ..launch import dryrun
    return all(t.is_contiguous() and t.untyped_storage().nbytes()
               == t.numel() * t.element_size() for t in dryrun.leaves(tree))


def run_case(case: DecodeCase, mesh, tokens: np.ndarray,
             frontend: Optional[np.ndarray], ref_params: Dict[str, Any],
             max_len: int) -> Dict[str, Any]:
    """The case's whole and placed runs in this rank of its mesh: this
    rank's record."""
    from .. import convert
    from ..launch import dryrun
    from ..launch.mesh import set_mesh
    from ..models import placed
    cfg = case_config(case)
    params = convert.params_from_reference(ref_params, device="cpu")
    toks = torch.as_tensor(tokens)
    fe = None if frontend is None else torch.as_tensor(frontend)
    rec: Dict[str, Any] = {}
    with torch.no_grad(), set_mesh(mesh) as rm:
        rec["coord"] = dict(rm.coord)
        rec["whole"] = greedy(params, cfg, toks, fe, max_len)
        pl = placed.place_params(params, cfg, rm)
        rec["placed"] = greedy(pl, cfg, toks, fe, max_len)
    rec["held_bytes"] = dryrun.storage_bytes(pl)
    rec["spec_bytes"] = dryrun.block_bytes(params, pl.specs, dict(rm.sizes))
    rec["whole_bytes"] = dryrun.storage_bytes(params)
    rec["copies"] = _own_storages(pl)
    return rec


def slot_drive(cfg, params, mesh, prompts, steps: int = 6
               ) -> Dict[str, Any]:
    """The serving engines with the whole parameters on one device and
    built under ``mesh`` (which places them): ``serve_selftest``'s drive
    (two requests, an eviction, churn) on a ``SlotEngine``, a
    ``ContinuousServer`` over one (every request submitted before it
    starts, so every rank's loop takes the same turns) and
    ``DecodeEngine.generate`` on the requests cut to one length.  Both
    sides' results, the placed slot engine's step builds and parameter
    bytes."""
    from ..launch import dryrun
    from ..launch.mesh import set_mesh
    from ..serve import ContinuousServer, DecodeEngine, ServeConfig, \
        SlotEngine
    from .serve_selftest import _drive, churn

    def slots():
        return SlotEngine(params, cfg, capacity=4, max_context=32,
                          page_size=8, device="cpu")

    def served(eng):
        server = ContinuousServer(eng)
        futs = [server.submit(p, max_new_tokens=steps) for p in prompts]
        with server:
            server.drain(timeout=120)
        return [f.result(timeout=1).tolist() for f in futs]

    n = min(len(p) for p in prompts)
    batch = np.stack([p[:n] for p in prompts])

    def generate():
        return DecodeEngine(params, cfg, ServeConfig(max_new_tokens=steps),
                            device="cpu").generate(batch)[0]
    want = {"slots": _drive(slots(), prompts, steps),
            "server": served(slots()), "decode": generate()}
    with torch.no_grad(), set_mesh(mesh):
        eng = slots()
        got = {"slots": _drive(eng, prompts, steps)}
        compiles = churn(eng, prompts, got["slots"], steps)
        got["server"] = served(slots())
        got["decode"] = generate()
    return {"want": want, "got": got, "compiles": compiles,
            "held_bytes": dryrun.storage_bytes(eng.params),
            "spec_bytes": dryrun.block_bytes(params, eng.params.specs,
                                             dict(eng.params.mesh.sizes))}


def placed_battery(cases: Sequence[DecodeCase], tokens: np.ndarray,
                   frontends: Dict[str, np.ndarray],
                   refs: Dict[str, Dict[str, Any]], max_len: int,
                   slot_label: str, prompts: Sequence[np.ndarray]):
    """Every case on its mesh (:func:`run_case`), then the slot engine on
    ``slot_label``'s mesh (:func:`slot_drive`, with that case's
    reference parameters); rank 0 gets {label: the records of the mesh's
    ranks, in rank order} and {"slots": every rank's drive}."""
    from .. import convert
    from ..launch.mesh import make_mesh

    meshes = {shape: make_mesh(shape, AXES, device="cpu")
              for shape in sorted({c.mesh for c in cases})}
    out: Dict[str, Any] = {}
    for case in cases:
        rec = None
        if dist.get_rank() < math.prod(case.mesh):
            rec = run_case(case, meshes[case.mesh], tokens,
                           frontends.get(case.label), refs[case.label],
                           max_len)
        out[case.label] = rec
    slot = next(c for c in cases if c.label == slot_label)
    out["slots"] = slot_drive(
        case_config(slot), convert.params_from_reference(
            refs[slot.label], device="cpu"), meshes[slot.mesh], prompts) \
        if dist.get_rank() < math.prod(slot.mesh) else None
    recs = [None] * dist.get_world_size()
    dist.all_gather_object(recs, out)
    res = {c.label: [r[c.label] for r in recs if r[c.label] is not None]
           for c in cases}
    res["slots"] = [r["slots"] for r in recs if r["slots"] is not None]
    return res
