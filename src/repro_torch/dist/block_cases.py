"""Model-block cases: rank functions for a model-mesh rank that computes
on its ``model`` block of every layer (``models.placed`` gathers each
layer over the batch axes only), run by ``dist.spawn.run_ranks`` in
every rank.

The test (``tests/test_torch_model_block.py``) describes what to run as
plain data (``decode_cases.DecodeCase``, numpy tokens, frontends, the
reference's parameters); these functions live in the package because
spawned children re-import them by name.  A case runs on its ``("data",
"model")`` mesh; ranks outside it (2x2 in an 8-rank world) sit it out.

Each rank of a case's mesh records:

* ``blocks``: layer 0 of every stacked subtree and every unstacked
  subtree as ``placed.layers`` / ``placed.whole`` hand them, against
  the rank's ``model`` block of the whole leaf, whole over ``data``
  (cut here from the spec's entries, the SSM mixer whole), with each
  block's ``Span``; and ``GATHERED.peak`` over one serving forward
  against one layer's blocks plus the unstacked leaves' as gathered
  (``placed.held_bytes``);
* ``greedy``: prefill and greedy decode on the placed parameters, with
  explicit collectives off and on (``param_cases.greedy``);
* ``loss``: ``trainer.block_cross_entropy`` on the rank's vocab block of
  seeded fp32 logits and its gradient with respect to them;
* ``grads``: ``trainer.sharded_value_and_grad`` gathered whole;

and each again under a planted fault (:data:`FAULTS`).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .decode_cases import AXES, DecodeCase, case_config

#: the loss check's logits: (rows, positions, vocab) and their seed
LOSS_SHAPE = (3, 5, 64)


def _mesh(shape):
    from ..launch.mesh import make_mesh
    return make_mesh(shape, AXES, device="cpu")


class _NoGather:
    """A planted fault: ``block_cross_entropy``'s all-gather of the
    blocks' log-sum-exps left out (each rank's own block alone)."""

    @staticmethod
    def apply(x, mesh, axis, dim):
        return x


@contextlib.contextmanager
def fault(name: str):
    """Plant ``name`` for the ``with`` block: ``"gather_model"`` (every
    layer leaf gathered over ``model`` too), ``"unreduced"`` (a
    row-parallel product's partials left unreduced over ``model``),
    ``"lse_alone"`` (the log-sum-exp without the other ranks' blocks);
    None plants nothing."""
    from ..models import explicit_tp as etp
    from ..models import placed
    from ..train import trainer
    saved = []

    def patch(mod, attr, value):
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, value)
    if name == "gather_model":
        patch(placed, "_model_split", lambda spec, rm: (spec, (), None))
    elif name == "unreduced":
        patch(etp, "reduce_model", lambda part, lay: etp.to_layout(part, lay))
    elif name == "lse_alone":
        patch(trainer.etp, "_AllGather", _NoGather)
    try:
        yield
    finally:
        for mod, attr, value in reversed(saved):
            setattr(mod, attr, value)


#: the planted faults each check is run under, beside the sound run
FAULTS = {"blocks": "gather_model", "greedy": "unreduced",
          "loss": "lse_alone", "grads": "unreduced"}


def _want_block(x: torch.Tensor, spec, rm, ssm: bool) -> torch.Tensor:
    """The rank's ``model`` block of whole ``x`` over the dims whose spec
    entry is ``model`` (whole in the SSM mixer and where ``model`` is 1),
    whole over every other axis."""
    if ssm or rm.sizes.get("model", 1) <= 1:
        return x
    for d, entry in enumerate(spec):
        if entry == "model":
            n, i = rm.sizes["model"], rm.coord["model"]
            step = x.shape[d] // n
            x = x.narrow(d, i * step, step)
    return x


def _compare(got, want, specs, rm, ssm=False, drop=0) -> Dict[str, Any]:
    """{"exact": every leaf of ``got`` (a ``placed.Layer`` or tensor) is
    the rank's block of ``want``, "spans": every span names its block}."""
    from ..models import placed
    if not isinstance(want, dict):
        w = _want_block(want, specs[drop:], rm, ssm)
        return {"exact": tuple(got.shape) == tuple(w.shape)
                and bool(torch.equal(got, w)), "spans": True}
    out = {"exact": True, "spans": True}
    for k, v in want.items():
        if isinstance(v, dict):
            r = _compare(got[k], v, specs[k], rm,
                         ssm or k in placed.WHOLE_OVER_MODEL, drop)
        else:
            r = _compare(got[k], v, specs[k], rm, ssm, drop)
            sp = getattr(got, "spans", {}).get(k)
            spec = specs[k][drop:]
            split = (not ssm and rm.sizes.get("model", 1) > 1
                     and "model" in tuple(spec))
            if split:
                d = tuple(spec).index("model")
                step = got[k].shape[d]
                i = rm.coord["model"]
                r["spans"] = sp == placed.Span(i * step, (i + 1) * step,
                                               v.shape[d])
            else:
                r["spans"] = sp is None
        out["exact"] &= r["exact"]
        out["spans"] &= r["spans"]
    return out


def gathered_bound(case: DecodeCase, params: Dict[str, Any], rm) -> int:
    """One layer's bytes as the rank gathers them (the largest of any
    stack's) plus the unstacked leaves' (``placed.held_bytes``)."""
    from ..models import placed
    specs = placed.param_specs(params, _axes(case), rm)
    layer, unstacked = 0, 0
    for key, sub in params.items():
        n = placed.held_bytes(sub, specs[key], rm)
        if key in STACKED:
            layer = max(layer, n // next(iter(_leaves(sub))).shape[0])
        else:
            unstacked += n
    return layer + unstacked


def _axes(case: DecodeCase):
    from ..models import transformer
    return transformer.param_axes(case_config(case))


#: the stacked subtrees of a parameter tree (a leading layer dim)
STACKED = ("layers", "encoder", "cross_layers")


def blocks_record(case: DecodeCase, params: Dict[str, Any], tokens,
                  frontend, rm, bound: int) -> Dict[str, Any]:
    """The ``blocks`` check of one case on the rank (module docstring);
    ``bound``: :func:`gathered_bound`."""
    from ..models import placed, transformer
    cfg = case_config(case)
    pl = placed.place_params(params, cfg, rm)
    rec = _blocks_match(pl, params, rm)
    placed.GATHERED.reset()
    with torch.no_grad():
        transformer.forward(pl, tokens, cfg, frontend=frontend)
    rec.update(peak=placed.GATHERED.peak, bound=bound)
    return rec


def _blocks_match(pl, params, rm) -> Dict[str, bool]:
    """{"exact", "spans"} of every stacked subtree's layer 0 and every
    unstacked subtree of the placed tree ``pl`` against the whole
    ``params`` (:func:`_compare`); the gathered layers die on return."""
    from ..models import placed
    specs = pl.specs
    rec = {"exact": True, "spans": True}
    for key, sub in params.items():
        if key in STACKED:
            got = placed.layers(pl, key)[0]
            want = {k: (placed.layer_params(v, 0) if isinstance(v, dict)
                        else v[0]) for k, v in sub.items()}
            r = _compare(got, want, specs[key], rm, drop=1)
        else:
            r = _compare(placed.whole(pl, key), sub, specs[key], rm)
        rec["exact"] &= r["exact"]
        rec["spans"] &= r["spans"]
    return rec


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def greedy_record(case: DecodeCase, params, tokens, frontend, rm,
                  max_len: int, steps: int, flags=(False, True)
                  ) -> Dict[str, Any]:
    """Prefill and ``steps`` greedy decode steps on the rank's placed
    parameters, for each explicit-collectives flag of ``flags``: {flag:
    (logits, tokens)}."""
    from ..models import placed
    from .param_cases import greedy
    out = {}
    for flag in flags:
        cfg = dataclasses.replace(case_config(case),
                                  explicit_collectives=flag,
                                  sequence_parallel=flag)
        pl = placed.place_params(params, cfg, rm)
        with torch.no_grad():
            _, lg, tk = greedy(pl, cfg, tokens, frontend, max_len, steps)
        out[flag] = (lg, tk)
    return out


def loss_record(rm) -> Dict[str, Any]:
    """``block_cross_entropy`` on the rank's vocab block of seeded fp32
    logits (the same on every rank) against ``common.cross_entropy`` of
    the whole: the loss, and the gradient of the loss's share over the
    ``model`` ranks (each computes the whole loss) with respect to the
    block, against the block of the whole loss's gradient; each as the
    largest difference x max|want|."""
    from ..models import common
    from ..train import trainer
    gen = torch.Generator().manual_seed(11)
    logits = 4.0 * torch.randn(LOSS_SHAPE, generator=gen)
    targets = torch.randint(0, LOSS_SHAPE[-1], LOSS_SHAPE[:2], generator=gen)
    whole = logits.clone().requires_grad_(True)
    want = common.cross_entropy(whole, targets)
    want_g, = torch.autograd.grad(want, whole)
    m, i = rm.sizes["model"], rm.coord["model"]
    n = LOSS_SHAPE[-1] // m
    blk = logits[..., i * n:(i + 1) * n].clone().requires_grad_(True)
    got = trainer.block_cross_entropy(blk, targets, i * n, rm, ("model",))
    got_g, = torch.autograd.grad(got / m, blk)
    want_blk = want_g[..., i * n:(i + 1) * n]
    got, want = got.detach(), want.detach()
    return {"loss": float(abs(got - want) / abs(want)),
            "grad": float((got_g - want_blk).abs().max()
                          / want_g.abs().max())}


def grads_record(arch: str, rm) -> Dict[str, np.ndarray]:
    """``trainer.sharded_value_and_grad`` of ``arch``'s train case on the
    rank's blocks, gathered whole: {leaf path: gradient}."""
    from ..models import transformer
    from ..train import trainer
    from . import train_cases as tc
    case = tc.TrainCase(arch, arch, overrides=())
    cfg = tc.case_config(case)
    state = tc.case_state(case, cfg)
    st_sh = trainer.state_shardings(state, transformer.param_axes(cfg), rm)
    blocks = trainer.place_tree(state.params, st_sh.params, rm)
    from ..launch.mesh import set_mesh
    with set_mesh(rm):
        _, _, g = trainer.sharded_value_and_grad(
            blocks, tc._tensors(tc.case_batch(case, cfg, 0), "cpu"), cfg,
            st_sh.params, rm)
        g = trainer.gather_tree(g, st_sh.params, rm)
    return tc.flat(g)


def block_battery(cases: Sequence[DecodeCase], tokens: np.ndarray,
                  fronts: Dict[str, np.ndarray], params: Dict[str, dict],
                  max_len: int, train_archs: Sequence[str], steps: int
                  ) -> list:
    """Every check of the module docstring on every case's mesh, each
    also under its planted fault (:data:`FAULTS`); ``params[label]`` the
    reference's parameters (numpy), ``train_archs`` the train cases the
    gradients run on (2x4), ``steps`` the greedy decode steps.  Every rank's records, in rank order, on
    every rank."""
    from .. import convert
    from ..launch.mesh import set_mesh
    meshes = {shape: _mesh(shape)
              for shape in sorted({c.mesh for c in cases})}
    rec: Dict[str, Any] = {"rank": dist.get_rank()}
    tok = torch.as_tensor(tokens)
    for case in cases:
        mesh = meshes[case.mesh]
        if mesh.get_coordinate() is None:
            continue
        p = convert.params_from_reference(params[case.label], device="cpu")
        fe = fronts.get(case.arch)
        fe = None if fe is None else torch.as_tensor(fe)
        with set_mesh(mesh) as rm:
            bound = gathered_bound(case, p, rm)
            for planted in (None, FAULTS["blocks"]):
                with fault(planted):
                    rec[f"blocks/{case.label}/{planted}"] = blocks_record(
                        case, p, tok, fe, rm, bound)
            rec[f"greedy/{case.label}/None"] = greedy_record(
                case, p, tok, fe, rm, max_len, steps)
            with fault(FAULTS["greedy"]):
                rec[f"greedy/{case.label}/{FAULTS['greedy']}"] = (
                    greedy_record(case, p, tok, fe, rm, max_len, steps,
                                  flags=(False,)))
    for shape, mesh in meshes.items():
        if mesh.get_coordinate() is None:
            continue
        name = f"{shape[0]}x{shape[1]}"
        with set_mesh(mesh) as rm:
            for planted in (None, FAULTS["loss"]):
                with fault(planted):
                    rec[f"loss/{name}/{planted}"] = loss_record(rm)
            if shape == (2, 4):
                for arch in train_archs:
                    rec[f"grads/{arch}/None"] = grads_record(arch, rm)
                with fault(FAULTS["grads"]):
                    rec[f"grads/{train_archs[0]}/unreduced"] = grads_record(
                        train_archs[0], rm)
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, rec)
    return out
