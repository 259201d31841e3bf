"""Model-mesh cases: rank functions for ``models.explicit_tp`` and the
models on a mesh, run by ``dist.spawn.run_ranks`` in every rank.

The tests (``tests/test_torch_explicit_tp.py``) describe what to run
as plain data (numpy inputs, config names) and start the ranks; these
functions live in the package because spawned children re-import them
by name.

:data:`SPECS` names each helper's inputs with the block of the global
input a rank is handed (per dimension ``"rows"`` — the
rank's batch rows over ``data`` —, ``"model"`` — its block over
``model`` — or None, whole) and the block of the global output it
returns, as the reference's ``shard_map`` ``in_specs`` / ``out_specs``
would cut them; the weights are the rank's ``model`` blocks, as
``models.placed`` hands a layer's leaves to the helpers, and the
helpers read the global extents from a config (:func:`extents`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

#: the helper battery's mesh: ("data", "model")
HELPER_MESH = (2, 4)
AXES = ("data", "model")

#: helper -> (its array inputs, each with its per-dim block spec; its
#: outputs' block specs)
SPECS = {
    "gather_seq": ((("x", ("rows", "model", None)),),
                   (("rows", None, None),)),
    "project_scatter": ((("h", ("rows", None, "model")),
                         ("w", ("model", None))),
                        (("rows", "model", None),)),
    "mlp_manual": ((("x", ("rows", "model", None)), ("wg", (None, "model")),
                    ("wu", (None, "model")), ("wd", ("model", None))),
                   (("rows", "model", None),)),
    "qkv_manual": ((("x", ("rows", "model", None)), ("wq", (None, "model")),
                    ("wk", (None, "model")), ("wv", (None, "model"))),
                   (("rows", None, "model"),) * 3),
    "moe_manual": ((("x", ("rows", "model", None)),
                    ("router", (None, None)),
                    ("mwg", (None, None, "model")),
                    ("mwu", (None, None, "model")),
                    ("mwd", (None, "model", None))),
                   (("rows", "model", None),)),
    "chunked_attn_manual": ((("q", ("rows", None, None, None)),
                             ("k", ("rows", None, None, None)),
                             ("v", ("rows", None, None, None))),
                            (("rows", None, "model", None),)),
}


def moe_config(d_model: int, d_ff: int):
    """The MoE helper's configuration: reduced mixtral-8x22b (4 experts,
    top 2) at ``d_model`` / ``d_ff``, capacity factor 8."""
    from ..configs import get_config
    return dataclasses.replace(get_config("mixtral-8x22b").reduced(),
                               d_model=d_model, d_ff=d_ff,
                               capacity_factor=8.0)


def block(a, spec, coord, sizes):
    """The block of global ``a`` that ``spec`` gives the rank at
    ``coord`` (dicts over ``AXES``)."""
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axis = "data" if entry == "rows" else "model"
        n = sizes[axis]
        step = a.shape[d] // n
        idx = [slice(None)] * a.ndim
        idx[d] = slice(coord[axis] * step, (coord[axis] + 1) * step)
        a = a[tuple(idx)]
    return a


def _mesh(shape, device):
    from ..launch.mesh import make_mesh
    return make_mesh(shape, AXES, device=device)


def extents(ins: Dict[str, np.ndarray]):
    """The global extents a helper reads from its config, from its
    global inputs ``ins``: ``q_dim``, ``kv_dim``, ``d_ff`` and
    ``project_scatter``'s row count."""
    import types
    dim = {"q_dim": ("wq", 1), "kv_dim": ("wk", 1), "d_ff": ("wg", 1),
           "rows": ("w", 0), "moe_ff": ("mwg", 2)}
    return types.SimpleNamespace(**{k: ins[a].shape[d] for k, (a, d)
                                    in dim.items() if a in ins})


def _call(name, args, lay, ext, compute=torch.float32):
    from ..models import explicit_tp as etp
    if name == "gather_seq":
        return etp.gather_seq(args["x"], lay)
    if name == "project_scatter":
        return etp.project_scatter(args["h"], args["w"], lay, ext.rows)
    if name == "mlp_manual":
        return etp.mlp_manual(args["x"], args["wg"], args["wu"], args["wd"],
                              compute, lay, ext)
    if name == "qkv_manual":
        return etp.qkv_manual(args["x"], args["wq"], args["wk"], args["wv"],
                              compute, lay, ext)
    if name == "moe_manual":
        cfg = moe_config(args["x"].shape[-1], ext.moe_ff)
        p = {"router": args["router"], "wg": args["mwg"],
             "wu": args["mwu"], "wd": args["mwd"]}
        return etp.moe_manual(args["x"], p, cfg, compute, lay)
    return etp.chunked_attn_manual(args["q"], args["k"], args["v"],
                                   causal=True, window=None, lay=lay)


def _every_rank(rec):
    """Every rank's ``rec``, in rank order, on every rank."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, rec)
    return out


def helper_battery(inputs: Dict[str, np.ndarray],
                   none_cases: Dict[str, Dict[str, Dict[str, np.ndarray]]]):
    """Each helper on the ``HELPER_MESH`` rank mesh: every rank takes its
    blocks of the global ``inputs`` (``SPECS``), calls the helper and
    differentiates ``sum(out * cotangent)`` (the cotangent's block of
    ``inputs["cot_<helper>_<i>"]``) with respect to every input it was
    handed (an output the ranks of an axis share weighs 1 / their number
    in each rank's sum, so the ranks' sums add up to the global one).
    Then each case of ``none_cases`` (name -> helper -> its
    global inputs) on the mesh it names, and every helper with no mesh.
    Returns, on rank 0, one record a rank: its coordinate, outputs,
    gradients and the None flags."""
    from ..launch.mesh import set_mesh
    from ..models import explicit_tp as etp

    main = _mesh(HELPER_MESH, "cpu")
    one = _mesh((8, 1), "cpu")
    rec = {"outs": {}, "grads": {}, "aux": None, "none": {}}
    with set_mesh(main) as rm:
        rec["coord"] = dict(rm.coord)
        sizes = dict(rm.sizes)
        for name, (ins, outs) in SPECS.items():
            args = {k: torch.tensor(block(inputs[k], spec, rm.coord, sizes),
                                    requires_grad=True)
                    for k, spec in ins}
            first = inputs[ins[0][0]]
            seq = first.shape[2 if name == "chunked_attn_manual" else 1]
            lay = etp.Layout(first.shape[0], seq, seq_split=True)
            res = _call(name, args, lay,
                        extents({k: inputs[k] for k, _ in ins}))
            if name == "moe_manual":
                res, aux = res
                rec["aux"] = float(aux.detach())
            res = res if isinstance(res, tuple) else (res,)
            # an output the ranks of an axis hold in common counts once
            # over them: each rank weighs its copy by 1 / their number
            loss = sum((r * torch.tensor(block(inputs[f"cot_{name}_{i}"],
                                               spec, rm.coord, sizes))).sum()
                       / _replicas(spec, sizes)
                       for i, (r, spec) in enumerate(zip(res, outs)))
            loss.backward()
            rec["outs"][name] = [r.detach().numpy() for r in res]
            rec["grads"][name] = {k: a.grad.numpy() for k, a in args.items()}
        for case, by_helper in none_cases.items():
            if case == "m=1":
                continue
            rec["none"][case] = _none_flags(by_helper, rm)
    with set_mesh(one) as rm1:
        if "m=1" in none_cases:
            rec["none"]["m=1"] = _none_flags(none_cases["m=1"], rm1)
    rec["none"]["no mesh"] = _none_flags(
        {n: c for c in none_cases.values() for n, c in c.items()}, None)
    return _every_rank(rec)


def _replicas(spec, sizes) -> int:
    """How many ranks hold the same block of an output cut by ``spec``."""
    used = {"data" if e == "rows" else "model" for e in spec if e}
    return int(np.prod([n for a, n in sizes.items() if a not in used]))


def _none_flags(by_helper, rm):
    from ..models import explicit_tp as etp
    flags = {}
    for name, ins in by_helper.items():
        spec_ins = dict(SPECS[name][0])
        if rm is None:
            args = {k: torch.tensor(v) for k, v in ins.items()}
        else:
            # the rank's blocks where the global extents split, else whole
            args = {}
            for k, v in ins.items():
                spec = tuple(e if e is None or v.shape[d] % rm.sizes[
                    "data" if e == "rows" else "model"] == 0 else None
                    for d, e in enumerate(spec_ins[k]))
                args[k] = torch.tensor(block(v, spec, rm.coord, rm.sizes))
        first = ins[SPECS[name][0][0][0]]
        m = 1 if rm is None else rm.sizes["model"]
        seq = first.shape[2 if name == "chunked_attn_manual" else 1]
        lay = etp.Layout(first.shape[0], seq, seq_split=seq % m == 0)
        flags[name] = _call(name, args, lay, extents(ins)) is None
    return flags


# ---------------------------------------------------------------------------
# whole models on the mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelCase:
    """One model forward on a rank mesh: ``arch``'s reduced config with
    ``overrides``, flag on, ``tokens`` (and a ``frontend`` drawn from
    ``seed``), ``full_max`` as ``FULL_SCORES_MAX_LEN`` where set."""

    label: str
    arch: str
    mesh: tuple
    overrides: tuple = ()
    full_max: Optional[int] = None
    seed: int = 0


def model_config(case: ModelCase, flag: bool = True):
    from ..configs import get_config
    return dataclasses.replace(get_config(case.arch).reduced(),
                               explicit_collectives=flag,
                               **dict(case.overrides))


def model_inputs(case: ModelCase, tokens: np.ndarray):
    cfg = model_config(case)
    fe = None
    if cfg.frontend_tokens:
        rng = np.random.default_rng(case.seed + 5)
        fe = (0.5 * rng.standard_normal(
            (tokens.shape[0], cfg.frontend_tokens, cfg.d_model))
              ).astype(np.float32)
    return fe


def model_params(case: ModelCase, cfg):
    """The port's seeded parameters, vlm gates opened to 0.5."""
    from ..models import transformer
    params = transformer.init_params(
        torch.Generator().manual_seed(case.seed), cfg)
    if "cross_layers" in params:
        params["cross_layers"]["gate"].fill_(0.5)
    return params


#: greedy tokens ``DecodeEngine`` draws on the mesh in ``mesh_battery``
DECODE_TOKENS = 6


def model_battery(cases: Sequence[ModelCase], tokens: np.ndarray,
                  ref_params: Optional[Dict[str, dict]] = None):
    """Every case's logits on its mesh (flag on), every rank; with
    ``ref_params[label]`` (a reference parameter tree, numpy) those
    weights, else the port's seeded ones.  Returns on every rank {label:
    {"logits": this rank's, "agree": every rank's logits equal}}."""
    from .. import convert
    from ..launch.mesh import set_mesh
    from ..models import attention, transformer

    out = {}
    meshes = {shape: _mesh(shape, "cpu")
              for shape in sorted({c.mesh for c in cases})}
    keep = attention.FULL_SCORES_MAX_LEN
    for case in cases:
        cfg = model_config(case)
        params = (convert.params_from_reference(ref_params[case.label],
                                                device="cpu")
                  if ref_params and case.label in ref_params
                  else model_params(case, cfg))
        fe = model_inputs(case, tokens)
        attention.FULL_SCORES_MAX_LEN = case.full_max or keep
        try:
            with torch.no_grad(), set_mesh(meshes[case.mesh]):
                logits = transformer.forward(
                    params, torch.tensor(tokens), cfg,
                    frontend=None if fe is None else torch.tensor(fe))[0]
        finally:
            attention.FULL_SCORES_MAX_LEN = keep
        got = _every_rank(logits.numpy())
        out[case.label] = {"logits": got[dist.get_rank()],
                           "agree": all(np.array_equal(g, got[0])
                                        for g in got)}
    return out


def decode_tokens(case: ModelCase, prompts: np.ndarray,
                  n: int = DECODE_TOKENS) -> np.ndarray:
    """``n`` greedy tokens of ``DecodeEngine`` on ``case``'s mesh (the
    port's seeded weights), every rank."""
    from ..launch.mesh import set_mesh
    from ..serve.engine import DecodeEngine, ServeConfig
    cfg = model_config(case)
    eng = DecodeEngine(model_params(case, cfg), cfg,
                       ServeConfig(max_new_tokens=n), device="cpu")
    with set_mesh(_mesh(case.mesh, "cpu")):
        return eng.generate(prompts)[0]


def mesh_battery(inputs, none_cases, cases, tokens, ref_params, decode):
    """The test world: :func:`helper_battery`, :func:`model_battery` and
    :func:`decode_tokens` (on the first half of ``tokens``) in one rank
    world.  Rank 0's results."""
    return {"helpers": helper_battery(inputs, none_cases),
            "models": model_battery(cases, tokens, ref_params),
            "decode": decode_tokens(decode,
                                    tokens[:, :tokens.shape[1] // 2])}
