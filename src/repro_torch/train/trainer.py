"""Training step: loss, gradients, AdamW update — on one device or
placed on a model mesh.

The port of the reference's ``train/trainer.py``.  The reference
differentiates ``transformer.forward`` with ``jax.value_and_grad``; the
port runs the same forward under autograd.  On the card its attention is
the flash kernel and the ssm and hybrid families' scan the SSD kernels,
each with a backward that is a kernel too
(``kernels.flash_attention.FlashAttentionFn``,
``kernels.ssd_scan.SSDScanFn``); every other kernel wrapper raises under
autograd rather than drop gradients (no model's training reaches one).
With ``cfg.remat`` each layer is recomputed in the backward
(``models.transformer``).

The step takes parameter leaves as they are, makes leaf tensors that
require grad of them (``detach``: no copy), and returns new parameters
(``optim.adamw.apply_updates``); the state never holds autograd flags.

**On a mesh.**  The reference jits its step with in/out shardings built
from the parameters' logical axes (``state_shardings``: FSDP over
``data``, tensor parallelism over ``model``, the divisibility fallback,
fp32 moments on their parameters' specs, a Q8 moment's block dimension
over ``data``) and GSPMD inserts the gradient reductions.  PyTorch has
no GSPMD: :func:`make_sharded_train_step` is the port's own step on the
rank model of ``models.explicit_tp`` (one process a mesh position), with
the reference's specs (:func:`state_shardings`, :func:`batch_shardings`,
the port's ``dist.comm_engine.Spec``).  Departures, declared:

* the state is placed (:func:`place_state`): each rank holds only its
  block of every parameter and moment, the step counter replicated;
* every rank receives the global batch and keeps its batch rows (the
  rank model), where the reference hands each device its rows;
* the step all-gathers each parameter over the axes its spec names,
  minor axis first, into whole weights (the models' explicit-TP views
  take their blocks of whole weights), runs forward and backward under
  ``launch.mesh.set_mesh``, sums the gradient partials over every rank
  and keeps the rank's block (:func:`sharded_value_and_grad`); the
  whole weights and gradients are dropped before the update;
* AdamW runs on the rank's blocks; a leaf with Q8 moments updates whole
  on every rank (the 128-element quantization blocks of the flattened
  leaf do not line up with the parameter's block: its moments are
  gathered over ``data``, 1 byte an element, and each rank keeps its
  blocks of the results);
* ``grad_norm`` and the clip read the global gradient with each element
  counted once: a block is counted by the rank at coordinate 0 of every
  axis its spec replicates over, and the squares are summed over every
  rank;
* ``donate=True`` frees each input block's storage once its leaf is
  updated (the reference's donated buffers); the caller's input state is
  then unusable.

**The invariant the gradients rest on.**  Each rank's loss is its *share*
(:func:`rank_loss`), scaled so that the shares summed over all ranks are
the global loss: the cross-entropy of the rank's batch rows times rows /
global rows, divided by the number of ranks that hold those rows (every
rank of the axes that do not split the batch computes them alike), and
the MoE's aux loss (global on every rank: ``moe_manual`` and the
fallback MoE average it over the batch axes) divided by the number of
ranks.  The collectives' backwards are exact adjoints (all-gather <->
reduce-scatter, all-reduce <-> all-reduce), so the program of all ranks
is one function of the replicated weights, and the gradient of the
summed shares with respect to a weight is the sum of every rank's
partial: summing each parameter's partial over all ranks gives the
one-device gradient exactly once.  A loss computed whole on every rank
(the gathered logits' cross-entropy) would count it once a rank.  The
sum is one collective an axis in a fixed order — a reduce-scatter over
each axis the leaf's spec shards it over, then an all_reduce of the
block over the others — so a repeated step gives the same bits.

Gloo ranks that share one card stage every collective through host
memory: no time such ranks give is a mesh's speed.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, NamedTuple, Tuple

import torch

from ..configs.base import ModelConfig
from ..dist.comm_engine import RankMesh, Spec, _axes_of
from ..launch.mesh import current_mesh, set_mesh
from ..models import common, transformer
from ..models import explicit_tp as etp
from ..optim import adamw

class TrainState(NamedTuple):
    params: Dict[str, Any]
    opt: adamw.OptState


def init_state(gen: torch.Generator, cfg: ModelConfig,
               opt_cfg: adamw.AdamWConfig) -> TrainState:
    """fp32 master parameters drawn from ``gen`` (on its device) and
    zero AdamW state.  The reference also returns the parameters'
    logical axes; the port's are ``transformer.param_axes(cfg)``."""
    params = transformer.init_params(gen, cfg)
    return TrainState(params, adamw.init(params, opt_cfg))


def loss_fn(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
            cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``ce + 0.01 * aux`` (the MoE's load-balancing loss) and its parts."""
    logits, aux, _ = transformer.forward(
        params, batch["tokens"], cfg, frontend=batch.get("frontend"))
    ce = common.cross_entropy(logits, batch["targets"])
    loss = ce + 0.01 * aux
    return loss, {"ce": ce, "aux": aux}


def value_and_grad(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
                   cfg: ModelConfig):
    """(loss, parts, grads): :func:`loss_fn` and its gradient with
    respect to every parameter leaf (zeros for a leaf the loss does not
    reach, as ``jax.value_and_grad`` gives)."""
    leaves = adamw.tree_map(lambda p: p.detach().requires_grad_(True),
                            params)
    flat = adamw.tree_leaves(leaves)
    with torch.enable_grad():
        loss, parts = loss_fn(leaves, batch, cfg)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(flat, grads))
    grad_tree = _unflatten(leaves, it)
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            grad_tree)


def _unflatten(like: Dict[str, Any], it) -> Dict[str, Any]:
    """Leaves from ``it`` in ``tree_leaves`` order, in ``like``'s keys."""
    return {k: (_unflatten(like[k], it) if isinstance(like[k], dict)
                else next(it)) for k in sorted(like)}


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig):
    """The single-device train step: ``step(state, batch) -> (state,
    metrics)``, the metrics (``loss``, ``ce``, ``aux``, ``grad_norm``,
    ``lr``) as 0-d tensors on the state's device."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        loss, parts, grads = value_and_grad(state.params, batch, cfg)
        new_params, new_opt, om = adamw.apply_updates(
            state.params, grads, state.opt, opt_cfg)
        metrics = {"loss": loss, **parts, **om}
        return TrainState(new_params, new_opt), metrics

    return step


# ---------------------------------------------------------------------------
# placement on a mesh
# ---------------------------------------------------------------------------

def _mesh_shape(mesh) -> Dict[str, int]:
    """{axis: size} of a ``DeviceMesh``, a ``RankMesh`` or a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    if isinstance(mesh, RankMesh):
        return dict(mesh.sizes)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _rank_mesh(mesh) -> RankMesh:
    return mesh if isinstance(mesh, RankMesh) else RankMesh(mesh)


def state_shardings(state: TrainState, axes: Any, mesh,
                    rules: common.AxisRules = common.DEFAULT_RULES
                    ) -> TrainState:
    """A :class:`Spec` for every leaf of ``state`` (whole leaves, or
    anything with their shapes) from the parameters' logical axes
    (``transformer.param_axes``), the reference's: fp32 moments on their
    parameters' specs; a Q8 moment's ``q`` and ``scale`` with their
    leading block dimension over ``data`` where ``data`` divides it,
    else replicated; the step counter replicated.  ``mesh``: a
    ``DeviceMesh``, a ``RankMesh`` or ``{axis: size}``."""
    mesh_shape = _mesh_shape(mesh)
    pspecs = rules.specs(axes, state.params, mesh_shape)
    d = mesh_shape.get("data", 1)

    def moment_spec(shape) -> Spec:
        if len(shape) >= 1 and shape[0] % max(d, 1) == 0 and d > 1:
            return Spec("data", *([None] * (len(shape) - 1)))
        return Spec(*([None] * len(shape)))

    def moments(mtree, ptree):
        if isinstance(mtree, dict):
            return {k: moments(mtree[k], ptree[k]) for k in mtree}
        if isinstance(mtree, adamw.Q8):
            return adamw.Q8(moment_spec(mtree.q.shape),
                            moment_spec(mtree.scale.shape), mtree.shape)
        return ptree

    return TrainState(pspecs, adamw.OptState(
        Spec(), moments(state.opt.m, pspecs), moments(state.opt.v, pspecs)))


def batch_shardings(mesh, with_frontend: bool = False) -> Dict[str, Spec]:
    """The batch's rows over (``pod``, ``data``), the reference's.  The
    sharded step takes the global batch on every rank and each rank
    keeps these rows (``explicit_tp``'s rank model)."""
    names = _mesh_shape(mesh)
    rows = tuple(a for a in ("pod", "data") if a in names)
    # one axis prints bare, as PartitionSpec normalizes it
    rows = rows[0] if len(rows) == 1 else rows
    out = {"tokens": Spec(rows, None), "targets": Spec(rows, None)}
    if with_frontend:
        out["frontend"] = Spec(rows, None, None)
    return out


def _axes_in(entry, rm: RankMesh) -> Tuple[str, ...]:
    """The mesh axes a spec entry names that the mesh has (an axis it
    lacks has size 1)."""
    return tuple(a for a in _axes_of(entry) if a in rm.sizes)


def _local(x: torch.Tensor, spec: Spec, rm: RankMesh) -> torch.Tensor:
    """This rank's block of the whole ``x`` (a view)."""
    for d, entry in enumerate(spec):
        idx, count = 0, 1
        for a in _axes_in(entry, rm):
            idx, count = idx * rm.sizes[a] + rm.coord[a], count * rm.sizes[a]
        if count > 1:
            step = x.shape[d] // count
            x = x.narrow(d, idx * step, step)
    return x


def _own(x: torch.Tensor, spec: Spec, rm: RankMesh) -> torch.Tensor:
    """This rank's block of ``x`` as a tensor of its own, on the mesh's
    device."""
    return _local(x, spec, rm).to(rm.device, copy=True).contiguous()


def _gather(x: torch.Tensor, spec: Spec, rm: RankMesh) -> torch.Tensor:
    """The whole leaf from every rank's block: each dimension gathered
    over the axes its entry names, minor axis first."""
    for d, entry in enumerate(spec):
        for a in reversed(_axes_in(entry, rm)):
            if rm.sizes[a] > 1:
                x = rm.all_gather(x, a, d)
    return x


def _map(fn, tree, specs):
    """``fn(tensor, spec)`` over a parameter or moment tree (a Q8's
    ``q`` and ``scale`` with their own specs)."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], specs[k]) for k in tree}
    if isinstance(tree, adamw.Q8):
        return adamw.Q8(fn(tree.q, specs.q), fn(tree.scale, specs.scale),
                        tree.shape)
    return fn(tree, specs)


def _map_state(fn, state: TrainState, st_sh: TrainState) -> TrainState:
    return TrainState(_map(fn, state.params, st_sh.params), adamw.OptState(
        fn(state.opt.step, st_sh.opt.step), _map(fn, state.opt.m,
                                                 st_sh.opt.m),
        _map(fn, state.opt.v, st_sh.opt.v)))


def place_tree(tree: Any, specs: Any, mesh) -> Any:
    """This rank's block of every whole leaf of a tree under ``specs``,
    each a tensor of its own on the mesh's device."""
    rm = _rank_mesh(mesh)
    return _map(lambda x, s: _own(x, s, rm), tree, specs)


def place_state(state: TrainState, st_sh: TrainState, mesh) -> TrainState:
    """This rank's block of every leaf of the whole ``state`` under the
    specs ``st_sh`` (from :func:`state_shardings`), each a tensor of its
    own on the mesh's device: the whole state can be freed after."""
    rm = _rank_mesh(mesh)
    return _map_state(lambda x, s: _own(x, s, rm), state, st_sh)


def gather_tree(tree: Any, specs: Any, mesh) -> Any:
    """The whole leaves of a tree of blocks (parameters, gradients or
    moments) under ``specs``, on every rank (collective)."""
    rm = _rank_mesh(mesh)
    return _map(lambda x, s: _gather(x, s, rm), tree, specs)


def gather_state(placed: TrainState, st_sh: TrainState, mesh
                 ) -> TrainState:
    """The whole state on every rank from every rank's blocks (tests and
    checkpoints; collective: every rank of the mesh calls it)."""
    rm = _rank_mesh(mesh)
    return _map_state(lambda x, s: _gather(x, s, rm), placed, st_sh)


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------

def rank_loss(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
              cfg: ModelConfig
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """This rank's share of :func:`loss_fn` under the current mesh (the
    invariant of the module docstring): ``(share, {"ce": its ce share,
    "aux": its aux share})``.  ``params`` whole; ``batch`` global."""
    mesh = current_mesh()
    world = math.prod(mesh.sizes.values())
    tokens = batch["tokens"]
    b = tokens.shape[0]
    x, aux, _ = transformer.forward_hidden(params, tokens, cfg,
                                           frontend=batch.get("frontend"))
    lay = etp.layout_for(b, tokens.shape[1], cfg)
    targets = etp.local_rows(batch["targets"], lay)
    rows = targets.shape[0]
    ce = common.cross_entropy(transformer.logits_from_hidden(params, x, cfg),
                              targets)
    # the ranks that hold these rows: all of them over the axes that do
    # not split the batch
    alike = world * rows // b
    ce = ce * (rows / b) / alike
    aux = aux / world                  # the global aux, on every rank
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def _sum_axes(rm: RankMesh) -> Tuple[str, ...]:
    return tuple(a for a in rm.axes if rm.sizes[a] > 1)


def _sum_block(g: torch.Tensor, spec: Spec, rm: RankMesh) -> torch.Tensor:
    """This rank's block of the sum of every rank's whole partial ``g``:
    a reduce-scatter over each axis the spec shards the leaf over (its
    dimensions in order, an entry's axes major to minor), then an
    all_reduce of the block over the axes that replicate it, in the
    mesh's order: one collective an axis, in a fixed order."""
    used = []
    for d, entry in enumerate(spec):
        for a in _axes_in(entry, rm):
            used.append(a)
            g = rm.reduce_scatter(g, a, d)
    g = rm.psum(g, tuple(a for a in _sum_axes(rm) if a not in used))
    return g.to(rm.device).contiguous()


def sharded_value_and_grad(params: Dict[str, Any],
                           batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                           specs: Dict[str, Any], mesh
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                                      Dict[str, Any]]:
    """(loss, parts, grads) of the global :func:`loss_fn` on a mesh, run
    in every rank: ``params`` are the rank's blocks under ``specs``, the
    batch global; the loss and its parts (``ce``, ``aux``) come back
    global on every rank, the gradients as the rank's blocks of the
    one-device gradient (the partials summed over every rank by
    :func:`_sum_block`).  Call it under ``set_mesh(mesh)``."""
    rm = _rank_mesh(mesh)
    whole = _map(lambda x, s: _gather(x, s, rm).detach().requires_grad_(True),
                 params, specs)
    flat = adamw.tree_leaves(whole)
    with torch.enable_grad():
        share, parts = rank_loss(whole, batch, cfg)
        grads = list(torch.autograd.grad(share, flat, allow_unused=True))
    # the graph's nodes hold the whole leaves: keep none of them
    shares = torch.stack([parts["ce"], parts["aux"]]).detach()
    del whole, share, parts
    blocks = []
    for i, (p, spec) in enumerate(zip(flat, adamw.tree_leaves(specs))):
        g = torch.zeros_like(p) if grads[i] is None else grads[i]
        grads[i] = flat[i] = None      # no whole leaf outlives its turn
        blocks.append(_sum_block(g, spec, rm))
    tot = rm.psum(shares, _sum_axes(rm))
    ce, aux = tot[0], tot[1]
    return (ce + 0.01 * aux, {"ce": ce, "aux": aux},
            _unflatten(specs, iter(blocks)))


def _owner(spec: Spec, rm: RankMesh) -> bool:
    """Whether this rank counts its block of a leaf in the gradient norm:
    coordinate 0 on every axis the spec replicates the leaf over."""
    used = {a for e in spec for a in _axes_in(e, rm)}
    return all(rm.coord[a] == 0 for a in rm.axes if a not in used)


def _free(x: torch.Tensor) -> None:
    x.untyped_storage().resize_(0)


@torch.no_grad()
def sharded_apply_updates(placed: TrainState, grads: Dict[str, Any],
                          st_sh: TrainState, mesh,
                          opt_cfg: adamw.AdamWConfig, donate: bool = False
                          ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One AdamW step on the rank's blocks (``grads`` the rank's blocks
    of the global gradient): the global norm with each element counted
    once, the clip, the update; a leaf with Q8 moments updates whole
    (module docstring).  ``donate`` frees each input block once its
    leaf is updated.  Returns (the new placed state, {grad_norm, lr})."""
    rm = _rank_mesh(mesh)
    pspecs = adamw.tree_leaves(st_sh.params)
    gl = adamw.tree_leaves(grads)
    sq = torch.zeros((), dtype=torch.float32, device=rm.device)
    for g, spec in zip(gl, pspecs):
        if _owner(spec, rm):
            sq = sq + torch.sum(torch.square(g.to(torch.float32)))
    gnorm = torch.sqrt(rm.psum(sq, _sum_axes(rm)))
    sc = adamw.step_scalars(placed.opt.step, gnorm, opt_cfg)

    def whole(q8, s):
        return adamw.Q8(_gather(q8.q, s.q, rm),
                        _gather(q8.scale, s.scale, rm), q8.shape)
    ms, vs = adamw.tree_leaves(placed.opt.m), adamw.tree_leaves(placed.opt.v)
    mspecs = adamw.tree_leaves(st_sh.opt.m)
    vspecs = adamw.tree_leaves(st_sh.opt.v)
    new_p, new_m, new_v = [], [], []
    for i, (p, spec) in enumerate(zip(adamw.tree_leaves(placed.params),
                                      pspecs)):
        g, m, v = gl[i], ms[i], vs[i]
        if isinstance(m, adamw.Q8):
            pn, mn, vn = adamw.update_leaf(
                _gather(p, spec, rm), _gather(g, spec, rm),
                whole(m, mspecs[i]), whole(v, vspecs[i]), sc, opt_cfg)
            pn = _own(pn, spec, rm)
            mn, vn = (_map(lambda x, s: _own(x, s, rm), q8, s)
                      for q8, s in ((mn, mspecs[i]), (vn, vspecs[i])))
        else:
            pn, mn, vn = adamw.update_leaf(p, g, m, v, sc, opt_cfg)
        gl[i] = None
        if donate:
            for x in (p, *((m.q, m.scale, v.q, v.scale)
                           if isinstance(m, adamw.Q8) else (m, v))):
                _free(x)
        new_p.append(pn)
        new_m.append(mn)
        new_v.append(vn)
    opt = adamw.OptState(sc.step, _unflatten(placed.opt.m, iter(new_m)),
                         _unflatten(placed.opt.v, iter(new_v)))
    return (TrainState(_unflatten(placed.params, iter(new_p)), opt),
            {"grad_norm": gnorm, "lr": sc.lr})


def make_sharded_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                            mesh, state: TrainState, axes: Any,
                            rules: common.AxisRules = common.DEFAULT_RULES,
                            donate: bool = True):
    """The train step on ``mesh`` (a ``DeviceMesh``, built on every rank):
    ``(step, st_sh, b_sh)`` as the reference returns them, the specs from
    :func:`state_shardings` (``state``: the whole state, or anything with
    its leaves' shapes) and :func:`batch_shardings`.  ``step(placed,
    batch)`` runs in every rank on the rank's blocks (:func:`place_state`)
    and the global batch and returns (the new placed state, the metrics
    ``loss``, ``ce``, ``aux``, ``grad_norm``, ``lr``: 0-d, equal on every
    rank).  ``donate``: each input block is freed once its leaf is
    updated."""
    st_sh = state_shardings(state, axes, mesh, rules)
    b_sh = batch_shardings(mesh, with_frontend=cfg.family in ("encdec",
                                                              "vlm"))

    def step(placed: TrainState, batch: Dict[str, torch.Tensor]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with set_mesh(mesh) as rm:
            loss, parts, grads = sharded_value_and_grad(
                placed.params, batch, cfg, st_sh.params, rm)
            new, om = sharded_apply_updates(placed, grads, st_sh, rm,
                                            opt_cfg, donate)
        return new, {"loss": loss, **parts, **om}

    return step, st_sh, b_sh
