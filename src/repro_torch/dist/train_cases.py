"""Train cases on a model mesh: rank functions for ``train.trainer``'s
sharded step, run by ``dist.spawn.run_ranks`` in every rank.

The tests (``tests/test_torch_train_mesh.py``), the selftest
(``python -m repro_torch.dist.train_selftest``) and ``chip_smoke.py``
describe what to run as plain data (:class:`TrainCase`); these functions
live in the package because spawned children re-import them by name.
Every rank draws the same seeded parameters and batches, so a case needs
no arrays on the wire.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

#: the mesh axes of every case
AXES = ("data", "model")
#: the optimizer of the cases: the train-step parity tests' schedule
OPT = (("warmup_steps", 2), ("total_steps", 10))
#: the models' mesh flags: explicit collectives, sequence-parallel
FLAGS = (("explicit_collectives", True), ("sequence_parallel", True))
#: the elastic run: total steps, checkpoint interval, failure step
ELASTIC_RUN = (6, 2, 3)


@dataclasses.dataclass(frozen=True)
class TrainCase:
    """One sharded training run: ``arch``'s reduced config with
    ``overrides`` on a ``mesh`` (``data``, ``model``), AdamW with
    ``bits``-bit moments, the gradient of the first batch, then
    ``steps`` steps.  ``planted``: the loss counted whole on every rank
    (a fault the gradient check must catch)."""

    label: str
    arch: str
    mesh: tuple = (2, 4)
    overrides: tuple = FLAGS
    bits: int = 32
    steps: int = 3
    planted: bool = False
    seq: int = 32
    batch: int = 4


def case_config(case: TrainCase):
    from ..configs import get_config
    return dataclasses.replace(get_config(case.arch).reduced(),
                               **dict(case.overrides))


def opt_config(case: TrainCase):
    from ..optim import adamw
    return adamw.AdamWConfig(**dict(OPT), state_bits=case.bits)


def case_batch(case: TrainCase, cfg, step: int) -> Dict[str, np.ndarray]:
    """The synthetic batch of ``step``; encdec and vlm also get
    ``TrainDriver``'s frontend stub."""
    from ..data import pipeline
    out = pipeline._batch_numpy(pipeline.DataConfig(
        vocab=cfg.vocab, seq_len=case.seq, global_batch=case.batch), step)
    if cfg.family in ("encdec", "vlm"):
        out["frontend"] = pipeline.frontend_stub(
            case.batch, cfg.frontend_tokens, cfg.d_model, step=0, seed=0)
    return out


def case_state(case: TrainCase, cfg):
    """The port's seeded train state (seed 0, on the CPU), the vlm's
    cross gates opened to 0.5 (at 0 the cross layers get no
    gradient)."""
    from ..train import trainer
    state = trainer.init_state(torch.Generator().manual_seed(0), cfg,
                               opt_config(case))
    if "cross_layers" in state.params:
        state.params["cross_layers"]["gate"].fill_(0.5)
    return state


def flat(tree, prefix="") -> Dict[str, np.ndarray]:
    """{path: numpy} of a nested dict of tensors, sorted key order."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree.detach().cpu().numpy()}


def _tensors(b: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in b.items()}


def _metrics(m) -> Dict[str, float]:
    return {k: float(v) for k, v in m.items()}


def one_device(case: TrainCase) -> dict:
    """The port's one-device step on ``case``: the first batch's loss and
    gradients, each step's metrics, the parameters after ``steps``."""
    from ..train import trainer
    cfg = case_config(case)
    state = case_state(case, cfg)
    loss, _, grads = trainer.value_and_grad(
        state.params, _tensors(case_batch(case, cfg, 0), "cpu"), cfg)
    step = trainer.make_train_step(cfg, opt_config(case))
    metrics = []
    for i in range(case.steps):
        state, m = step(state, _tensors(case_batch(case, cfg, i), "cpu"))
        metrics.append(_metrics(m))
    return {"loss0": float(loss), "grads0": flat(grads),
            "metrics": metrics, "params": flat(state.params)}


def whole_loss(params, batch, cfg):
    """The planted fault: the loss on the gathered logits, counted whole
    on every rank."""
    from ..train import trainer
    return trainer.loss_fn(params, batch, cfg)


def sharded(case: TrainCase, mesh, device="cpu") -> dict:
    """``case`` on ``mesh`` in this rank: the first batch's loss and
    gathered gradients (``sharded_value_and_grad``), then ``steps`` steps
    of ``make_sharded_train_step`` (donating) from the placed state, the
    gathered parameters after them and whether every rank holds the same
    whole state (replicated blocks stayed equal)."""
    from ..launch.mesh import set_mesh
    from ..models import transformer
    from ..train import trainer
    cfg = case_config(case)
    state = case_state(case, cfg)
    step, st_sh, _ = trainer.make_sharded_train_step(
        cfg, opt_config(case), mesh, state, transformer.param_axes(cfg))
    placed = trainer.place_state(state, st_sh, mesh)
    del state
    real = trainer.rank_loss
    if case.planted:
        trainer.rank_loss = whole_loss
    try:
        with set_mesh(mesh) as rm:
            loss, _, grads = trainer.sharded_value_and_grad(
                placed.params, _tensors(case_batch(case, cfg, 0), device),
                cfg, st_sh.params, rm)
            grads = trainer.gather_tree(grads, st_sh.params, rm)
    finally:
        trainer.rank_loss = real
    out = {"loss0": float(loss), "grads0": flat(grads), "metrics": []}
    for i in range(case.steps):
        placed, m = step(placed, _tensors(case_batch(case, cfg, i), device))
        out["metrics"].append(_metrics(m))
    whole = trainer.gather_state(placed, st_sh, mesh)
    out["params"] = flat(whole.params)
    digest = hashlib.sha256()
    for tree in (whole.params, whole.opt.m, whole.opt.v):
        for a in _leaf_arrays(tree):
            digest.update(a.tobytes())
    digests = [None] * dist.get_world_size()
    dist.all_gather_object(digests, digest.hexdigest())
    out["agree"] = len(set(digests)) == 1
    return out


def seeded_grads(params, step: int, scale: float = 1e-3):
    """A gradient tree of ``params``' shapes drawn from ``step`` (global
    norm below 1, so the clip factor is exactly 1)."""
    from ..optim import adamw
    gen = torch.Generator().manual_seed(1000 + step)
    return adamw.tree_map(lambda p: scale * torch.randn(
        p.shape, generator=gen) / p.numel() ** 0.5, params)


def updates(case: TrainCase, mesh=None, steps: int = 3) -> dict:
    """``steps`` AdamW updates fed :func:`seeded_grads`: one device
    (``mesh`` None: ``adamw.apply_updates`` on the whole state) or the
    sharded update on the rank's blocks (``sharded_apply_updates``),
    gathered.  Returns every leaf of the state as numpy."""
    from ..optim import adamw
    from ..train import trainer
    cfg = case_config(case)
    state = case_state(case, cfg)
    if mesh is None:
        for i in range(steps):
            params, opt, _ = adamw.apply_updates(
                state.params, seeded_grads(state.params, i), state.opt,
                opt_config(case))
            state = trainer.TrainState(params, opt)
    else:
        from ..models import transformer
        st_sh = trainer.state_shardings(state, transformer.param_axes(cfg),
                                        mesh)
        placed = trainer.place_state(state, st_sh, mesh)
        for i in range(steps):
            blocks = trainer.place_tree(seeded_grads(state.params, i),
                                        st_sh.params, mesh)
            placed, _ = trainer.sharded_apply_updates(
                placed, blocks, st_sh, mesh, opt_config(case), donate=True)
        state = trainer.gather_state(placed, st_sh, mesh)
    return {"params": flat(state.params),
            "moments": [a for tree in (state.opt.m, state.opt.v)
                        for a in _leaf_arrays(tree)]}


def _leaf_arrays(tree):
    from ..optim import adamw
    for leaf in adamw.tree_leaves(tree):
        parts = (leaf.q, leaf.scale) if isinstance(leaf, adamw.Q8) else (
            leaf,)
        for t in parts:
            yield t.detach().cpu().numpy()


def _mesh(shape, device="cpu", backend=None):
    from ..launch.mesh import make_mesh
    return make_mesh(shape, AXES, device=device, backend=backend)


def train_battery(cases: Sequence[TrainCase]) -> Dict[str, dict]:
    """Every case on its mesh (every rank builds every mesh first);
    rank 0's records by label."""
    meshes = {shape: _mesh(shape) for shape in sorted({c.mesh
                                                       for c in cases})}
    out = {c.label: sharded(c, meshes[c.mesh]) for c in cases}
    for c in cases:
        if c.bits == 8:
            out[f"updates/{c.label}"] = updates(c, meshes[c.mesh])
    return out


# ---------------------------------------------------------------------------
# elastic training: checkpoints across mesh shapes, the driver on a mesh
# ---------------------------------------------------------------------------

def ckpt_arrays(ckpt_dir: str, step=None) -> Dict[str, np.ndarray]:
    """Every array of a checkpoint (the latest without ``step``)."""
    import os

    from ..checkpoint import store
    step = store.latest_step(ckpt_dir) if step is None else step
    with np.load(os.path.join(ckpt_dir, f"step_{step:08d}",
                              "arrays.npz")) as data:
        return {k: data[k] for k in data.files}


def filled_state(case: TrainCase, cfg, seed: int = 5):
    """:func:`case_state` with seeded nonzero moments (Q8 codes and
    scales too) and step counter ``seed``: a checkpoint of it tells
    every element's place."""
    from ..optim import adamw
    from ..train import trainer
    state = case_state(case, cfg)
    gen = torch.Generator().manual_seed(seed)

    def fill(x):
        if isinstance(x, adamw.Q8):
            return adamw.Q8(torch.randint(-127, 128, x.q.shape, generator=gen,
                                          dtype=torch.int8),
                            torch.rand(x.scale.shape, generator=gen) + 0.5,
                            x.shape)
        return torch.randn(x.shape, generator=gen)
    opt = adamw.OptState(torch.tensor(seed, dtype=torch.int32),
                         adamw.tree_map(fill, state.opt.m),
                         adamw.tree_map(fill, state.opt.v))
    return trainer.TrainState(state.params, opt)


def block_mismatches(tree, specs, mesh, arrays) -> list:
    """The leaf paths where this rank's block of ``tree`` (placed under
    ``specs`` on ``mesh``) is not bit for bit its block of the logical
    ``arrays`` (a checkpoint's, by the checkpoint's key strings)."""
    from ..checkpoint import store
    from ..models import placed
    rm = placed.rank_mesh(mesh)
    bad = []
    for (key, leaf), (_, spec) in zip(store._paths(tree),
                                      store._paths(specs)):
        want = placed.local(torch.from_numpy(arrays[key]), spec, rm)
        got = leaf.detach().cpu()
        if got.shape != want.shape or not torch.equal(got,
                                                      want.to(got.dtype)):
            bad.append(key)
    return bad


def state_digest(tree, specs=None, mesh=None) -> Optional[str]:
    """A sha256 of every leaf's bytes in checkpoint order, the leaves
    whole.  A placed ``tree`` (with ``specs`` and ``mesh``) is gathered
    as a checkpoint gathers it (collective): the digest is the writing
    rank's, None on the others."""
    from ..checkpoint import store
    from ..models import placed
    if mesh is not None:
        flat = store._gathered(tree, specs, placed.rank_mesh(mesh))
        if not flat:
            return None
    else:
        flat = store._flatten_with_paths(tree)
    digest = hashlib.sha256()
    for key in sorted(flat):
        digest.update(key.encode())
        digest.update(flat[key].tobytes())
    return digest.hexdigest()


def place_arrays(like, specs, mesh, arrays):
    """This rank's blocks of a checkpoint's ``arrays`` under ``specs``,
    shaped as ``like``: the placement ``store.restore(shardings=)``
    makes, from arrays already read."""
    from ..checkpoint import store
    from ..models import placed
    return store._rebuild(like, arrays, "", specs, placed.rank_mesh(mesh))


def permuted(mesh):
    """This rank's ``RankMesh`` with its coordinate reversed on every
    axis: blocks placed through it sit at another rank's coordinate (a
    planted fault for the block checks)."""
    import copy

    from ..models import placed
    rm = copy.copy(placed.rank_mesh(mesh))
    rm.coord = {a: rm.sizes[a] - 1 - c for a, c in rm.coord.items()}
    return rm


def _gathered_objects(obj) -> list:
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _run_cfg(ckpt_dir: str, total: int, every: int):
    from ..runtime.driver import RunConfig
    return RunConfig(total_steps=total, ckpt_every=every, ckpt_dir=ckpt_dir,
                     log_every=1)


def _data_cfg(case: TrainCase, cfg):
    from ..data.pipeline import DataConfig
    return DataConfig(vocab=cfg.vocab, seq_len=case.seq,
                      global_batch=case.batch)


def elastic_restore(case: TrainCase, ckpt_dir: str, meshes: dict) -> dict:
    """Elastic restore in every rank: ``case``'s seeded state placed on
    ``meshes["2x4"]`` and saved (gathered, one rank writing) at step 1,
    then restored onto every other mesh of ``meshes`` (a mesh of some of
    the ranks leaves the rest idle) and onto one device.  Returns every
    rank's records: whether the saved arrays are the state's bit for
    bit, and for each target the leaves whose block differs from the
    logical array's block ("idle" off the mesh); also the same restore
    at permuted coordinates (a planted fault: must differ)."""
    from ..checkpoint import store
    from ..launch.specs import _MetaGenerator
    from ..models import transformer
    from ..train import trainer
    cfg = case_config(case)
    state = filled_state(case, cfg)
    axes = transformer.param_axes(cfg)
    src = meshes["2x4"]
    st_sh = trainer.state_shardings(state, axes, src)
    store.save(ckpt_dir, 1, trainer.place_state(state, st_sh, src),
               specs=st_sh, mesh=src)
    arrays = ckpt_arrays(ckpt_dir, 1)
    rec = {"saved": sorted(k for k, v in store._flatten_with_paths(
        state).items() if not np.array_equal(v, arrays[k]))}
    struct = trainer.init_state(_MetaGenerator(), cfg, opt_config(case))
    for name, mesh in meshes.items():
        sh = trainer.state_shardings(state, axes, mesh)
        # whole leaves, meta stand-ins and placed blocks all restore
        like = {"4x2": struct, "1x8": state}.get(name)
        if like is None:
            like = (trainer.place_state(state, sh, mesh)
                    if mesh.get_coordinate() is not None else struct)
        got, _, _ = store.restore(ckpt_dir, like, shardings=sh, mesh=mesh)
        rec[name] = ("idle" if got is None
                     else block_mismatches(got, sh, mesh, arrays))
        if name == "2x4":
            fault = place_arrays(state, sh, permuted(mesh), arrays)
            rec["permuted"] = block_mismatches(fault, sh, mesh, arrays)
    whole, _, _ = store.restore(ckpt_dir, state)
    rec["one device"] = sorted(k for k, v in store._flatten_with_paths(
        whole).items() if not np.array_equal(v, arrays[k]))
    return rec


def restore_foreign(case: TrainCase, ckpt_dir: str, mesh) -> list:
    """Restore another package's checkpoint onto ``mesh`` under the
    port's specs; the leaves whose block differs from the file's."""
    from ..checkpoint import store
    from ..models import transformer
    from ..train import trainer
    cfg = case_config(case)
    state = case_state(case, cfg)
    sh = trainer.state_shardings(state, transformer.param_axes(cfg), mesh)
    got, _, _ = store.restore(ckpt_dir, state, shardings=sh, mesh=mesh)
    return block_mismatches(got, sh, mesh, ckpt_arrays(ckpt_dir))


def elastic_run(case: TrainCase, ckpt_dir: str, meshes: Sequence,
                total: int, every: int, fail_at: int) -> dict:
    """``TrainDriver`` on ``meshes[0]`` with a failure at step
    ``fail_at``, restarted by ``run_with_restarts`` onto ``meshes[1]``
    (every rank fails at the same step).  Returns each driver's logged
    metrics, the restarted driver's start step, the blocks it restored
    that differ from the checkpoint's, and the restart count."""
    from ..runtime.driver import TrainDriver, run_with_restarts
    cfg = case_config(case)
    drivers, restored = [], None

    def make():
        nonlocal restored
        mesh = meshes[len(drivers)]
        d = TrainDriver(cfg, opt_config(case), _data_cfg(case, cfg),
                        _run_cfg(ckpt_dir, total, every), mesh=mesh,
                        failure_at=fail_at if not drivers else None)
        if d.start_step:
            restored = block_mismatches(d.state, d.state_sh, mesh,
                                        ckpt_arrays(ckpt_dir, d.start_step))
        drivers.append(d)
        return d

    out = run_with_restarts(make)
    return {"metrics": [d.metrics_log for d in drivers],
            "start_step": drivers[-1].start_step, "restored": restored,
            "restarts": out["restarts"], "final_step": out["final_step"]}


def mesh_driver_run(case: TrainCase, ckpt_dir: str, mesh,
                    total: int) -> dict:
    """``TrainDriver`` on ``mesh`` from the checkpoint in ``ckpt_dir``,
    ``total`` steps: its start step and logged metrics."""
    from ..runtime.driver import TrainDriver
    cfg = case_config(case)
    d = TrainDriver(cfg, opt_config(case), _data_cfg(case, cfg),
                    _run_cfg(ckpt_dir, total, 100), mesh=mesh)
    start = d.start_step
    out = d.run()
    return {"start_step": start, "metrics": out["metrics"]}


def one_device_run(case: TrainCase, ckpt_dir: str, total: int) -> dict:
    """The uninterrupted one-device ``TrainDriver`` run (on the CPU) that
    the elastic runs are held to."""
    from ..runtime.driver import TrainDriver
    cfg = case_config(case)
    d = TrainDriver(cfg, opt_config(case), _data_cfg(case, cfg),
                    _run_cfg(ckpt_dir, total, 100), device="cpu")
    return {"metrics": d.run()["metrics"]}


def reshard(case: TrainCase, ckpt_dir: str, src: tuple, dst: tuple,
            device="cpu", backend=None) -> list:
    """In every rank: ``case``'s filled state placed on a ``src`` mesh of
    ``device`` and saved, then restored onto a ``dst`` mesh; every
    rank's (leaves off their block, devices of the restored leaves)."""
    from ..checkpoint import store
    from ..launch.specs import _MetaGenerator
    from ..models import transformer
    from ..optim import adamw
    from ..train import trainer
    cfg = case_config(case)
    state = filled_state(case, cfg)
    axes = transformer.param_axes(cfg)
    meshes = [_mesh(s, device, backend) for s in (src, dst)]
    sh = [trainer.state_shardings(state, axes, m) for m in meshes]
    store.save(ckpt_dir, 1, trainer.place_state(state, sh[0], meshes[0]),
               specs=sh[0], mesh=meshes[0])
    struct = trainer.init_state(_MetaGenerator(), cfg, opt_config(case))
    got, _, _ = store.restore(ckpt_dir, struct, shardings=sh[1],
                              mesh=meshes[1])
    devices = sorted({str(x.device) for x in adamw.tree_leaves(got.params)})
    return _gathered_objects((block_mismatches(got, sh[1], meshes[1],
                                               ckpt_arrays(ckpt_dir, 1)),
                              devices))


def elastic_battery(spec: dict) -> dict:
    """The elastic cases in every rank of an 8-rank world; every rank's
    records on rank 0.  ``spec``: ``root`` (a directory the cases write
    under), ``foreign`` ({label: another package's checkpoint directory}
    restored onto 2x4), ``seeded`` (a directory holding a checkpoint of
    the seeded state, which the mesh driver resumes from for
    ``driver_steps`` steps) and ``steps`` (the elastic run's total,
    checkpoint interval and failure step)."""
    import os
    meshes = {"2x4": _mesh((2, 4)), "4x2": _mesh((4, 2)),
              "1x8": _mesh((1, 8)), "2x2": _mesh((2, 2))}
    rec = {"rank": dist.get_rank()}
    for bits in (32, 8):
        case = TrainCase(f"elastic/{bits}", "granite-8b", bits=bits)
        rec[f"restore/{bits}"] = elastic_restore(
            case, os.path.join(spec["root"], f"mesh{bits}"), meshes)
    rec["foreign"] = {
        label: restore_foreign(TrainCase(label, "granite-8b", bits=bits),
                               d, meshes["2x4"])
        for label, (d, bits) in spec["foreign"].items()}
    total, every, fail_at = spec["steps"]
    rec["run"] = elastic_run(
        TrainCase("run", "granite-8b"), os.path.join(spec["root"], "run"),
        (meshes["2x4"], meshes["4x2"]), total, every, fail_at)
    rec["driver"] = mesh_driver_run(TrainCase("driver", "granite-8b"),
                                    spec["seeded"], meshes["2x4"],
                                    spec["driver_steps"])
    return _gathered_objects(rec)


def selftest_battery(cases: Sequence[TrainCase], root: str) -> dict:
    """:func:`train_battery`, then the elastic run of reduced granite-8b
    (2x4, a failure, 4x2) into ``root``; its records from every rank
    under ``"elastic"``."""
    out = train_battery(cases)
    out["elastic"] = _gathered_objects(elastic_run(
        TrainCase("elastic", "granite-8b"), root,
        (_mesh((2, 4)), _mesh((4, 2))), *ELASTIC_RUN))
    return out


def launch_train_on_mesh(argv: Sequence[str]) -> dict:
    """``launch.train.main(argv)`` in every rank of a 4-rank world, the
    production mesh swapped for a 2x2 one and the config reduced: the
    command line's mesh path at a size the CPU takes."""
    import contextlib
    import io

    from .. import configs
    from ..launch import mesh as mesh_mod
    from ..launch import train as launch_train
    real_mesh, real_cfg = mesh_mod.make_production_mesh, configs.get_config

    def small_mesh(*, multi_pod=False, device=None, backend=None):
        return mesh_mod.make_mesh((2, 2), AXES, device=device,
                                  backend=backend)
    mesh_mod.make_production_mesh = small_mesh
    configs.get_config = lambda arch: real_cfg(arch).reduced()
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            out = launch_train.main(list(argv))
    finally:
        mesh_mod.make_production_mesh = real_mesh
        configs.get_config = real_cfg
    return _gathered_objects({"rank": dist.get_rank(),
                              "final_step": out["final_step"],
                              "losses": [m["loss"] for m in out["metrics"]],
                              "printed": printed.getvalue()})


# ---------------------------------------------------------------------------
# the step on blocks: the gather's backward, the whole-gather yardstick,
# the gathered bytes alive under remat
# ---------------------------------------------------------------------------

#: a model of each family
FAMILY_ARCHS = (("dense", "h2o-danube-1.8b"), ("moe", "mixtral-8x22b"),
                ("ssm", "mamba2-370m"), ("hybrid", "zamba2-1.2b"),
                ("encdec", "whisper-small"),
                ("vlm", "llama-3.2-vision-11b"))
#: the stacked subtrees of a parameter tree (a leading layer dim)
STACKED = ("layers", "encoder", "cross_layers")


def gather_cases(params, cfg):
    """(name, block, gather spec, keep) of every gather a model makes on
    the placed tree ``params``: layer 0 of each stacked leaf and each
    unstacked leaf over its spec, the embedding table over its embed
    axes and the output projection, each keeping its vocab axes."""
    from ..checkpoint import store
    from ..dist.comm_engine import Spec
    from ..models import placed
    rm = params.mesh
    out = []
    for path, block in store._paths(dict(params)):
        spec = placed._at(params.specs, path.split("/"))
        if path.split("/")[0] in STACKED:
            block, spec = block[0], Spec(*spec[1:])
        out.append((path, block, spec, ()))
    v_entry, e_entry = params.specs["embed"]
    vocab = placed.axes_in(v_entry, rm)
    out.append(("embed table", params["embed"], Spec(None, e_entry), vocab))
    if cfg.tie_embeddings:
        out.append(("tied projection", params["embed"].T,
                    Spec(e_entry, None), vocab))
    else:
        e_entry, v_entry = params.specs["unembed"]
        out.append(("projection", params["unembed"], Spec(e_entry, None),
                    placed.axes_in(v_entry, rm)))
    return out


def _coords(mesh) -> Dict[int, Dict[str, int]]:
    """{rank: {axis: coordinate}} of every rank of ``mesh``."""
    import itertools
    grid = mesh.mesh
    return {int(grid[idx]): dict(zip(mesh.mesh_dim_names, idx))
            for idx in itertools.product(*(range(n) for n in grid.shape))}


def _cotangent(shape, case: int, rank: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(7919 * case + rank)
    return torch.randn(shape, generator=gen)


def gather_backward(mesh, fault=None) -> Dict[str, float]:
    """``placed.GatherLeaf``'s block gradient for every gather of every
    family's reduced model placed on ``mesh`` (:func:`gather_cases`),
    each rank's cotangent drawn from its rank: ``{"sum_block": the
    largest difference from placed.sum_block of this rank's cotangent,
    "sum": the largest difference x max|want| from the block of every
    rank's cotangent summed here, rank by rank}``.  ``fault(sum_block)``
    replaces ``placed.sum_block`` for the run (a planted fault)."""
    from ..configs import get_config
    from ..dist.comm_engine import RankMesh
    from ..models import placed, transformer
    rm, coords = RankMesh(mesh), _coords(mesh)
    real = placed.sum_block
    worst = {"sum_block": 0.0, "sum": 0.0}
    for fam, arch in FAMILY_ARCHS:
        cfg = get_config(arch).reduced()
        params = placed.place_params(transformer.init_params(
            torch.Generator().manual_seed(0), cfg), cfg, rm)
        for i, (name, block, spec, keep) in enumerate(
                gather_cases(params, cfg)):
            x = block.detach().requires_grad_(True)
            if fault is not None:
                placed.sum_block = fault(real)
            try:
                out = placed.GatherLeaf.apply(x, spec, rm, keep)
                g = _cotangent(out.shape, i, dist.get_rank())
                got, = torch.autograd.grad(out, x, g)
            finally:
                placed.sum_block = real
            same = placed.sum_block(g, spec, rm, keep)
            worst["sum_block"] = max(worst["sum_block"], float(
                (got - same).abs().max()))
            mine = rm.coord
            total = sum(_cotangent(out.shape, i, r) for r, c in
                        coords.items() if all(c[a] == mine[a] for a in keep))
            want = placed.local(total, spec, rm)
            worst["sum"] = max(worst["sum"], float(
                (got - want).abs().max() / want.abs().max()))
    return worst


def no_replica_sum(real):
    """A planted fault: ``placed.sum_block`` (``real``) without its
    all_reduce over the axes that replicate the block."""
    return lambda g, spec, rm, keep=(): real(g, spec, rm, tuple(rm.axes))


def keep_ignored(real):
    """A planted fault: ``placed.sum_block`` (``real``) summing over the
    axes a partial gather keeps split."""
    return lambda g, spec, rm, keep=(): real(g, spec, rm)


def whole_gather_grads(blocks, batch, cfg, specs, rm) -> list:
    """The yardstick of the step on blocks: every leaf gathered whole
    before the forward, :func:`trainer.rank_loss` differentiated on the
    whole tree, each whole partial summed onto the rank's block
    (``placed.sum_block``); the blocks in ``tree_leaves`` order."""
    from ..models import placed
    from ..optim import adamw
    from ..train import trainer
    whole = trainer._map(lambda x, s: placed.gather(x, s, rm).detach()
                         .requires_grad_(True), blocks, specs)
    flat = adamw.tree_leaves(whole)
    with torch.enable_grad():
        share, _ = trainer.rank_loss(whole, batch, cfg)
        grads = torch.autograd.grad(share, flat, allow_unused=True)
    return [placed.sum_block(torch.zeros_like(p) if g is None else g, s, rm)
            for p, g, s in zip(flat, grads, adamw.tree_leaves(specs))]


class PlainPsum:
    """A planted fault: the embedding rows summed over the vocab axes by
    the plain all_reduce (``RankMesh.psum``), which autograd does not
    see, in place of ``placed._AllReduce``."""

    @staticmethod
    def apply(x, rm, axes):
        return rm.psum(x, axes)


def _placed_cfg(arch: str, **kw):
    from ..configs import get_config
    return dataclasses.replace(get_config(arch).reduced(), **dict(FLAGS),
                               **kw)


def step_against_whole_gather(arch: str, mesh, planted: bool = False,
                              **kw) -> Dict[str, float]:
    """``trainer.sharded_value_and_grad`` on ``arch``'s reduced model on
    ``mesh`` (fp32) against :func:`whole_gather_grads`: {leaf path: the
    largest difference in this rank's block x the whole leaf's max|g|}
    (every rank of the world on ``mesh``).  ``planted``: the
    embedding's sum through :class:`PlainPsum`."""
    from ..checkpoint import store
    from ..launch.mesh import set_mesh
    from ..models import placed, transformer
    from ..optim import adamw
    from ..train import trainer
    cfg = _placed_cfg(arch, **kw)
    state = trainer.init_state(torch.Generator().manual_seed(0), cfg,
                               adamw.AdamWConfig())
    if "cross_layers" in state.params:
        state.params["cross_layers"]["gate"].fill_(0.5)
    st_sh = trainer.state_shardings(state, transformer.param_axes(cfg), mesh)
    blocks = trainer.place_tree(state.params, st_sh.params, mesh)
    case = TrainCase(arch, arch)
    batch = _tensors(case_batch(case, cfg, 0), "cpu")
    real = placed._AllReduce
    with set_mesh(mesh) as rm:
        want = whole_gather_grads(blocks, batch, cfg, st_sh.params, rm)
        if planted:
            placed._AllReduce = PlainPsum
        try:
            _, _, got = trainer.sharded_value_and_grad(
                blocks, batch, cfg, st_sh.params, rm)
        finally:
            placed._AllReduce = real
    # max|g| of each whole leaf: the largest of the ranks' blocks
    scale = torch.stack([w.abs().max() for w in want])
    dist.all_reduce(scale, op=dist.ReduceOp.MAX)
    return {p: float((g - w).abs().max() / max(float(m), 1e-30))
            for (p, _), g, w, m in zip(store._paths(blocks),
                                       adamw.tree_leaves(got), want, scale)}


def gather_outside(real):
    """A planted fault: ``transformer._run`` with the block's weights
    gathered before the checkpoint, which then keeps them alive until
    the backward."""
    def run(block, cfg, weights, *a, **k):
        w = weights()
        return real(block, cfg, lambda: w, *a, **k)
    return run


def remat_gathered_bytes(arch: str, mesh, depth: int = 4,
                         planted: bool = False) -> Dict[str, int]:
    """The most gathered bytes alive at once (``placed.GATHERED``) in one
    ``sharded_value_and_grad`` of ``arch``'s reduced model at ``depth``
    layers (an encoder of as many) with remat on, beside one layer's
    bytes as the rank gathers them (``placed.held_bytes``: whole over the
    batch axes, its ``model`` block of each leaf; the largest of any
    stack's) and the unstacked leaves' alike.  ``planted``:
    :func:`gather_outside`."""
    from ..launch.mesh import set_mesh
    from ..models import placed, transformer
    from ..optim import adamw
    from ..train import trainer
    base = _placed_cfg(arch)
    kw = {"n_layers": depth, "remat": True}
    if base.n_enc_layers:
        kw["n_enc_layers"] = depth
    cfg = dataclasses.replace(base, **kw)
    state = trainer.init_state(torch.Generator().manual_seed(0), cfg,
                               adamw.AdamWConfig())
    st_sh = trainer.state_shardings(state, transformer.param_axes(cfg), mesh)
    blocks = trainer.place_tree(state.params, st_sh.params, mesh)
    layer, unstacked = 0, 0
    for key, sub in state.params.items():
        n = placed.held_bytes(sub, st_sh.params[key], mesh)
        if key in STACKED:
            layer = max(layer, n // adamw.tree_leaves(sub)[0].shape[0])
        else:
            unstacked += n
    batch = _tensors(case_batch(TrainCase(arch, arch), cfg, 0), "cpu")
    real = transformer._run
    with set_mesh(mesh) as rm:
        if planted:
            transformer._run = gather_outside(real)
        try:
            placed.GATHERED.reset()
            trainer.sharded_value_and_grad(blocks, batch, cfg, st_sh.params,
                                           rm)
        finally:
            transformer._run = real
    return {"peak": placed.GATHERED.peak, "layer": layer,
            "unstacked": unstacked}


def placed_step_battery(spec: dict) -> dict:
    """The step-on-blocks checks in every rank of an 8-rank world (2x4,
    1x8, and 2x2 with ranks 4-7 idle); every rank's records on rank 0.
    ``spec``: ``grads`` (mesh names the families' gradients run on),
    ``remat`` (mesh names the remat bytes run on)."""
    meshes = {"2x4": _mesh((2, 4)), "1x8": _mesh((1, 8)),
              "2x2": _mesh((2, 2))}
    rec = {"rank": dist.get_rank()}
    for name, mesh in meshes.items():
        if mesh.get_coordinate() is None:
            continue
        rec[f"gather/{name}"] = gather_backward(mesh)
        if name == "2x4":
            for fault in (no_replica_sum, keep_ignored):
                rec[f"gather/{name}/{fault.__name__}"] = gather_backward(
                    mesh, fault)
        for fam, arch in FAMILY_ARCHS:
            if name in spec["grads"]:
                rec[f"grads/{name}/{fam}"] = step_against_whole_gather(
                    arch, mesh)
            if name in spec["remat"]:
                for planted in (False, True):
                    rec[f"remat/{name}/{fam}/{planted}"] = (
                        remat_gathered_bytes(arch, mesh, planted=planted))
        if name == "2x4":
            rec["grads/2x4/planted"] = step_against_whole_gather(
                FAMILY_ARCHS[0][1], mesh, planted=True)
    return _gathered_objects(rec)
