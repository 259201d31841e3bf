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
from typing import Dict, Sequence

import numpy as np
import torch
import torch.distributed as dist

#: the mesh axes of every case
AXES = ("data", "model")
#: the optimizer of the cases: the train-step parity tests' schedule
OPT = (("warmup_steps", 2), ("total_steps", 10))
#: the models' mesh flags: explicit collectives, sequence-parallel
FLAGS = (("explicit_collectives", True), ("sequence_parallel", True))


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
