"""Training step: loss, gradients, AdamW update.

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
The sharded step and its shardings are mesh machinery and raise until
the model-mesh slice.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..configs.base import ModelConfig
from ..models import common, transformer
from ..optim import adamw

#: the message of every mesh entry point here
MESH_SLICE = ("sharded training (state and batch shardings over a mesh) "
              "arrives with the model-mesh slice")


class TrainState(NamedTuple):
    params: Dict[str, Any]
    opt: adamw.OptState


def init_state(gen: torch.Generator, cfg: ModelConfig,
               opt_cfg: adamw.AdamWConfig) -> TrainState:
    """fp32 master parameters drawn from ``gen`` (on its device) and
    zero AdamW state.  The reference also returns the parameters'
    logical sharding axes, which the port has no use for without a
    mesh."""
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
# sharded compilation (the model-mesh slice)
# ---------------------------------------------------------------------------

def state_shardings(*args, **kwargs):
    raise NotImplementedError(MESH_SLICE)


def batch_shardings(*args, **kwargs):
    raise NotImplementedError(MESH_SLICE)


def make_sharded_train_step(*args, **kwargs):
    raise NotImplementedError(MESH_SLICE)
