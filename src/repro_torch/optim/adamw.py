"""AdamW with global-norm clipping, a cosine schedule, and an 8-bit
(block-quantized) optimizer-state option.

The port of the reference's ``optim/adamw.py``.  Parameters, gradients
and moments are nested dicts of tensors with the same keys; a moment
leaf is an fp32 tensor, or with ``state_bits=8`` a :class:`Q8` (int8
codes and one fp32 scale for every 128 elements, about 2.06 bytes a
parameter instead of 8).  The arithmetic is the reference's, in fp32
tensor ops on the parameters' device, so the schedule, the bias
corrections and the Q8 codes (``torch.round`` rounds half to even, as
``jnp.round`` does) come out as there.  ``apply_updates`` runs under
``torch.no_grad()`` and returns new tensors: the parameters autograd saw
are not edited in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    state_bits: int = 32            # 32 or 8


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_frac`` (fp32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(
        math.pi * t))
    return cfg.lr * warm * cos


# ---------------------------------------------------------------------------
# 8-bit state codec (per-block absmax quantization)
# ---------------------------------------------------------------------------

_BLOCK = 128


def _q8_encode(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = x.reshape(-1)
    npad = -flat.shape[0] % _BLOCK
    flat = F.pad(flat, (0, npad)).reshape(-1, _BLOCK)
    scale = torch.amax(torch.abs(flat), dim=1, keepdim=True) / 127.0 + 1e-20
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _q8_decode(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


@dataclasses.dataclass
class Q8:
    """An int8 moment ``q`` (blocks, 128) with its per-block fp32
    ``scale`` (blocks, 1) and the moment's ``shape``."""
    q: torch.Tensor
    scale: torch.Tensor
    shape: Tuple[int, ...]


def _enc(x: torch.Tensor, bits: int):
    if bits == 32:
        return x
    q, s = _q8_encode(x)
    return Q8(q, s, tuple(x.shape))


def _dec(x, bits: int) -> torch.Tensor:
    if bits == 32:
        return x
    return _q8_decode(x.q, x.scale, x.shape)


# ---------------------------------------------------------------------------
# trees (nested dicts, walked in sorted key order as jax flattens them)
# ---------------------------------------------------------------------------

def tree_map(fn, *trees):
    """``fn`` over the leaves of equally keyed nested dicts."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


# ---------------------------------------------------------------------------
# API
# ---------------------------------------------------------------------------

class OptState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


def init(params: Dict[str, Any], cfg: AdamWConfig) -> OptState:
    """Zero moments (fp32 or Q8) beside each parameter, step 0 (int32 on
    the parameters' device)."""
    def zeros(p):
        return _enc(torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device), cfg.state_bits)
    device = tree_leaves(params)[0].device
    return OptState(torch.zeros((), dtype=torch.int32, device=device),
                    tree_map(zeros, params), tree_map(zeros, params))


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


class StepScalars(NamedTuple):
    """What one AdamW step shares across its leaves: the new step count,
    the learning rate, the bias corrections and the clip factor (None
    without clipping)."""
    step: torch.Tensor
    lr: torch.Tensor
    bc1: torch.Tensor
    bc2: torch.Tensor
    clip: Optional[torch.Tensor]


def step_scalars(step: torch.Tensor, gnorm: torch.Tensor, cfg: AdamWConfig
                 ) -> StepScalars:
    """The scalars of the step after ``step`` for a gradient of global
    norm ``gnorm``."""
    clip = (None if cfg.clip_norm is None else
            torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0))
    new = step + 1
    return StepScalars(new, schedule(cfg, step),
                       1 - cfg.beta1 ** new.to(torch.float32),
                       1 - cfg.beta2 ** new.to(torch.float32), clip)


@torch.no_grad()
def update_leaf(p: torch.Tensor, g: torch.Tensor, m, v, sc: StepScalars,
                cfg: AdamWConfig):
    """One leaf's AdamW update: (new parameter, new m, new v).  The
    update is elementwise, so a block of a leaf updates alone (with
    fp32 moments; a Q8 moment's blocks run over the flattened leaf)."""
    b1, b2 = cfg.beta1, cfg.beta2
    # the clip is applied leaf by leaf: no second copy of every grad
    if sc.clip is not None:
        g = g * sc.clip
    g = g.to(torch.float32)
    mf = b1 * _dec(m, cfg.state_bits) + (1 - b1) * g
    vf = b2 * _dec(v, cfg.state_bits) + (1 - b2) * g * g
    mhat = mf / sc.bc1
    vhat = vf / sc.bc2
    delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p
    pnew = (p - sc.lr * delta).to(p.dtype)
    return pnew, _enc(mf, cfg.state_bits), _enc(vf, cfg.state_bits)


@torch.no_grad()
def apply_updates(params: Dict[str, Any], grads: Dict[str, Any],
                  state: OptState, cfg: AdamWConfig
                  ) -> Tuple[Dict[str, Any], OptState, Dict[str, Any]]:
    """One AdamW step.  Returns (new_params, new_state, metrics), the
    metrics ``grad_norm`` and ``lr`` as 0-d tensors."""
    gnorm = global_norm(grads)
    sc = step_scalars(state.step, gnorm, cfg)
    out = tree_map(lambda p, g, m, v: update_leaf(p, g, m, v, sc, cfg),
                   params, grads, state.m, state.v)
    new_p, new_m, new_v = (tree_map(lambda o: o[i], out) for i in range(3))
    return new_p, OptState(sc.step, new_m, new_v), {"grad_norm": gnorm,
                                                    "lr": sc.lr}
