"""Mamba-2 (SSD) block: projections + causal conv + chunked SSD + gate.

The port of the reference's ``models/ssm.py``.  Prefill runs the chunked
SSD through ``kernels/ssd_scan.py``, which also hands back the final
state: on a CUDA tensor the hand-written scan kernels
(``csrc/ssd_scan.cu``), on a CPU tensor the plain
``ref.ssd_chunked_ref``, as the reference's models run it; under
autograd on the card the kernels' own backward (``SSDScanFn``), in
training the final state's gradient being zero.  Decode keeps
an O(1) recurrent state (B, H, N, P) plus a rolling conv window and
advances them in plain PyTorch on every device (the reference has no
kernel for it either).  Decode returns **new** conv and state tensors and
never writes the given ones: the slot engine keeps idle slots' lanes by
selecting between the old and the new tensors.

The projections run in the compute dtype; everything after ``in_proj``
(conv, SSD, gate) in fp32, with the block's scalar parameters kept fp32.
With ``cfg.explicit_collectives`` the input's sequence shards are
gathered by ``explicit_tp.gather_seq`` (None with no mesh: the
one-device block, bit for bit); on a mesh the block runs on the whole
sequence of the rank's batch rows and hands back the stream's layout.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..compile.pipeline import torch_dtype
from ..configs.base import ModelConfig
from ..kernels.ssd_scan import ssd_scan
from . import explicit_tp as etp
from .common import Logical, normal, stacked_dense_init


def conv_dim(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def init_ssm(gen: torch.Generator, cfg: ModelConfig, n_layers: int
             ) -> Dict[str, torch.Tensor]:
    """Stacked Mamba-2 params for ``n_layers`` layers, fp32, with the
    reference's keys, shapes and initializer scales."""
    d, di, h = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    g, n = cfg.ssm_groups, cfg.ssm_state
    cd = conv_dim(cfg)
    dev = gen.device
    # in_proj emits [z (di) | x (di) | B (g n) | C (g n) | dt (h)]
    out_dim = 2 * di + 2 * g * n + h
    return {
        "in_proj": stacked_dense_init(gen, n_layers, d, out_dim),
        "conv_w": 0.1 * normal(gen, (n_layers, cfg.conv_kernel, cd)),
        "conv_b": torch.zeros((n_layers, cd), device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)
                           ).expand(n_layers, h).contiguous(),
        "d_skip": torch.ones((n_layers, h), device=dev),
        "dt_bias": torch.zeros((n_layers, h), device=dev),
        "norm_g": torch.ones((n_layers, di), device=dev),
        "out_proj": stacked_dense_init(gen, n_layers, di, d),
    }


def ssm_axes() -> Dict[str, Logical]:
    """The logical axes of :func:`init_ssm`'s leaves, the reference's."""
    return {"in_proj": Logical(("layers", "embed", "ssm_inner")),
            "conv_w": Logical(("layers", None, "ssm_inner")),
            "conv_b": Logical(("layers", "ssm_inner")),
            "a_log": Logical(("layers", None)),
            "d_skip": Logical(("layers", None)),
            "dt_bias": Logical(("layers", None)),
            "norm_g": Logical(("layers", "ssm_inner")),
            "out_proj": Logical(("layers", "ssm_inner", "embed"))}


def _split_proj(proj: torch.Tensor, cfg: ModelConfig):
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    z = proj[..., :di]
    xbc = proj[..., di:di + di + 2 * g * n]
    dt = proj[..., di + di + 2 * g * n:]
    return z, xbc, dt


def _gated_norm(y: torch.Tensor, z: torch.Tensor, gamma: torch.Tensor,
                eps: float) -> torch.Tensor:
    yf = y.to(torch.float32) * F.silu(z.to(torch.float32))
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return yf * torch.rsqrt(var + eps) * gamma


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^x)`` without a cut-off (``jax.nn.softplus``'s
    ``logaddexp(x, 0)``; torch's ``softplus`` returns x above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def apply_ssm(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
              *, cache: Optional[Dict[str, torch.Tensor]] = None,
              collect_cache: bool = False,
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x: (B, L, D).  With ``cache`` (decode): L == 1 and the recurrence
    advances one step, returning new ``conv``/``state`` tensors.
    ``collect_cache`` (prefill) returns the decode cache (rolling conv
    window of the unpadded prompt + final SSD state).  Returns (out,
    new_cache)."""
    compute = torch_dtype(cfg.dtype)
    lay = etp.current_layout()
    xg = x.to(compute)
    gathered = etp.gather_seq(xg, lay) if cfg.explicit_collectives else None
    xg = gathered if gathered is not None else etp.full_seq(xg, lay)
    b, l, _ = xg.shape
    di, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    ph = cfg.ssm_head_dim
    f32 = torch.float32

    proj = (xg @ p["in_proj"].to(compute)).to(f32)
    z, xbc, dt = _split_proj(proj, cfg)
    dt = _softplus(dt + p["dt_bias"])                          # (B, L, H)
    a = -torch.exp(p["a_log"])                                 # (H,)

    kconv = cfg.conv_kernel
    new_cache = None
    if cache is None:
        # pad L to a chunk multiple; padded steps get dt = 0 so they neither
        # move the state (decay = exp(0) = 1) nor contribute (dt*B*x = 0)
        chunk = min(cfg.ssm_chunk, l)
        lp = -(-l // chunk) * chunk
        xbc_c = F.pad(xbc, (0, 0, 0, lp - l)) if lp != l else xbc
        dt = F.pad(dt, (0, 0, 0, lp - l)) if lp != l else dt
        # causal depthwise conv over (x|B|C) channels
        pad = F.pad(xbc_c, (0, 0, kconv - 1, 0))
        conv = sum(pad[:, i:i + lp] * p["conv_w"][i] for i in range(kconv))
        conv = F.silu(conv + p["conv_b"])
        xs = conv[..., :di].reshape(b, lp, h, ph)
        bs = conv[..., di:di + g * n].reshape(b, lp, g, n)
        cs = conv[..., di + g * n:].reshape(b, lp, g, n)
        y, h_fin = ssd_scan(xs, dt, a, bs, cs, chunk=chunk)
        y, xs = y[:, :l], xs[:, :l]
        if collect_cache:
            # the window is cut from the unpadded prompt, and copied: a
            # view would keep the whole (B, L, cd) input alive in the
            # cache; on a model mesh the rank keeps its channel block of
            # the window and its head block of the state
            new_cache = {
                "conv": etp.feature_copy(
                    xbc[:, l - (kconv - 1):].to(f32, copy=True), 2),
                "state": etp.feature_copy(h_fin, 1)}
    else:
        # decode: rolling conv window (B, k-1, cd) + state (B, H, N, P);
        # on a model mesh the rank's channel block of the window and its
        # head block of the state (explicit_tp.feature_block)
        cb = etp.feature_block(xbc.shape[-1])
        hb = etp.feature_block(h)
        cw, cbias = p["conv_w"], p["conv_b"]
        if cb is not None:
            xbc = xbc[..., cb[0]:cb[1]]
            cw, cbias = cw[:, cb[0]:cb[1]], cbias[cb[0]:cb[1]]
        _placed_check(cache, xbc.shape[-1], h if hb is None
                      else hb[1] - hb[0])
        win = torch.cat([cache["conv"], xbc], dim=1)           # (B, k, cd)
        conv = sum(win[:, i:i + 1] * cw[i] for i in range(kconv))
        conv = F.silu(conv + cbias)                            # (B, 1, cd)
        if cb is not None:
            conv = etp.gather_model(conv, 2)
        xs = conv[..., :di].reshape(b, h, ph)
        bs = conv[..., di:di + g * n].reshape(b, g, n)
        cs = conv[..., di + g * n:].reshape(b, g, n)
        rep = h // g
        bh = bs.repeat_interleave(rep, dim=1)                  # (B, H, N)
        ch = cs.repeat_interleave(rep, dim=1)
        dt1 = dt[:, 0]                                         # (B, H)
        ah, xh = a, xs
        if hb is not None:
            sl = slice(hb[0], hb[1])
            bh, ch, dt1, ah, xh = bh[:, sl], ch[:, sl], dt1[:, sl], a[sl], \
                xs[:, sl]
        decay = torch.exp(dt1 * ah)                            # (B, H)
        h_new = decay[..., None, None] * cache["state"] + torch.einsum(
            "bhn,bhp->bhnp", dt1[..., None] * bh, xh)
        y = torch.einsum("bhn,bhnp->bhp", ch, h_new)           # (B, H, P)
        if hb is not None:
            y = etp.gather_model(y, 1)
        y = y[:, None]                                         # (B,1,H,P)
        new_cache = {"conv": win[:, 1:], "state": h_new}
        xs = xs[:, None]                                       # for D skip

    y = y + p["d_skip"][:, None] * xs                          # D skip conn
    y = y.reshape(b, l, di)
    y = _gated_norm(y, z, p["norm_g"], cfg.norm_eps).to(compute)
    out = (y @ p["out_proj"].to(compute)).to(x.dtype)
    return etp.to_layout(out, lay), new_cache


def _placed_check(cache: Dict[str, torch.Tensor], channels: int,
                  heads: int) -> None:
    """Raise unless the decode cache holds ``channels`` conv channels and
    ``heads`` state heads (the rank's blocks on a model mesh)."""
    got = (cache["conv"].shape[-1], cache["state"].shape[1])
    if got != (channels, heads):
        raise ValueError(
            f"SSM decode takes the cache placed by cache_shardings: "
            f"{channels} conv channels and {heads} state heads a rank, got "
            f"{got[0]} and {got[1]}")


def make_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device=None, *, channels: Optional[int] = None,
                   heads: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Zero conv window and state; ``channels`` / ``heads`` in place of
    the whole ``conv_dim`` / ``ssm_heads`` (a rank's blocks)."""
    channels = conv_dim(cfg) if channels is None else channels
    heads = cfg.ssm_heads if heads is None else heads
    return {
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, channels),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, heads, cfg.ssm_state,
                              cfg.ssm_head_dim), dtype=dtype, device=device),
    }
