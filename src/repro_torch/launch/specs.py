"""Cell specifications: (arch x input-shape x mesh) -> runnable closure.

The port of the reference's ``launch/specs.py``.  ``input_specs``
returns stand-ins for every model input (``meta``-device tensors: shapes
and dtypes, no allocation) and the specs the cell runs under:

  * train cells run ``train.trainer.make_sharded_train_step``'s step
    (loss, gradients and the AdamW update on the rank's blocks, inputs
    donated),
  * prefill cells ``models.decode.prefill`` (forward + KV-cache build),
  * decode cells ``models.decode.decode_step`` (one token against a
    ``seq_len`` cache),
the last two under ``launch.mesh.set_mesh``.  Serving cells use bf16
parameters (no optimizer); training uses fp32 masters and AdamW moments
(8-bit where fp32 moments would not fit: ``opt_config_for``).

Where the reference returns ``NamedSharding``s, the port returns
``dist.comm_engine.Spec`` trees, printed as ``PartitionSpec``s, with the
mesh beside them (a ``DeviceMesh``, a ``RankMesh`` or ``{axis: size}``;
the closures run only on a mesh's ranks).  The reference takes a
prefill cell's output cache from ``jax.eval_shape`` of the prefill; the
port builds it by shape, :func:`cache_struct` of the same batch and
length, which has the reference's shapes and dtypes for every family.
Structs are built by shape, never drawn, so every configuration,
grok-1-314b too, has them without memory.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs import SHAPES, InputShape, ModelConfig, cells_for, get_config
from ..core import hopper
from ..dist.comm_engine import Spec
from ..launch.mesh import set_mesh
from ..models import common, decode as dec, transformer
from ..models.ssm import conv_dim
from ..models.transformer import hybrid_groups
from ..optim import adamw
from ..train import trainer


def opt_config_for(cfg: ModelConfig) -> adamw.AdamWConfig:
    """8-bit optimizer state where fp32 moments would not fit memory."""
    bits = 8 if cfg.param_count() > 200e9 else 32
    return adamw.AdamWConfig(total_steps=10_000, state_bits=bits)


# ---------------------------------------------------------------------------
# shape/sharding helpers
# ---------------------------------------------------------------------------

def _batch_axes(mesh) -> Tuple[str, ...]:
    names = trainer._mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _fit(spec_axes, shape, mesh) -> Spec:
    """A spec with the divisibility fallback (axis -> None)."""
    sizes = trainer._mesh_shape(mesh)
    out = []
    for dim, ax in zip(shape, spec_axes):
        if ax is None:
            out.append(None)
            continue
        ax = ax[0] if isinstance(ax, tuple) and len(ax) == 1 else ax
        size = 1
        for a in ((ax,) if isinstance(ax, str) else ax):
            size *= sizes[a]
        # one axis prints bare, as PartitionSpec normalizes it
        out.append(ax if dim % size == 0 else None)
    return Spec(*out)


def _sds(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in: a tensor on ``meta``."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


class _MetaGenerator(torch.Generator):
    """A generator whose ``device`` reads ``meta``: the initializers
    (``models.common.normal`` & co.) then make ``meta`` tensors of the
    parameters' shapes and draw nothing."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def _tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_struct(cfg: ModelConfig, dtype=None) -> Tuple[Any, Any]:
    """(``meta`` params tree, logical-axes tree): no allocation."""
    params = transformer.init_params(_MetaGenerator(), cfg)
    if dtype is not None:
        params = _tree_map(lambda s: _sds(s.shape, dtype), params)
    return params, transformer.param_axes(cfg)


def param_shardings(params, axes, cfg: ModelConfig, mesh,
                    rules: common.AxisRules = common.DEFAULT_RULES):
    """A :class:`Spec` a parameter, from its logical axes."""
    return rules.specs(axes, params, trainer._mesh_shape(mesh))


def cache_struct(cfg: ModelConfig, batch: int, seq_len: int) -> Dict:
    """Decode-cache stand-ins (mirrors ``models.decode.init_cache``)."""
    L = cfg.n_layers
    s_c = seq_len if cfg.swa_window is None else min(seq_len, cfg.swa_window)
    kvd = cfg.kv_dim

    def kv(n, s):
        return {"k": _sds((n, batch, s, kvd), torch.bfloat16),
                "v": _sds((n, batch, s, kvd), torch.bfloat16)}

    cache: Dict[str, Any] = {"pos": _sds((), torch.int32)}
    if cfg.family in ("dense", "moe", "encdec", "vlm"):
        cache["self"] = kv(L, s_c)
    if cfg.family in ("ssm", "hybrid"):
        cache["ssm"] = {
            "conv": _sds((L, batch, cfg.conv_kernel - 1, conv_dim(cfg)),
                         torch.float32),
            "state": _sds((L, batch, cfg.ssm_heads, cfg.ssm_state,
                           cfg.ssm_head_dim), torch.float32),
        }
    if cfg.family == "hybrid":
        n_apps, _, _ = hybrid_groups(cfg)
        cache["shared"] = kv(n_apps, s_c)
    if cfg.family == "encdec":
        cache["cross"] = kv(L, cfg.frontend_tokens)
    if cfg.family == "vlm":
        cache["cross"] = kv(cfg.n_layers // cfg.cross_attn_every,
                            cfg.frontend_tokens)
    return cache


def cache_shardings(cache, cfg: ModelConfig, mesh):
    """Path-keyed specs: batch over (pod, data), feature over model."""
    b_ax = _batch_axes(mesh)

    def spec(keys, leaf) -> Spec:
        if "pos" in keys:
            return Spec()
        if "state" in keys:                    # (L, B, H, N, P)
            return _fit((None, b_ax, "model", None, None), leaf.shape, mesh)
        if "conv" in keys:                     # (L, B, k-1, cd)
            return _fit((None, b_ax, None, "model"), leaf.shape, mesh)
        # kv caches (N, B, S, kvd)
        return _fit((None, b_ax, None, "model"), leaf.shape, mesh)

    def walk(node, keys):
        if isinstance(node, dict):
            return {k: walk(v, keys + (k,)) for k, v in node.items()}
        return spec(keys, node)

    return walk(cache, ())


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    arch: str
    shape: InputShape
    kind: str
    fn: Callable                   # runs in every rank of the mesh
    args: Tuple                    # meta-device stand-ins
    in_shardings: Tuple
    out_shardings: Any
    donate: Tuple[int, ...]
    model_flops: float             # 6ND / 2ND per the assignment formulas
    tokens: float
    cfg: Optional[ModelConfig] = None   # the configuration, overrides in


def input_specs(arch: str, shape_name: str, mesh,
                overrides: Optional[Dict] = None,
                batch: Optional[int] = None,
                seq_len: Optional[int] = None) -> Cell:
    """Build the cell for (arch x shape x mesh).

    ``overrides``: ModelConfig field overrides (remat,
    sequence_parallel, attention block knobs, depth); ``batch`` and
    ``seq_len``: a global batch and a length in place of the shape's (a
    cell cut to fit a card or a test)."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    if batch is not None:
        shape = dataclasses.replace(shape, global_batch=batch)
    if seq_len is not None:
        shape = dataclasses.replace(shape, seq_len=seq_len)
    if shape_name not in cells_for(cfg):
        raise ValueError(f"{arch} skips {shape_name} (full attention: "
                         "long_500k runs the sub-quadratic archs only)")
    b_ax = _batch_axes(mesh)
    B, S = shape.global_batch, shape.seq_len
    needs_frontend = cfg.family in ("encdec", "vlm")
    n_active = cfg.active_param_count()

    if shape.kind == "train":
        opt_cfg = opt_config_for(cfg)
        state = trainer.init_state(_MetaGenerator(), cfg, opt_cfg)
        step, st_sh, _ = trainer.make_sharded_train_step(
            cfg, opt_cfg, mesh, state, transformer.param_axes(cfg))
        batch = {"tokens": _sds((B, S), torch.int32),
                 "targets": _sds((B, S), torch.int32)}
        b_sh = {k: _fit((b_ax, None), (B, S), mesh) for k in batch}
        if needs_frontend:
            fshape = (B, cfg.frontend_tokens, cfg.d_model)
            batch["frontend"] = _sds(fshape, torch.float32)
            b_sh["frontend"] = _fit((b_ax, None, None), fshape, mesh)
        tokens = float(B) * S
        return Cell(arch, shape, "train", step, (state, batch),
                    (st_sh, b_sh), (st_sh, None), (0,),
                    hopper.dense_train_model_flops(n_active, tokens),
                    tokens, cfg)

    # serving cells: bf16 params
    params, axes = params_struct(cfg, dtype=torch.bfloat16)
    p_sh = param_shardings(params, axes, cfg, mesh)
    logits_sh = _fit((b_ax, "model"), (B, cfg.vocab), mesh)

    if shape.kind == "prefill":
        toks = _sds((B, S), torch.int32)
        args = [params, toks]
        in_sh = [p_sh, _fit((b_ax, None), (B, S), mesh)]
        if needs_frontend:
            fshape = (B, cfg.frontend_tokens, cfg.d_model)
            args.append(_sds(fshape, torch.float32))
            in_sh.append(_fit((b_ax, None, None), fshape, mesh))

        def fn(p, t, f=None):
            with set_mesh(mesh):
                return dec.prefill(p, t, cfg, frontend=f, max_len=S)

        # output: (last logits, cache)
        c_sh = cache_shardings(cache_struct(cfg, B, S), cfg, mesh)
        tokens = float(B) * S
        return Cell(arch, shape, "prefill", fn, tuple(args), tuple(in_sh),
                    (logits_sh, c_sh), (),
                    hopper.decode_model_flops(n_active, tokens), tokens,
                    cfg)

    # decode
    cache = cache_struct(cfg, B, S)
    c_sh = cache_shardings(cache, cfg, mesh)
    toks = _sds((B, 1), torch.int32)
    t_sh = _fit((b_ax, None), (B, 1), mesh)

    def fn(p, t, c):
        with set_mesh(mesh):
            return dec.decode_step(p, t, c, cfg)

    tokens = float(B)
    return Cell(arch, shape, "decode", fn, (params, toks, cache),
                (p_sh, t_sh, c_sh), (logits_sh, c_sh), (2,),
                hopper.decode_model_flops(n_active, tokens), tokens, cfg)


def all_cells(mesh_name: str = "single"):
    """Iterate every runnable (arch x shape) pair; yields (arch, shape_name)."""
    from ..configs import ARCH_IDS
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape_name in cells_for(cfg):
            yield arch, shape_name


def skipped_cells():
    from ..configs import ARCH_IDS
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape_name in SHAPES:
            if shape_name not in cells_for(cfg):
                yield arch, shape_name, "full attention; long_500k skipped"
