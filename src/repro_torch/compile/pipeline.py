"""The plan -> executable pipeline:  (TensorAlgebra, Dataflow) -> callable.

The port of the reference's ``compile/pipeline.py``:

    1. ``plan.kernel_plan_for`` picks the template (the paper's module
       selection, a total function of the classification),
    2. the algebra lowering (``lowering.lower_form``) maps the loop nest
       onto the template's batched-matmul interface,
    3. the shared, batch-aware tile chooser (``core.tiling``, the one the
       cost model prices with) fixes the block sizes,
    4. the result is cached on (algebra, dataflow, config, dtype, device,
       epilogue) in a bounded, locked LRU, and
    5. small problems are validated against ``alg.reference`` at lower
       time (larger ones on demand via ``CompiledKernel.validate``).

Not here yet, each raising ``NotImplementedError`` that names its slice:
structured block-sparse execution (the BSR kernel), merged graph groups
(``lower_group``) and the on-disk tuning cache (``tuned=True``).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import plan as plan_mod
from ..core import stt as stt_mod
from ..core import tiling
from ..core.algebra import TensorAlgebra
from ..core.costmodel import CostReport, PaperCycleModel
from ..core.stt import Dataflow
from ..core.tiling import ArrayConfig
from ..kernels import epilogue as epilogue_mod
from ..kernels import ops
from .lowering import LoweredForm, lower_form

#: auto-validate at lower time below this many MACs (a pure-python oracle
#: loop; ~1s at the limit, so big serving shapes skip it)
VALIDATE_MACS_LIMIT = 300_000


@dataclasses.dataclass
class CompiledKernel:
    """A lowered, executable tensor-algebra kernel.

    Call it with a dict of operands (the algebra's input tensor names;
    numpy arrays or tensors) and it returns the output tensor on
    ``device``, computed by the template the dataflow selected.
    """

    algebra: TensorAlgebra
    dataflow: Dataflow
    plan: plan_mod.ExecutionPlan
    form: LoweredForm
    blocks: Tuple[int, int, int]        # (bm, bn, bk) from the STT tile
    stationary: str                     # GEMM operand the template pins
    cfg: ArrayConfig
    dtype: torch.dtype
    device: torch.device
    #: kernel knobs (kernels/stt_gemm.py): contraction grid order and
    #: accumulation strategy; "default"/"auto" = the analytical choice
    grid_order: str = "default"
    accum: str = "auto"
    #: epilogue ops fused into the kernel's flush; () = plain algebra
    epilogue: Tuple[str, ...] = ()
    #: operand-dict key carrying the rank-1 bias vector a "bias" epilogue
    #: op reads (not an algebra tensor; None when the epilogue has none)
    bias_tensor: Optional[str] = None
    #: where the blocks/knobs came from: "analytical" (shared tile
    #: chooser) or "explicit" (caller overrides)
    source: str = "analytical"
    validated: bool = False
    _report: Optional[CostReport] = dataclasses.field(
        default=None, repr=False)

    @property
    def template(self) -> str:
        return self.plan.kernel.template

    @property
    def sparse_mode(self) -> str:
        """``masked`` (sparse algebra, dense execution on zero-masked
        operands) or ``dense``; the reference's ``bsr`` mode (a
        structured operand) is refused by ``lower`` until the sparse
        slice."""
        return "masked" if self.algebra.is_sparse else "dense"

    def partition_for(self, shape: Tuple[int, int],
                      axes: Tuple[str, str] = ("x", "y"), *,
                      shard_batch: bool = True,
                      compressed: Optional[bool] = None):
        """Solve this kernel's mesh partition for a mesh shape without
        binding devices (``core.plan.solve_partition`` over the generated
        CommPlan + this LoweredForm)."""
        return plan_mod.solve_partition(
            self.plan.comm, self.form, axes=axes, shape=shape,
            shard_batch=shard_batch, compressed=compressed)

    def cast_operands(self, operands: Dict[str, object]
                      ) -> Dict[str, torch.Tensor]:
        """Move to ``device``, cast to the kernel dtype and *enforce* every
        attached sparsity pattern (zero outside the nonzero blocks), so the
        pattern is part of the kernel's semantics even when a caller passes
        unmasked data."""
        cast = {name: torch.as_tensor(v, device=self.device).to(self.dtype)
                for name, v in operands.items()}
        for name, sp in self.algebra.sparsity:
            t = next(t for t in self.algebra.tensors if t.name == name)
            mask = torch.as_tensor(
                sp.element_mask(self.algebra.tensor_shape(t)),
                device=self.device)
            # select, don't multiply: out-of-pattern inf/nan must drop out
            cast[name] = torch.where(
                mask, cast[name],
                torch.zeros((), dtype=self.dtype, device=self.device))
        return cast

    def __call__(self, operands: Dict[str, object]) -> torch.Tensor:
        bias = None
        if self.bias_tensor is not None:
            if self.bias_tensor not in operands:
                raise ValueError(
                    f"kernel has a fused bias epilogue: operands must "
                    f"include {self.bias_tensor!r}")
            operands = dict(operands)
            bias = torch.as_tensor(operands.pop(self.bias_tensor),
                                   device=self.device).to(torch.float32)
        cast = self.cast_operands(operands)
        lhs, rhs = self.form.prepare(cast)
        bm, bn, bk = self.blocks
        out2d = ops.stt_matmul(
            lhs, rhs, template=self.template, stationary=self.stationary,
            bm=bm, bn=bn, bk=bk, strip_budget=self.cfg.strip_budget_bytes,
            grid_order=self.grid_order, accum=self.accum,
            epilogue=self.epilogue, bias=bias, device=self.device)
        return self.form.finish(out2d)

    def validate(self, seed: int = 0, atol: float = 1e-3) -> float:
        """Execute on random operands and compare against the loop-nest
        oracle ``alg.reference`` (composed with the numpy epilogue mirror
        when ops are fused).  Returns the max abs error; raises on
        mismatch.  Integer-valued operands make the fp32 path exact for
        every registry shape that fits the oracle."""
        operands = dict(self.algebra.random_operands(seed))
        bias = None
        if self.bias_tensor is not None:
            n_last = self.algebra.tensor_shape(self.algebra.output)[-1]
            bias = np.random.default_rng(seed + 1).integers(
                -4, 5, size=(n_last,)).astype(np.float64)
            operands[self.bias_tensor] = bias
        got = self(operands).detach().to("cpu", torch.float64).numpy()
        want = self.algebra.reference(
            {k: v for k, v in operands.items()
             if k != self.bias_tensor}).astype(np.float64)
        if self.epilogue:
            want = epilogue_mod.apply_epilogue_np(want, self.epilogue,
                                                  bias=bias)
        err = float(np.abs(got - want).max()) if got.size else 0.0
        if got.shape != want.shape or err > atol:
            raise AssertionError(
                f"lowered {self.algebra.name} x {self.dataflow.name} "
                f"diverged from reference: shape {got.shape} vs "
                f"{want.shape}, max err {err:.3e}")
        self.validated = True
        return err

    def cost_report(self) -> CostReport:
        """The cost model's view of this exact (algebra, dataflow, config)
        — same tile chooser, so priced and executed tiles agree."""
        if self._report is None:
            self._report = PaperCycleModel(self.cfg).evaluate(
                self.algebra, self.dataflow)
        return self._report


# ---------------------------------------------------------------------------
# Compile cache — bounded LRU, safe under concurrent lowers
# ---------------------------------------------------------------------------

#: default cap (the full registry x named-STT matrix is 24 entries)
DEFAULT_CACHE_CAPACITY = 256

_CACHE: "collections.OrderedDict[Tuple, CompiledKernel]" = (
    collections.OrderedDict())
_CACHE_LOCK = threading.Lock()
_CAPACITY = DEFAULT_CACHE_CAPACITY
_STATS = {"hits": 0, "misses": 0, "evictions": 0}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _cache_key(alg: TensorAlgebra, df: Dataflow, cfg: ArrayConfig,
               dtype: torch.dtype, device: torch.device,
               epilogue: Tuple[str, ...] = (),
               bias_tensor: Optional[str] = None) -> Tuple:
    # alg is a frozen dataclass of tuples: it *is* the algebra signature
    # (name + loops + bounds + access matrices + sparsity), and the
    # LoweredForm is a pure function of it.  The dataflow key adds the
    # selection, the exact T and the per-tensor classification; the
    # device takes the place of the reference's interpret/backend pair.
    return (alg, df.selected, df.T, df.signature, cfg, _dtype_name(dtype),
            str(device), tuple(epilogue), bias_tensor)


def _variant_key(key: Tuple, blocks, grid_order: str, accum: str) -> Tuple:
    """Extend the base key with the knob values a kernel was built with
    (``blocks=None`` = the analytical tile chooser's blocks)."""
    return key + (blocks, grid_order, accum)


def cache_info() -> Dict[str, int]:
    with _CACHE_LOCK:
        return {"size": len(_CACHE), "capacity": _CAPACITY, **_STATS}


def cache_clear() -> None:
    with _CACHE_LOCK:
        _CACHE.clear()
        _STATS["hits"] = _STATS["misses"] = _STATS["evictions"] = 0


def cache_resize(capacity: int) -> None:
    """Set the LRU capacity, evicting least-recently-used entries now if
    the cache is over the new cap."""
    if capacity < 1:
        raise ValueError("cache capacity must be >= 1")
    global _CAPACITY
    with _CACHE_LOCK:
        _CAPACITY = capacity
        while len(_CACHE) > _CAPACITY:
            _CACHE.popitem(last=False)
            _STATS["evictions"] += 1


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def default_dataflow(alg: TensorAlgebra) -> Dataflow:
    """A sane default schedule: output-stationary STT over the first three
    loop iterators (every Table II algebra admits it)."""
    return stt_mod.apply_stt(alg, alg.loops[:3],
                             stt_mod.stt_from_name("output_stationary"))


def _epilogue_legal_for_form(alg: TensorAlgebra, form: LoweredForm,
                             epilogue: Tuple[str, ...]) -> Optional[str]:
    """Why this epilogue cannot ride this lowered form (None = legal).

    Elementwise ops commute with the finish reshape, so they are legal on
    every form.  ``bias`` / ``softmax`` act along the last axis: they are
    only legal when the finished tensor's last axis *is* the matmul n
    axis (gemm's identity finish is the canonical case).
    """
    rowwise = (epilogue_mod.needs_bias(epilogue)
               or epilogue_mod.has_softmax(epilogue))
    if not rowwise:
        return None
    out_shape = alg.tensor_shape(alg.output)
    if form.batch or out_shape[-1] != form.n:
        return (f"bias/softmax epilogue acts on the matmul n axis "
                f"(n={form.n}) but the finished output {out_shape} of "
                f"{alg.name} does not end with it")
    return None


def lower(alg: TensorAlgebra, df: Optional[Dataflow] = None, *,
          cfg: ArrayConfig = ArrayConfig(),
          dtype: torch.dtype = torch.float32,
          device=None,
          validate: Optional[bool] = None,
          blocks: Optional[Tuple[int, int, int]] = None,
          grid_order: Optional[str] = None,
          accum: Optional[str] = None,
          tuned: Optional[bool] = None,
          epilogue: Sequence[str] = (),
          bias_tensor: Optional[str] = None) -> CompiledKernel:
    """Lower ``(algebra, dataflow)`` to an executable, cached kernel.

    ``device`` defaults to the card and raises when there is none
    (``ops.resolve_device``); pass ``device="cpu"`` for the plain
    versions.  ``validate=None`` auto-validates against ``alg.reference``
    when the problem is small enough for the python oracle.

    ``blocks`` / ``grid_order`` / ``accum`` override the analytical tile
    chooser and the kernel-knob defaults.  ``tuned=True`` (the on-disk
    tuning cache) waits for the tuning slice and raises.

    ``epilogue`` fuses post-processing ops into the kernel's flush; a
    ``"bias"`` op names its rank-1 operand via ``bias_tensor`` (the
    ``__call__`` dict key).  Both enter the cache key.
    """
    device = ops.resolve_device(device)
    if df is None:
        df = default_dataflow(alg)
    if df.algebra_name != alg.name:
        raise ValueError(f"dataflow {df.name} was generated for algebra "
                         f"{df.algebra_name!r}, not {alg.name!r}")
    if tuned:
        raise NotImplementedError(
            "tuned=True reads the on-disk tuning cache, which arrives with "
            "the tuning slice; lower() takes the analytical choice")
    epilogue = epilogue_mod.validate_spec(epilogue)
    if epilogue_mod.needs_bias(epilogue) and bias_tensor is None:
        raise ValueError("epilogue with a 'bias' op needs bias_tensor= "
                         "(the operand-dict key of the bias vector)")
    if bias_tensor is not None and not epilogue_mod.needs_bias(epilogue):
        raise ValueError("bias_tensor= given but the epilogue has no "
                         "'bias' op")
    if bias_tensor is not None and any(t.name == bias_tensor
                                       for t in alg.tensors):
        raise ValueError(f"bias_tensor {bias_tensor!r} collides with an "
                         f"algebra tensor name")
    key = _cache_key(alg, df, cfg, dtype, device, epilogue, bias_tensor)
    source = ("explicit" if (blocks, grid_order, accum) != (None,) * 3
              else "analytical")
    grid_order = "default" if grid_order is None else grid_order
    accum = "auto" if accum is None else accum
    key = _variant_key(key, blocks, grid_order, accum)
    with _CACHE_LOCK:
        hit = _CACHE.get(key)
        if hit is not None:
            _STATS["hits"] += 1
            _CACHE.move_to_end(key)
        else:
            _STATS["misses"] += 1
    if hit is not None:
        if not hit.validated and (
                validate or (validate is None
                             and alg.total_macs() <= VALIDATE_MACS_LIMIT)):
            # an earlier lower(validate=False) cached it unvalidated;
            # honour the explicit or auto-validate request now
            hit.validate()
        return hit

    ep = plan_mod.plan_for(
        df, densities={name: alg.density_of(name) for name, _ in alg.sparsity})
    form = lower_form(alg)
    if form.sparse is not None:
        raise NotImplementedError(
            f"{alg.name} with a structured block-sparse operand "
            f"({form.sparse.tensor}) runs on the BSR kernel, which arrives "
            f"with the sparse slice; patterns without a structured image "
            f"already run masked-dense")
    if epilogue:
        reason = _epilogue_legal_for_form(alg, form, epilogue)
        if reason is not None:
            raise ValueError(reason)
    if blocks is None:
        blocks = tiling.form_blocks(alg, df, form, cfg.pe_dims)
    if epilogue_mod.has_softmax(epilogue) and blocks[1] != form.n:
        # a row softmax needs the whole unpadded row in one block
        blocks = (blocks[0], form.n, blocks[2])
    stationary = ("A" if ep.kernel.resident_tensor in form.lhs_tensors
                  else "B")
    kernel = CompiledKernel(
        algebra=alg, dataflow=df, plan=ep, form=form, blocks=tuple(blocks),
        stationary=stationary, cfg=cfg, dtype=dtype, device=device,
        epilogue=epilogue, bias_tensor=bias_tensor,
        grid_order=grid_order, accum=accum, source=source)
    if validate or (validate is None
                    and alg.total_macs() <= VALIDATE_MACS_LIMIT):
        kernel.validate()
    with _CACHE_LOCK:
        prior = _CACHE.get(key)
        if prior is not None:
            # a concurrent lower built the same kernel first; keep the
            # cached one so callers always share a single object per key
            _CACHE.move_to_end(key)
            return prior
        _CACHE[key] = kernel
        while len(_CACHE) > _CAPACITY:
            _CACHE.popitem(last=False)
            _STATS["evictions"] += 1
    return kernel


def lower_group(*args, **kwargs):
    """Merged fused-graph groups (one kernel per chain) arrive with the
    graph slice."""
    raise NotImplementedError(
        "lower_group (merged graph groups) arrives with the graph slice")
