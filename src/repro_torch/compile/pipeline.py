"""The plan -> executable pipeline:  (TensorAlgebra, Dataflow) -> callable.

The port of the reference's ``compile/pipeline.py``:

    1. ``plan.kernel_plan_for`` picks the template (the paper's module
       selection, a total function of the classification),
    2. the algebra lowering (``lowering.lower_form``) maps the loop nest
       onto the template's batched-matmul interface,
    3. the shared, batch-aware tile chooser (``core.tiling``, the one the
       cost model prices with) fixes the block sizes,
    4. the result is cached on (algebra, dataflow, config, dtype, device,
       epilogue, fused group) in a bounded, locked LRU, and
    5. small problems are validated against ``alg.reference`` at lower
       time (larger ones on demand via ``CompiledKernel.validate``).

A structured block-sparse operand runs on the BSR kernel
(``ops.bsr_matmul``); ``lower_group`` lowers a merged graph group to one
fused-chain or fused-DAG megakernel (``kernels/fused_chain.py``).  Not
here yet, raising ``NotImplementedError`` that names its slice: the
on-disk tuning cache (``tuned=True``).
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
from ..kernels import fused_chain as fused_chain_mod
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
    #: identity of the fused graph group this kernel was lowered for
    #: (``repro_torch.graph``); part of the cache key so a
    #: block-constrained fused lowering never aliases the standalone one
    fused_group: Optional[str] = None
    #: where the blocks/knobs came from: "analytical" (shared tile
    #: chooser) or "explicit" (caller overrides)
    source: str = "analytical"
    validated: bool = False
    _report: Optional[CostReport] = dataclasses.field(
        default=None, repr=False)
    #: per-pattern device state, built at first call: the element masks
    #: ``cast_operands`` selects with, and the BSR kernel's CSR arrays
    _masks: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    _csr: Optional[Tuple[torch.Tensor, torch.Tensor]] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def template(self) -> str:
        return self.plan.kernel.template

    @property
    def sparse(self):
        """The structured block-sparse operand (OperandSparsity) or None."""
        return self.form.sparse

    @property
    def sparse_mode(self) -> str:
        """``bsr`` (the kernel reads only nonzero blocks), ``masked``
        (sparse algebra, dense execution on zero-masked operands; batched
        forms skip all-zero batch slices — see ``LoweredForm.batch_keep``),
        or ``dense``."""
        if self.form.sparse is not None:
            return "bsr"
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
            mask = self._masks.get(name)
            if mask is None:
                t = next(t for t in self.algebra.tensors if t.name == name)
                mask = self._masks[name] = torch.as_tensor(
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
        sp = self.form.sparse
        if sp is not None:
            sp_arr, dense_arr = (lhs, rhs) if sp.side == "lhs" else (rhs, lhs)
            if self._csr is None:
                self._csr = ops.bsr_csr(sp.coords, sp.block,
                                        tuple(sp_arr.shape), sp.side,
                                        self.device)
            out2d = ops.bsr_matmul(
                sp_arr, dense_arr, coords=sp.coords, block=sp.block,
                bstream=bn if sp.side == "lhs" else bm, side=sp.side,
                csr=self._csr)
            if self.epilogue:
                # the BSR kernel has no epilogue flush: apply it on the
                # full 2-D output (same math, one extra pass)
                out2d = epilogue_mod.apply_epilogue(
                    out2d.to(torch.float32), self.epilogue,
                    bias=bias).to(self.dtype)
        else:
            out2d = ops.stt_matmul(
                lhs, rhs, template=self.template,
                stationary=self.stationary, bm=bm, bn=bn, bk=bk,
                strip_budget=self.cfg.strip_budget_bytes,
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
               bias_tensor: Optional[str] = None,
               fused_group: Optional[str] = None) -> Tuple:
    # alg is a frozen dataclass of tuples: it *is* the algebra signature
    # (name + loops + bounds + access matrices + sparsity), and the
    # LoweredForm is a pure function of it.  The dataflow key adds the
    # selection, the exact T and the per-tensor classification; the
    # device takes the place of the reference's interpret/backend pair.
    # The epilogue spec and the fused-group id are part of the identity:
    # an epilogue'd kernel computes another function, and a fused-graph
    # lowering constrains the blocks.
    return (alg, df.selected, df.T, df.signature, cfg, _dtype_name(dtype),
            str(device), tuple(epilogue), bias_tensor, fused_group)


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
          bias_tensor: Optional[str] = None,
          fused_group: Optional[str] = None) -> CompiledKernel:
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
    ``__call__`` dict key).  ``fused_group`` tags a lowering constrained
    by a fused graph (``repro_torch.graph``).  All three enter the cache
    key, so standalone and fused variants never alias.
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
    key = _cache_key(alg, df, cfg, dtype, device, epilogue, bias_tensor,
                     fused_group)
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
        epilogue=epilogue, bias_tensor=bias_tensor, fused_group=fused_group,
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


# ---------------------------------------------------------------------------
# Merged fused-group lowering — one CompiledGroupKernel per chain
# ---------------------------------------------------------------------------

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(dtype) -> torch.dtype:
    """A graph plan's dtype name (``"float32"``, ``"bfloat16"``) or a
    torch dtype, as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _TORCH_DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r}; the port runs "
                         f"{sorted(_TORCH_DTYPES)}") from None


@dataclasses.dataclass
class CompiledGroupKernel:
    """An entire fused graph group lowered to ONE kernel launch.

    Two templates share this wrapper.  ``kind == "chain"`` (the streamed
    lhs ladder): ``__call__(lhs, rhss, biases)`` takes the group's
    external operands in *storage* layout (gemm weights are ``(n, k)``;
    the transposed view the per-node ``prepare`` would take is taken
    here) and returns the group's result edge.  ``kind == "dag"``
    (stage-major: rhs-landing edges, batched stages, residuals, taps):
    ``__call__(exts)`` takes ONE sequence of external operands matching
    ``ext_roles`` order — again in storage layout, role casts applied
    here — and returns ``(result, *taps)``.  Either way every non-tapped
    intermediate stays in the kernel's workspace
    (``kernels/fused_chain.py``).
    """

    group: str                          # FusedGroupPlan.name
    stages: Tuple[str, ...]             # member node names (labels)
    chain: Tuple[fused_chain_mod.ChainStage, ...]
    m: int
    k0: int
    bm: int                             # the plan's m-block
    interleave: str                     # "chain" | "stage" | "dag"
    cfg: ArrayConfig
    dtype: torch.dtype
    device: torch.device
    kind: str = "chain"                 # "chain" | "dag"
    dag: Tuple[fused_chain_mod.DagStage, ...] = ()
    ext_roles: Tuple[Tuple[str, str], ...] = ()     # (edge, role)
    ext_shapes: Tuple[Tuple[int, ...], ...] = ()    # storage shapes
    n_tap: int = 0
    #: where bm/interleave came from: "analytical" (the plan's agreed
    #: blocks) or "explicit" (caller overrides)
    source: str = "analytical"
    validated: bool = False

    def total_macs(self) -> int:
        if self.kind == "dag":
            return sum(st.m * st.k * st.n for st in self.dag)
        return sum(self.m * st.k * st.n for st in self.chain)

    @staticmethod
    def _dag_prep(ext: torch.Tensor, role: str, dtype: torch.dtype
                  ) -> torch.Tensor:
        """Storage layout -> kernel-facing layout, per operand role."""
        if role == "rhs":
            return ext.to(dtype).T              # (n, k) storage -> (k, n)
        if role == "res":
            return ext.to(torch.float32)
        if role == "bias":
            return ext.to(torch.float32).reshape(1, -1).contiguous()
        return ext.to(dtype)                    # lhs / a3d / vec

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def __call__(self, lhs, rhss: Sequence = (), biases: Sequence = ()):
        if self.kind == "dag":
            # single argument: the ext_roles-ordered operand sequence
            exts = tuple(self._dag_prep(self._tensor(e), role, self.dtype)
                         for e, (_, role) in zip(lhs, self.ext_roles))
            return fused_chain_mod.fused_dag(exts, stages=self.dag,
                                             out_dtype=self.dtype)
        # gemm stores B as (n, k); the merged template wants (k, n)
        rhs_kn = tuple(self._tensor(r).to(self.dtype).T for r in rhss)
        rows = tuple(self._tensor(b).to(torch.float32).reshape(-1)
                     for b in biases)
        return fused_chain_mod.fused_chain_matmul(
            self._tensor(lhs).to(self.dtype), rhs_kn, rows,
            stages=self.chain, bm=self.bm, interleave=self.interleave,
            out_dtype=self.dtype)

    def _numpy(self, t: torch.Tensor) -> np.ndarray:
        return t.detach().to("cpu", torch.float64).numpy()

    def validate(self, seed: int = 0, atol: float = 1e-3,
                 rtol: Optional[float] = None) -> float:
        """Run on random integer operands and compare against the fp64
        numpy chain oracle (dot + ``apply_epilogue_np`` per stage).
        ``rtol`` scales with the output magnitude (a chain compounds
        rounding); defaults per dtype."""
        if rtol is None:
            rtol = 1e-5 if self.dtype == torch.float32 else 2e-2
        rng = np.random.default_rng(seed)
        if self.kind == "dag":
            return self._validate_dag(rng, atol, rtol)
        lhs = rng.integers(-4, 5, size=(self.m, self.k0))
        rhss = [rng.integers(-4, 5, size=(st.n, st.k))
                for st in self.chain]
        biases = [rng.integers(-4, 5, size=(st.n,))
                  for st in self.chain if st.has_bias]
        got = self._numpy(self(lhs, rhss, biases))
        x = lhs.astype(np.float64)
        bi = 0
        for st, r in zip(self.chain, rhss):
            x = x @ r.T.astype(np.float64)
            if st.epilogue:
                b = None
                if st.has_bias:
                    b = biases[bi].astype(np.float64)
                    bi += 1
                x = epilogue_mod.apply_epilogue_np(x, st.epilogue, bias=b)
        want = x
        err = float(np.abs(got - want).max()) if got.size else 0.0
        bound = atol + rtol * (float(np.abs(want).max()) if want.size
                               else 0.0)
        if got.shape != want.shape or err > bound:
            raise AssertionError(
                f"merged group {self.group} diverged from the chain "
                f"oracle: shape {got.shape} vs {want.shape}, max err "
                f"{err:.3e} (bound {bound:.3e})")
        self.validated = True
        return err

    def _validate_dag(self, rng, atol: float, rtol: float) -> float:
        """DAG branch of :meth:`validate`: random integer operands in
        storage layout, compared (result + every tap) against a fp64
        numpy mirror of the stage list."""
        exts = [rng.integers(-4, 5, size=shape)
                for shape in self.ext_shapes]
        got = tuple(self._numpy(o) for o in self(exts))
        prepped = []
        for e, (_, role) in zip(exts, self.ext_roles):
            a = e.astype(np.float64)
            prepped.append(a.T if role == "rhs" else a)
        vals: list = []
        taps: dict = {}
        for st in self.dag:
            def fetch(src, transpose=False):
                where, idx = src
                buf = prepped[idx] if where == "ext" else vals[idx]
                return buf.T if transpose else buf
            if st.kind == "batched":
                acc = np.einsum("bkn,bk->bn", fetch(st.lhs),
                                fetch(st.rhs))
            else:
                acc = fetch(st.lhs) @ fetch(
                    st.rhs, transpose=st.rhs[0] == "scr")
            if st.epilogue:
                b = (prepped[st.bias].reshape(-1) if st.has_bias
                     else None)
                acc = epilogue_mod.apply_epilogue_np(acc, st.epilogue,
                                                     bias=b)
            y = acc
            if st.res is not None:
                y = y + fetch(st.res)
            vals.append(y)
            if st.tap >= 0:
                taps[st.tap] = y
        wants = (vals[-1],) + tuple(taps[i] for i in sorted(taps))
        err_max = 0.0
        for which, (g, want) in enumerate(zip(got, wants)):
            err = float(np.abs(g - want).max()) if g.size else 0.0
            bound = atol + rtol * (float(np.abs(want).max())
                                   if want.size else 0.0)
            if g.shape != want.shape or err > bound:
                what = "result" if which == 0 else f"tap {which - 1}"
                raise AssertionError(
                    f"merged group {self.group} {what} diverged from "
                    f"the DAG oracle: shape {g.shape} vs {want.shape}, "
                    f"max err {err:.3e} (bound {bound:.3e})")
            err_max = max(err_max, err)
        self.validated = True
        return err_max


def _group_cache_key(plan, group, device) -> Tuple:
    """The merged-kernel cache identity: ``_cache_key``'s per-node
    components *extended with the stage list* — each stage contributes
    its algebra, dataflow identity, epilogue spec and bias presence, in
    chain order — plus the shared config/dtype/device.  Two graphs whose
    fused chains are structurally identical share the entry regardless
    of node or edge naming.  A ``kind="dag"`` group keys on its bound
    stage list + operand-role order instead: the dag template ignores
    per-node dataflows, and the hashable :class:`DagStage` tuple already
    encodes shapes, wiring, epilogues and taps."""
    if getattr(group, "kind", "chain") == "dag":
        return ("fused_dag", group.dag,
                tuple(role for _, role in group.ext_inputs),
                plan.cfg, str(plan.dtype), str(device))
    stage_ids = []
    for name in group.stages:
        p = plan.nodes[name]
        stage_ids.append((p.node.algebra, p.dataflow.selected,
                          p.dataflow.T, p.dataflow.signature,
                          p.epilogue, p.bias_edge is not None))
    return ("fused_chain", tuple(stage_ids), plan.cfg, str(plan.dtype),
            str(device))


def _group_variant_key(key: Tuple, bm: int, interleave: str) -> Tuple:
    return key + (int(bm), str(interleave))


def lower_group(plan, group, *, device=None,
                validate: Optional[bool] = None,
                bm: Optional[int] = None,
                interleave: Optional[str] = None,
                tuned: Optional[bool] = None) -> CompiledGroupKernel:
    """Lower a :class:`~repro_torch.graph.planner.FusedGroupPlan` to a
    single cached :class:`CompiledGroupKernel` (one kernel launch for the
    whole group).

    ``bm`` / ``interleave`` override the plan's agreed m-block and the
    default stage order.  ``tuned=True`` (the on-disk group tuning cache)
    waits for the tuning slice and raises; the analytical choice is
    taken.
    """
    if tuned:
        raise NotImplementedError(
            "tuned=True reads the on-disk group tuning cache, which "
            "arrives with the tuning slice; lower_group() takes the "
            "analytical bm and interleave")
    if not group.eligible:
        raise ValueError(f"group {group.name} is not merged-eligible: "
                         f"{group.reason}")
    device = ops.resolve_device(device)
    key = _group_cache_key(plan, group, device)
    source = ("explicit" if (bm, interleave) != (None, None)
              else "analytical")
    is_dag = getattr(group, "kind", "chain") == "dag"
    bm = group.bm if bm is None else bm
    if interleave is None:
        interleave = (fused_chain_mod.DAG_INTERLEAVE if is_dag
                      else "chain")
    allowed = ((fused_chain_mod.DAG_INTERLEAVE,) if is_dag
               else fused_chain_mod.FUSED_INTERLEAVES)
    if interleave not in allowed:
        raise ValueError(f"interleave must be one of {allowed}, "
                         f"got {interleave!r}")
    key = _group_variant_key(key, bm, interleave)
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
                             and hit.total_macs() <= VALIDATE_MACS_LIMIT)):
            hit.validate()
        return hit
    ext_shapes = (tuple(plan.graph.edge_shape(e)
                        for e, _ in group.ext_inputs) if is_dag else ())
    kernel = CompiledGroupKernel(
        group=group.name, stages=tuple(group.stages), chain=group.chain,
        m=group.m, k0=group.k0, bm=bm, interleave=interleave,
        cfg=plan.cfg, dtype=torch_dtype(plan.dtype), device=device,
        source=source, kind="dag" if is_dag else "chain",
        dag=group.dag if is_dag else (),
        ext_roles=tuple(group.ext_inputs) if is_dag else (),
        ext_shapes=ext_shapes,
        n_tap=len(group.taps) if is_dag else 0)
    if validate or (validate is None
                    and kernel.total_macs() <= VALIDATE_MACS_LIMIT):
        kernel.validate()
    with _CACHE_LOCK:
        prior = _CACHE.get(key)
        if prior is not None:
            _CACHE.move_to_end(key)
            return prior
        _CACHE[key] = kernel
        while len(_CACHE) > _CAPACITY:
            _CACHE.popitem(last=False)
            _STATS["evictions"] += 1
    return kernel
