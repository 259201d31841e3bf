"""Algebra lowering: map every Table II tensor algebra onto the templates.

TensorLib's reuse argument (paper §V) is that a small set of hardware
templates covers every tensor algebra.  Here the templates are the three
GEMM kernels in ``kernels/stt_gemm.py`` — so to make
*every* ``get_algebra`` name executable the non-GEMM algebras must be
expressed as one (optionally batched) matmul plus cheap data-layout prep:

    gemm            C = A @ B^T                         (transpose)
    batched_gemv    per-batch (1,k)x(k,n) on the grid   (grid-folded batch)
    conv2d          im2col patches x reshaped weights   (paper's conv = GEMM)
    depthwise_conv  per-channel im2col x (1,pq) weights (grid-folded channel)
    mttkrp          mode-1 unfolding x Khatri-Rao product
    ttmc            mode-1 unfolding x Kronecker product

Each lowering yields a :class:`LoweredForm`: the batched-matmul problem
dims ``out[b, m, n] = lhs[b|·, m, k] @ rhs[b|·, k, n]`` (``batch=()``
degenerates to the plain 2-D GEMM), which loop iterators each dim folds
(so the STT tile choice maps onto the block sizes), which algebra
tensors feed the lhs/rhs (so residency from the KernelPlan maps onto
the ``stationary`` operand), and prepare/finish callables that move
operands into and out of matrix form.

Batch loops that index an operand *and* the output (batched_gemv's batch,
depthwise_conv's channel) become leading **grid** dimensions of the
templates — never contraction padding — so the executed kernel performs
exactly the algebra's MACs and ``CostReport.executed_macs`` matches what
``PaperCycleModel`` prices.  (The retired block-diagonal GEMM-ization,
which zero-padded the contraction and executed batch× the useful work,
survives only as a test oracle in ``kernels/ref.py``.)

The prep work is plain torch layout code (reshape/slice/broadcast) — the
MACs all run inside the selected template, which is the point.

PyTorch port of the reference's ``compile/lowering.py``: the same forms,
with ``jnp.take`` as ``index_select`` and ``.at[idx].set`` as
``index_copy``.  ``prepare`` keeps views where the reference does
(gemm's ``B.T`` stays a strided view; the kernels take strides).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, FrozenSet, Mapping, Optional, Tuple

import torch

from ..core.algebra import Sparsity, TensorAlgebra


Operands = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OperandSparsity:
    """A tensor's block-sparse pattern mapped onto one 2-D GEMM operand.

    ``coords`` live on the block grid of the *prepared* 2-D operand
    (lhs2d or rhs2d, post-``prepare``), sorted row-major — the form the
    BSR kernel's scalar-prefetch index map consumes directly.
    """

    side: str                            # "lhs" | "rhs"
    tensor: str                          # the algebra tensor it came from
    block: Tuple[int, int]               # 2-D block shape on that operand
    coords: Tuple[Tuple[int, int], ...]  # row-major block-COO
    grid: Tuple[int, int]                # block-grid shape of the operand

    @property
    def nnz_blocks(self) -> int:
        return len(self.coords)

    @property
    def density(self) -> float:
        total = self.grid[0] * self.grid[1]
        return self.nnz_blocks / total if total else 0.0


@dataclasses.dataclass(frozen=True)
class LoweredForm:
    """A rank-aware batched-matmul view of a tensor algebra:

        out[b, m, n] = lhs[b|·, m, k] @ rhs[b|·, k, n]

    ``batch`` holds the sizes of the leading (grid-parallel) batch dims;
    ``()`` degenerates to the plain 2-D GEMM every dense non-batched
    algebra uses.  ``lhs_batched`` / ``rhs_batched`` record whether
    ``prepare`` emits that operand with the leading batch dim (un-batched
    operands broadcast across the batch grid axis via their index maps).
    """

    m: int
    n: int
    k: int
    #: which loop iterators each dim folds, e.g. conv2d k = (c, p, q);
    #: the "b" key lists the batch loops folded onto the grid axis
    dim_loops: Mapping[str, Tuple[str, ...]]
    #: algebra tensors feeding each matmul operand (residency mapping)
    lhs_tensors: FrozenSet[str]
    rhs_tensors: FrozenSet[str]
    prepare: Callable[[Operands], Tuple[torch.Tensor, torch.Tensor]]
    finish: Callable[[torch.Tensor], torch.Tensor]
    #: leading batch-dim sizes; () = no batch grid axis
    batch: Tuple[int, ...] = ()
    lhs_batched: bool = False
    rhs_batched: bool = False
    #: structured block-sparse operand (at most one: the BSR kernel takes
    #: one coordinate list); None for dense algebras
    sparse: Optional[OperandSparsity] = None
    #: sparse tensors executed via the masked-dense fallback — their
    #: pattern has no structured 2-D image under this lowering (operands
    #: are zero-masked, so the dense templates stay exact; only the
    #: block-skipping speedup is lost)
    masked_sparse: Tuple[str, ...] = ()
    #: for batched forms with sparse operands: the original batch-slice
    #: indices the kernel executes (slices whose sparse operands are
    #: entirely zero blocks produce exactly-zero output slices and are
    #: skipped; ``prepare``/``finish`` compact and re-expand the batch
    #: axis).  None = every slice executes.
    batch_keep: Optional[Tuple[int, ...]] = None
    #: original batch extent before slice skipping (``batch`` holds the
    #: compacted extent so every consumer scales with executed work)
    batch_full: Optional[Tuple[int, ...]] = None

    @property
    def batch_size(self) -> int:
        """Total batch grid extent (1 when the form is a plain GEMM)."""
        return math.prod(self.batch) if self.batch else 1

    @property
    def executed_macs(self) -> int:
        """MACs the lowered kernel actually performs: one per grid point
        of the batched matmul.  The BSR grid visits only nonzero blocks,
        so a structured sparse operand scales this by its block density.
        Equal to ``alg.total_macs()`` for every registry algebra — the
        grid-folded refactor's invariant."""
        executed = self.batch_size * self.m * self.n * self.k
        if self.sparse is not None:
            executed = round(executed * self.sparse.density)
        return max(1, executed)


def _b(alg: TensorAlgebra, *names: str) -> Tuple[int, ...]:
    return tuple(alg.bounds[alg.loop_index(nm)] for nm in names)


def _im2col_batched(a: torch.Tensor, y: int, x: int, p: int, q: int
                    ) -> torch.Tensor:
    """(C, y+p-1, x+q-1) -> (C, p * q, y * x) per-channel patch matrices,
    (p, q)-ordered rows — matching a (p, q)-ordered weight reshape."""
    c = a.shape[0]
    patches = torch.stack([a[:, pp:pp + y, qq:qq + x]
                           for pp in range(p) for qq in range(q)], dim=1)
    return patches.reshape(c, p * q, y * x)


def _im2col(a: torch.Tensor, y: int, x: int, p: int, q: int) -> torch.Tensor:
    """(C, y+p-1, x+q-1) -> (C * p * q, y * x) patch matrix, C-major then
    (p, q) — matching a (C, p, q)-ordered weight reshape."""
    c = a.shape[0]
    return _im2col_batched(a, y, x, p, q).reshape(c * p * q, y * x)


# ---------------------------------------------------------------------------
# Per-algebra lowerings (Table II)
# ---------------------------------------------------------------------------

def _lower_gemm(alg: TensorAlgebra) -> LoweredForm:
    m, n, k = _b(alg, "m", "n", "k")
    return LoweredForm(
        m, n, k,
        {"b": (), "m": ("m",), "n": ("n",), "k": ("k",)},
        frozenset({"A"}), frozenset({"B"}),
        prepare=lambda ops: (ops["A"], ops["B"].T),   # B is (n, k)
        finish=lambda c: c)


def _lower_batched_gemv(alg: TensorAlgebra) -> LoweredForm:
    m, n, k = _b(alg, "m", "n", "k")
    return LoweredForm(
        1, n, k,
        {"b": ("m",), "m": (), "n": ("n",), "k": ("k",)},
        frozenset({"B"}), frozenset({"A"}),
        # C[m, n] = sum_k A[m, k, n] * B[m, k]: the batch loop m indexes
        # both inputs and the output -> it becomes the leading grid dim,
        # a (1, k) x (k, n) matvec per batch slice.
        prepare=lambda ops: (ops["B"].reshape(m, 1, k), ops["A"]),
        finish=lambda c: c.reshape(m, n),
        batch=(m,), lhs_batched=True, rhs_batched=True)


def _lower_conv2d(alg: TensorAlgebra) -> LoweredForm:
    k, c, y, x, p, q = _b(alg, "k", "c", "y", "x", "p", "q")
    return LoweredForm(
        k, y * x, c * p * q,
        {"b": (), "m": ("k",), "n": ("y", "x"), "k": ("c", "p", "q")},
        frozenset({"B"}), frozenset({"A"}),
        prepare=lambda ops: (ops["B"].reshape(k, c * p * q),
                             _im2col(ops["A"], y, x, p, q)),
        finish=lambda o: o.reshape(k, y, x))


def _lower_depthwise(alg: TensorAlgebra) -> LoweredForm:
    k, y, x, p, q = _b(alg, "k", "y", "x", "p", "q")
    return LoweredForm(
        1, y * x, p * q,
        {"b": ("k",), "m": (), "n": ("y", "x"), "k": ("p", "q")},
        frozenset({"B"}), frozenset({"A"}),
        # channel loop k indexes weights, activations and output -> it
        # becomes the leading grid dim: per-channel im2col patches against
        # that channel's (1, p*q) filter row.
        prepare=lambda ops: (ops["B"].reshape(k, 1, p * q),
                             _im2col_batched(ops["A"], y, x, p, q)),
        finish=lambda o: o.reshape(k, y, x),
        batch=(k,), lhs_batched=True, rhs_batched=True)


def _lower_mttkrp(alg: TensorAlgebra) -> LoweredForm:
    i, j, k, l = _b(alg, "i", "j", "k", "l")
    return LoweredForm(
        i, j, k * l,
        {"b": (), "m": ("i",), "n": ("j",), "k": ("k", "l")},
        frozenset({"A"}), frozenset({"B", "C"}),
        # D = A_(1) @ (B Khatri-Rao C): mode-1 unfolding of A against the
        # column-wise Khatri-Rao product of the factor matrices
        prepare=lambda ops: (ops["A"].reshape(i, k * l),
                             (ops["B"][:, None, :]
                              * ops["C"][None, :, :]).reshape(k * l, j)),
        finish=lambda d: d)


def _lower_ttmc(alg: TensorAlgebra) -> LoweredForm:
    i, j, k, l, m = _b(alg, "i", "j", "k", "l", "m")
    return LoweredForm(
        i, j * k, l * m,
        {"b": (), "m": ("i",), "n": ("j", "k"), "k": ("l", "m")},
        frozenset({"A"}), frozenset({"B", "C"}),
        # D_(1) = A_(1) @ (B Kronecker C): Tucker-style chain contraction
        prepare=lambda ops: (ops["A"].reshape(i, l * m),
                             (ops["B"][:, None, :, None]
                              * ops["C"][None, :, None, :]
                              ).reshape(l * m, j * k)),
        finish=lambda d: d.reshape(i, j, k))


_LOWERINGS: Dict[str, Callable[[TensorAlgebra], LoweredForm]] = {
    "gemm": _lower_gemm,
    "batched_gemv": _lower_batched_gemv,
    "conv2d": _lower_conv2d,
    "depthwise_conv": _lower_depthwise,
    "mttkrp": _lower_mttkrp,
    "ttmc": _lower_ttmc,
}


# ---------------------------------------------------------------------------
# Block-sparse pattern -> 2-D GEMM operand mapping
# ---------------------------------------------------------------------------
# Each mapper takes (alg, tensor shape, Sparsity) and returns an
# OperandSparsity on the *prepared* 2-D operand, or None when the pattern
# has no structured image under the lowering (the caller then falls back
# to masked-dense execution, which stays exact).  Batched forms have no
# mappers: the BSR kernel is 2-D, so their patterns run masked-dense.

def _sparse_gemm_A(alg: TensorAlgebra, shape, sp: Sparsity
                   ) -> Optional[OperandSparsity]:
    # A (m, k) feeds lhs2d unchanged
    grid = sp.grid(shape)
    return OperandSparsity("lhs", "A", (sp.block[0], sp.block[1]),
                           tuple(sorted(sp.coords)), grid)


def _sparse_gemm_B(alg: TensorAlgebra, shape, sp: Sparsity
                   ) -> Optional[OperandSparsity]:
    # B (n, k) becomes rhs2d = B.T (k, n): block coords transpose
    grid = sp.grid(shape)
    coords = tuple(sorted((c, r) for r, c in sp.coords))
    return OperandSparsity("rhs", "B", (sp.block[1], sp.block[0]), coords,
                           (grid[1], grid[0]))


def _sparse_conv2d_B(alg: TensorAlgebra, shape, sp: Sparsity
                     ) -> Optional[OperandSparsity]:
    # weights (k, c, p, q) reshape to lhs2d (k, c*p*q): a block covering
    # the full (p, q) window maps to a contiguous 2-D block — the
    # block-sparse im2col form (im2col'd activations stay dense)
    k, c, p, q = shape
    if sp.block[2:] != (p, q):
        return None
    grid = sp.grid(shape)
    coords = tuple(sorted((ci[0], ci[1]) for ci in sp.coords))
    return OperandSparsity("lhs", "B", (sp.block[0], sp.block[1] * p * q),
                           coords, (grid[0], grid[1]))


def _sparse_mttkrp_A(alg: TensorAlgebra, shape, sp: Sparsity
                     ) -> Optional[OperandSparsity]:
    # A (i, k, l) reshapes to lhs2d (i, k*l): blocks covering full l stay
    # contiguous through the mode-1 unfolding
    i, k, l = shape
    if sp.block[2] != l:
        return None
    grid = sp.grid(shape)
    coords = tuple(sorted((ci[0], ci[1]) for ci in sp.coords))
    return OperandSparsity("lhs", "A", (sp.block[0], sp.block[1] * l),
                           coords, (grid[0], grid[1]))


_SPARSE_MAPPERS: Dict[Tuple[str, str], Callable] = {
    ("gemm", "A"): _sparse_gemm_A,
    ("gemm", "B"): _sparse_gemm_B,
    ("conv2d", "B"): _sparse_conv2d_B,
    ("mttkrp", "A"): _sparse_mttkrp_A,
}


def _attach_sparsity(alg: TensorAlgebra, form: LoweredForm) -> LoweredForm:
    """Map every attached pattern onto the lowered form: at most one
    becomes the structured (BSR-executed) operand and the rest run
    masked-dense.

    Tie-break intent, explicitly: the structured slot goes to the pattern
    with the **lowest block density** — fewest nonzero blocks, i.e. the
    most grid stages the BSR kernel gets to skip.  Equal densities break
    deterministically by tensor name (alphabetical).
    """
    mapped = []
    masked = []
    for name, sp in alg.sparsity:
        t = next(t for t in alg.tensors if t.name == name)
        mapper = _SPARSE_MAPPERS.get((alg.name, name))
        osp = mapper(alg, alg.tensor_shape(t), sp) if mapper else None
        if osp is None:
            masked.append(name)
        else:
            mapped.append(osp)
    mapped.sort(key=lambda o: (o.density, o.tensor))
    chosen = mapped[0] if mapped else None
    masked.extend(o.tensor for o in mapped[1:])
    return dataclasses.replace(form, sparse=chosen,
                               masked_sparse=tuple(sorted(masked)))


def _batch_keep(alg: TensorAlgebra, form: LoweredForm
                ) -> Optional[Tuple[int, ...]]:
    """Batch slices the kernel must execute for a sparse batched form.

    The batched lowerings run masked-dense (the BSR kernel is 2-D), but a
    block pattern still maps **per batch slice**: a slice whose sparse
    operands hold only zero blocks produces an exactly-zero output slice
    and can be skipped outright.  Any sparse input whose leading tensor
    dim *is* the batch iterator (batched_gemv's A/B over m,
    depthwise_conv's A/B over the channel) constrains the kept set; when
    several do, a slice survives only if nonzero in all of them (the
    output is their product).  Returns None when every slice executes.
    """
    if len(form.batch) != 1 or not alg.sparsity:
        return None
    bloops = form.dim_loops.get("b", ())
    if len(bloops) != 1:
        return None
    bcol = alg.loop_index(bloops[0])
    b = form.batch[0]
    keep = None
    for name, sp in alg.sparsity:
        t = next(t for t in alg.tensors if t.name == name)
        row0 = t.access[0]
        if not (row0[bcol] == 1 and sum(abs(v) for v in row0) == 1):
            continue              # leading dim is not the batch iterator
        nz = set()
        for c in sp.coords:
            lo = c[0] * sp.block[0]
            nz.update(range(lo, min(b, lo + sp.block[0])))
        keep = nz if keep is None else (keep & nz)
    if keep is None or len(keep) == b:
        return None
    return tuple(sorted(keep)) or (0,)


def _compact_batch(form: LoweredForm, keep: Tuple[int, ...]) -> LoweredForm:
    """Wrap prepare/finish to execute only the kept batch slices (the
    skipped ones are exactly zero under the enforced patterns)."""
    keep_idx = torch.tensor(keep, dtype=torch.long)
    b_full = form.batch[0]
    orig_prepare, orig_finish = form.prepare, form.finish

    def prepare(ops: Operands) -> Tuple[torch.Tensor, torch.Tensor]:
        lhs, rhs = orig_prepare(ops)
        if form.lhs_batched:
            lhs = lhs.index_select(0, keep_idx.to(lhs.device))
        if form.rhs_batched:
            rhs = rhs.index_select(0, keep_idx.to(rhs.device))
        return lhs, rhs

    def finish(o: torch.Tensor) -> torch.Tensor:
        full = torch.zeros((b_full, *o.shape[1:]), dtype=o.dtype,
                           device=o.device)
        full = full.index_copy(0, keep_idx.to(o.device), o)
        return orig_finish(full)

    return dataclasses.replace(form, batch=(len(keep),), prepare=prepare,
                               finish=finish, batch_keep=keep,
                               batch_full=form.batch)


def lower_form(alg: TensorAlgebra) -> LoweredForm:
    """Lower any registry algebra to its batched-matmul form (bounds-aware).

    Algebras carrying block-sparse patterns get them mapped onto the 2-D
    operands here (``LoweredForm.sparse`` / ``masked_sparse``); the
    pipeline then routes the structured operand through the BSR kernel
    grid.  Sparse *batched* forms map their patterns per batch slice:
    all-zero slices are skipped (``batch_keep``), so ``executed_macs``
    scales with the nonzero slice count instead of the full batch.
    """
    try:
        builder = _LOWERINGS[alg.name]
    except KeyError:
        raise NotImplementedError(
            f"no template lowering registered for algebra {alg.name!r}; "
            f"known: {sorted(_LOWERINGS)}") from None
    form = builder(alg)
    if alg.sparsity:
        form = _attach_sparsity(alg, form)
        keep = _batch_keep(alg, form)
        if keep is not None:
            form = _compact_batch(form, keep)
    return form
