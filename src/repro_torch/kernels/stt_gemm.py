"""STT-selected GEMM templates — the paper's PE templates on Hopper.

The port of the reference's ``kernels/stt_gemm.py``.  TensorLib's
PE-internal modules (paper Fig. 3) become residency choices of three
hand-written CUDA kernels (``csrc/stt_gemm.cu``):

* ``output_stationary``  (paper (a)(a)(d), e.g. MNK-SST): each CTA owns
  an output tile and keeps its sum in registers for the whole k loop
  while A/B tiles stream through shared memory.
* ``operand_stationary`` (paper (a)(c)(b), e.g. MNK-STS / MNK-TSS): a
  ``WS_CHUNK_K``-deep chunk of the stationary operand is pinned in shared
  memory while the CTA sweeps m; the output strip accumulates in an fp32
  global workspace (the TPU kept it in VMEM).
* ``reduction_tree``     (paper (f)+tree, K-spatial dataflows, and
  ``streaming``): one pass per output tile over the full K.

Operands may be rank 3 — ``(B, m, k) @ (B, k, n)`` — with a rank-2
operand broadcast across the batch (batch stride 0); rank-2 inputs give
rank-2 outputs.

Each wrapper keeps the reference's argument checks and then runs, by
the device of its operands: on the CPU the template's plain PyTorch
version (``*_plain``, which also defines the kernel's arithmetic); on a
CUDA tensor the kernel, or it raises.  A ``meta`` tensor takes the path
of the device it stands for (:func:`modelling`; the dry run's): the
attention, SSD and gather wrappers have meta branches that count the
launch and charge its ``cost()``.  ``launches`` counts kernel launches
per template, and only launches.

Operands reach the kernels as strided views: the wrappers pass each
operand's strides instead of making it contiguous, so gemm's ``B.T`` and
the input-stationary transposition cost no copy.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Iterator, Optional, Tuple

import torch

from . import _build
from . import epilogue as _ep

DEFAULT_BLOCK = 128
#: default cap on the operand-stationary strip workspace per batch slice
#: (the reference's VMEM budget; see core/tiling.ArrayConfig)
DEFAULT_STRIP_BUDGET = 16 * 1024 * 1024

#: k depth of the operand-stationary kernels' pinned chunk of the
#: stationary operand (``WS_KC`` in ``csrc/stt_gemm.cu``): the fp32 strip
#: is read-modify-written once per chunk after the first, and the last
#: chunk is flushed from registers, so ``2 * (ceil(k / WS_CHUNK_K) - 1)``
#: passes over the strip remain
WS_CHUNK_K = 256

#: kernel launches per template since the last ``reset_launches``
launches = {"output_stationary": 0, "operand_stationary": 0,
            "reduction_tree": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _validate(m, n, k, bm, bn, bk):
    if m % bm or n % bn or k % bk:
        raise ValueError(f"shape ({m},{n},{k}) not divisible by blocks "
                         f"({bm},{bn},{bk}); ops.stt_matmul pads first")


def _as_batched(a: torch.Tensor, b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, int, bool]:
    """Lift operands to rank 3 under a shared leading batch extent.

    A rank-2 operand becomes ``(1, m, k)`` and broadcasts across the
    batch.  Returns ``(a3, b3, nb, squeeze)`` where ``squeeze`` says both
    inputs were 2-D and the caller should return a rank-2 output.
    """
    if a.dim() not in (2, 3) or b.dim() not in (2, 3):
        raise ValueError(f"operands must be rank 2 or 3, got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    squeeze = a.dim() == 2 and b.dim() == 2
    a3 = a if a.dim() == 3 else a.unsqueeze(0)
    b3 = b if b.dim() == 3 else b.unsqueeze(0)
    nb = max(a3.shape[0], b3.shape[0])
    if a3.shape[0] not in (1, nb) or b3.shape[0] not in (1, nb):
        raise ValueError(f"batch dims must match or broadcast, got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    if a3.shape[2] != b3.shape[1]:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    return a3, b3, nb, squeeze


def _check_epilogue(epilogue: Tuple[str, ...], bias, n: int, bn: int
                    ) -> Tuple[str, ...]:
    """Validate an epilogue spec against the template geometry."""
    epilogue = _ep.validate_spec(epilogue)
    if _ep.needs_bias(epilogue) and bias is None:
        raise ValueError(f"epilogue {epilogue} needs a bias operand")
    if bias is not None and not _ep.needs_bias(epilogue):
        raise ValueError(f"bias operand given but epilogue {epilogue} "
                         f"has no 'bias' op")
    if _ep.has_softmax(epilogue) and bn != n:
        raise ValueError(
            f"softmax epilogue needs one output block spanning the full "
            f"row (bn == n), got bn={bn} n={n}; a partial row cannot be "
            f"normalized block-locally")
    return epilogue


def _bias_row(bias, n: int, device) -> Optional[torch.Tensor]:
    if bias is None:
        return None
    bias = torch.as_tensor(bias, device=device)
    if tuple(bias.shape) != (n,):
        raise ValueError(f"bias must be rank-1 of length n={n}, "
                         f"got shape {tuple(bias.shape)}")
    return bias.to(torch.float32).contiguous()


def operand_stationary_strip_bytes(m: int, bn: int) -> int:
    """Bytes of the (m, bn) fp32 strip accumulator the operand-stationary
    template needs **per batch slice** (batch slices reuse one strip in
    the reference; the CUDA kernel keeps one (m, n) workspace per slice,
    and this per-slice figure is what the budget caps)."""
    return m * bn * 4


# ---------------------------------------------------------------------------
# plain versions: the kernels' arithmetic in PyTorch
# ---------------------------------------------------------------------------

def _fp32_product(a3: torch.Tensor, b3: torch.Tensor) -> torch.Tensor:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.matmul(a3.to(torch.float32), b3.to(torch.float32))


def _flush_plain(acc: torch.Tensor, epilogue, bias, out_dtype
                 ) -> torch.Tensor:
    """The shared flush: epilogue on the fp32 block, then cast."""
    if epilogue:
        acc = _ep.apply_epilogue(acc, epilogue, bias=bias)
    return acc.to(out_dtype)


def output_stationary_plain(a3, b3, *, bk: int, accum: str, out_dtype,
                            epilogue=(), bias=None) -> torch.Tensor:
    """``scratch``: fp32 sum, one cast at the flush.  ``inplace``: the
    running sum is rounded to ``out_dtype`` after every k-step of ``bk``,
    as the reference's ``o += dot(...).astype(out_dtype)``."""
    if accum == "scratch":
        return _flush_plain(_fp32_product(a3, b3), epilogue, bias,
                            out_dtype)
    k = a3.shape[2]
    acc = None
    for s in range(0, k, bk):
        part = _fp32_product(a3[:, :, s:s + bk],
                             b3[:, s:s + bk, :]).to(out_dtype)
        acc = part if acc is None else acc + part
    return _flush_plain(acc.to(torch.float32), epilogue, bias, out_dtype)


def operand_stationary_plain(a3, b3, *, out_dtype, epilogue=(),
                             bias=None) -> torch.Tensor:
    """fp32 strip sums over every k-step, flushed after the last one."""
    return _flush_plain(_fp32_product(a3, b3), epilogue, bias, out_dtype)


def reduction_tree_plain(a3, b3, *, out_dtype, epilogue=(),
                         bias=None) -> torch.Tensor:
    """One full-K fp32 product per output block, then the flush."""
    return _flush_plain(_fp32_product(a3, b3), epilogue, bias, out_dtype)


# ---------------------------------------------------------------------------
# kernel launch plumbing
# ---------------------------------------------------------------------------

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


#: the device a ``meta`` tensor stands for: the card by default, the CPU
#: inside ``modelling("cpu")`` (``launch.op_analysis`` sets it)
_MODELLED = ["cuda"]

#: what a meta branch charges its launch to: ``fn(name, flops, bytes)``
#: callables, innermost last (``launch.op_analysis.OpAnalysis`` pushes one)
COST_SINKS: list = []


@contextlib.contextmanager
def modelling(device: str) -> Iterator[None]:
    """Let ``meta`` tensors stand for ``device``'s (``"cuda"`` or
    ``"cpu"``) for the ``with`` block: every route then takes the path
    that device would take."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"a meta tensor stands for 'cuda' or 'cpu', got "
                         f"{device!r}")
    _MODELLED.append(device)
    try:
        yield
    finally:
        _MODELLED.pop()


def _on_cpu(*xs: torch.Tensor) -> bool:
    """Whether the operands take the plain versions' path (the CPU's)
    rather than the kernels' (the card's); a ``meta`` operand takes the
    path of the device it stands for (:func:`modelling`).  Operands of
    two devices raise."""
    devs = {x.device.type for x in xs if x is not None}
    devs = {_MODELLED[-1] if d == "meta" else d for d in devs}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: {sorted(devs)}")
    dev = devs.pop()
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev!r}")
    return dev == "cpu"


def on_card(*xs: torch.Tensor) -> bool:
    """Whether the operands take the card's path (:func:`_on_cpu`)."""
    return not _on_cpu(*xs)


def meta_launch(counts: dict, name: str, flops: float, nbytes: float
                ) -> None:
    """A kernel launch on ``meta`` operands: counted in the module's
    ``launches`` and charged to the active cost sink; nothing runs."""
    counts[name] += 1
    if COST_SINKS:
        COST_SINKS[-1](name, flops, nbytes)


#: the slice that brings backward kernels for the generated
#: accelerators' templates (the GEMMs, BSR and the fused megakernels)
LATER_TRAINING = ("a later slice (training through the generated "
                  "accelerators)")


def _no_backward(kernel: str, arrives: str, *xs) -> None:
    """Refuse to launch a kernel that has no backward while autograd
    records a graph through it: its ctypes launch would hand back an
    output with no ``grad_fn`` and the gradients of its inputs would be
    lost without a word.  ``arrives`` names the slice that brings the
    backward.  Serving runs under ``no_grad`` and never gets here."""
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in xs):
        raise NotImplementedError(
            f"{kernel} has no backward kernel: an input requires grad, and "
            f"training through it arrives with {arrives}")


def _cuda_args(a3, b3, nb: int, out_dtype, epilogue):
    """Check the operands for a launch and build the shared arguments:
    (dtype code, A view, B view, n_ops, opcodes, params)."""
    if a3.device != b3.device:
        raise ValueError(f"operands on {a3.device} and {b3.device}")
    if a3.dtype != b3.dtype or a3.dtype not in _DTYPE_CODES:
        raise ValueError(f"the CUDA templates take float32 or bfloat16 "
                         f"operands of one dtype, got {a3.dtype} x "
                         f"{b3.dtype}")
    if out_dtype != a3.dtype:
        raise ValueError(f"the CUDA templates write the input dtype "
                         f"{a3.dtype}, got out_dtype={out_dtype}")
    codes, params = _ep.encode(epilogue)
    n_ops = len(codes)
    c_codes = (ctypes.c_int * _ep.MAX_OPS)(*codes)
    c_params = (ctypes.c_float * _ep.MAX_OPS)(*params)
    return (_DTYPE_CODES[a3.dtype], *_view(a3, nb), *_view(b3, nb), n_ops,
            c_codes, c_params)


def _view(x3: torch.Tensor, nb: int):
    """(pointer, batch, row and column strides in elements); an operand
    broadcast over the batch gets batch stride 0."""
    sb = 0 if x3.shape[0] == 1 else x3.stride(0)
    return (x3.data_ptr(), sb, x3.stride(1), x3.stride(2))


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


# ---------------------------------------------------------------------------
# output-stationary (SST-class): C resident, A/B streamed
# ---------------------------------------------------------------------------
# Two knobs, as in the reference:
#
# * ``grid_order`` — "mnk" / "nmk" keep the reduction innermost; the
#   k-outer "kmn" / "knm" revisit the output block between k-steps on the
#   TPU and need ``accum="inplace"``.  On Hopper CTAs run in no order, so
#   every order computes the same numbers as its k-inner in-place twin;
#   the order picks the raster (which of m or n is the fast CTA index).
# * ``accum`` — "scratch" accumulates in fp32 and casts once; "inplace"
#   rounds the running sum to the output dtype after every k-step of bk.

#: valid output-stationary grid orders (batch axis is always outermost)
OS_GRID_ORDERS = ("mnk", "nmk", "kmn", "knm")
ACCUM_MODES = ("scratch", "inplace")


def matmul_output_stationary(a: torch.Tensor, b: torch.Tensor, *,
                             bm: int = DEFAULT_BLOCK,
                             bn: int = DEFAULT_BLOCK,
                             bk: int = DEFAULT_BLOCK,
                             grid_order: str = "mnk",
                             accum: str = "scratch",
                             out_dtype=None,
                             epilogue: Tuple[str, ...] = (),
                             bias=None) -> torch.Tensor:
    if grid_order == "default":
        grid_order = "mnk"
    elif grid_order in ("mn", "nm"):    # reduction-tree spelling
        grid_order += "k"
    if grid_order not in OS_GRID_ORDERS:
        raise ValueError(f"grid_order must be one of {OS_GRID_ORDERS}, "
                         f"got {grid_order!r}")
    if accum not in ACCUM_MODES:
        raise ValueError(f"accum must be one of {ACCUM_MODES}, "
                         f"got {accum!r}")
    if accum == "scratch" and grid_order[-1] != "k":
        raise ValueError(
            f"grid_order {grid_order!r} revisits the output block between "
            f"k-steps, which a single scratch accumulator cannot survive; "
            f"use accum='inplace' for k-outer orders")
    a3, b3, nb, squeeze = _as_batched(a, b)
    (m, k), n = a3.shape[1:], b3.shape[2]
    _validate(m, n, k, bm, bn, bk)
    epilogue = _check_epilogue(epilogue, bias, n, bn)
    out_dtype = out_dtype or a.dtype
    bias = _bias_row(bias, n, a.device)
    if _on_cpu(a3, b3, bias):
        out = output_stationary_plain(a3, b3, bk=bk, accum=accum,
                                      out_dtype=out_dtype,
                                      epilogue=epilogue, bias=bias)
    else:
        _no_backward("the STT GEMM templates", LATER_TRAINING, a3, b3, bias)
        dt, *views, n_ops, codes, params = _cuda_args(a3, b3, nb, out_dtype,
                                                      epilogue)
        out = torch.empty((nb, m, n), dtype=out_dtype, device=a.device)
        ws = (torch.empty((nb, m, n), dtype=torch.float32, device=a.device)
              if _ep.has_softmax(epilogue) else None)
        # n is the fast CTA index when it is the innermost output axis
        n_fast = int(grid_order.replace("k", "") == "mn")
        lib = _build.library("stt_gemm")
        _build.check(lib.stt_os_launch(
            dt, *views, out.data_ptr(), _ptr(ws), nb, m, n, k, bk,
            int(accum == "inplace"), n_fast, n_ops, codes, params,
            _ptr(bias), _stream()), "stt_os_launch")
        launches["output_stationary"] += 1
    return out[0] if squeeze else out


# ---------------------------------------------------------------------------
# operand-stationary (STS/TSS-class): operand resident, C strip accumulator
# ---------------------------------------------------------------------------

def matmul_operand_stationary(a: torch.Tensor, b: torch.Tensor, *,
                              stationary: str = "B",
                              bm: int = DEFAULT_BLOCK,
                              bn: int = DEFAULT_BLOCK,
                              bk: int = DEFAULT_BLOCK,
                              out_dtype=None,
                              strip_budget: Optional[int] =
                              DEFAULT_STRIP_BUDGET,
                              epilogue: Tuple[str, ...] = (),
                              bias=None) -> torch.Tensor:
    """``stationary='B'``: the B operand stays pinned while A streams down
    m (weight-stationary); ``stationary='A'`` is the symmetric
    input-stationary template, by transposition (C^T = B^T A^T with B^T
    stationary, batch dims untouched).

    On the card (``csrc/stt_gemm.cu``, ``ws_tile_kernel``) the bound is
    fp32 FLOPs on the CUDA cores.  Each CTA pins a ``WS_CHUNK_K`` x 128
    (or x 64 where 128-wide tiles would not fill the card) fp32 chunk of
    B in shared memory and streams A through it in 32-deep slabs, double
    buffered with one barrier a slab; every thread owns an 8 x 8 (or
    4 x 4) register tile read from shared memory as float4.  Operands
    are staged through registers, 4 elements a load along whichever axis
    has unit stride (gemm's ``B.T`` view is k-contiguous), element by
    element for other views.  The strip takes one vectorised
    read-modify-write per (m tile, chunk), its old values copied into
    shared memory while the tile is multiplied; the last chunk flushes
    from registers.  Sums are fp32 in a fixed order (ascending k in a chunk,
    chunks ascending), with no atomics; bf16 operands are converted at
    staging.  ``n <= 8`` keeps the first version's narrow kernel.

    The strip accumulator is (m, bn) fp32 per batch slice, growing with
    the *full* per-slice M extent.  ``strip_budget`` bounds it (None skips
    the check); ``ops.stt_matmul`` falls back to the output-stationary
    template instead of tripping this error.
    """
    if stationary == "A":
        if epilogue:
            # the transposition swaps the m/n axes, so a last-axis
            # epilogue would act on the wrong dimension; ops.stt_matmul
            # reroutes epilogue'd calls to the output-stationary template
            raise ValueError("epilogue fusion is not supported on the "
                             "input-stationary (stationary='A') "
                             "transposition path")
        out = matmul_operand_stationary(
            b.transpose(-1, -2), a.transpose(-1, -2), stationary="B",
            bm=bn, bn=bm, bk=bk, out_dtype=out_dtype,
            strip_budget=strip_budget)
        return out.transpose(-1, -2)
    if stationary != "B":
        raise ValueError(stationary)
    a3, b3, nb, squeeze = _as_batched(a, b)
    (m, k), n = a3.shape[1:], b3.shape[2]
    _validate(m, n, k, bm, bn, bk)
    epilogue = _check_epilogue(epilogue, bias, n, bn)
    strip = operand_stationary_strip_bytes(m, bn)
    if strip_budget is not None and strip > strip_budget:
        raise ValueError(
            f"operand-stationary strip accumulator needs {strip} bytes "
            f"per batch slice ((m={m}) x (bn={bn}) x 4B) but the budget "
            f"is {strip_budget}; shrink bn, tile m outside the kernel, or "
            f"use the output_stationary template (ops.stt_matmul falls "
            f"back automatically)")
    out_dtype = out_dtype or a.dtype
    bias = _bias_row(bias, n, a.device)
    if _on_cpu(a3, b3, bias):
        out = operand_stationary_plain(a3, b3, out_dtype=out_dtype,
                                       epilogue=epilogue, bias=bias)
    else:
        _no_backward("the STT GEMM templates", LATER_TRAINING, a3, b3, bias)
        dt, *views, n_ops, codes, params = _cuda_args(a3, b3, nb, out_dtype,
                                                      epilogue)
        out = torch.empty((nb, m, n), dtype=out_dtype, device=a.device)
        # the strip workspace: fp32 partial sums of every n-block
        ws = torch.empty((nb, m, n), dtype=torch.float32, device=a.device)
        lib = _build.library("stt_gemm")
        _build.check(lib.stt_ws_launch(
            dt, *views, out.data_ptr(), ws.data_ptr(), nb, m, n, k,
            int(_ep.has_softmax(epilogue)), n_ops, codes, params,
            _ptr(bias), _stream()), "stt_ws_launch")
        launches["operand_stationary"] += 1
    return out[0] if squeeze else out


# ---------------------------------------------------------------------------
# reduction-tree (K-spatial class): one full-K pass per output block
# ---------------------------------------------------------------------------

#: valid reduction-tree grid orders (no k axis: the whole reduction runs
#: in one pass)
RT_GRID_ORDERS = ("mn", "nm")


def matmul_reduction_tree(a: torch.Tensor, b: torch.Tensor, *,
                          bm: int = DEFAULT_BLOCK, bn: int = DEFAULT_BLOCK,
                          grid_order: str = "mn",
                          out_dtype=None,
                          epilogue: Tuple[str, ...] = (),
                          bias=None) -> torch.Tensor:
    if grid_order == "default":
        grid_order = "mn"
    if grid_order not in RT_GRID_ORDERS:
        raise ValueError(f"grid_order must be one of {RT_GRID_ORDERS}, "
                         f"got {grid_order!r}")
    a3, b3, nb, squeeze = _as_batched(a, b)
    (m, k), n = a3.shape[1:], b3.shape[2]
    _validate(m, n, k, bm, bn, k)
    epilogue = _check_epilogue(epilogue, bias, n, bn)
    out_dtype = out_dtype or a.dtype
    bias = _bias_row(bias, n, a.device)
    if _on_cpu(a3, b3, bias):
        out = reduction_tree_plain(a3, b3, out_dtype=out_dtype,
                                   epilogue=epilogue, bias=bias)
    else:
        _no_backward("the STT GEMM templates", LATER_TRAINING, a3, b3, bias)
        dt, *views, n_ops, codes, params = _cuda_args(a3, b3, nb, out_dtype,
                                                      epilogue)
        out = torch.empty((nb, m, n), dtype=out_dtype, device=a.device)
        ws = (torch.empty((nb, m, n), dtype=torch.float32, device=a.device)
              if _ep.has_softmax(epilogue) else None)
        lib = _build.library("stt_gemm")
        _build.check(lib.stt_rt_launch(
            dt, *views, out.data_ptr(), _ptr(ws), nb, m, n, k,
            int(grid_order == "mn"), n_ops, codes, params, _ptr(bias),
            _stream()), "stt_rt_launch")
        launches["reduction_tree"] += 1
    return out[0] if squeeze else out


TEMPLATES = {
    "output_stationary": matmul_output_stationary,
    "operand_stationary": matmul_operand_stationary,
    "reduction_tree": matmul_reduction_tree,
    # 'streaming' (all-unicast) has no reuse to exploit: realize as
    # reduction-tree (single pass, no residency) — documented equivalence.
    "streaming": matmul_reduction_tree,
}
