"""Per-device operations, memory traffic, collective wire bytes and peak
memory of one rank's program, counted as it runs.

The port's counterpart of the reference's ``launch/hlo_analysis.py``.
The reference parses the compiled HLO text; the port has no HLO: its
program is eager PyTorch, every aten op a kernel of its own.  So
:class:`OpAnalysis` is a ``TorchDispatchMode`` that sees each aten op,
collective and hand-written kernel launch of the program as it runs —
on ``meta`` tensors in a fake world of ranks (``launch.mesh.fake_world``:
no memory, no device) as well as on the card or the CPU.  The
reference's rules, one by one:

* **operations** (``_dot_flops``): each ``mm`` / ``bmm`` / ``addmm`` /
  ``baddbmm`` (and ``mv``, ``dot``) counts 2·|lhs|·|rhs free|, the
  reference's dot rule; a convolution counts 2 multiply-adds an output
  element and kernel tap (the reference's models have none on these
  paths).  Elementwise work counts nothing, as there.  A hand-written
  kernel launched on ``meta`` adds the operations of its module's
  ``cost()`` (``kernels.flash_attention.cost``, ``kernels.ssd_scan.cost``,
  ``kernels.paged.cost``), the formulas behind its bound;
* **bytes** (the reference's top-level ops outside fusions): the
  operands plus the results of every aten op that moves data; view ops
  and the counterparts of ``_NO_TRAFFIC`` (allocations, detach, the
  collectives' own buffers) count nothing, and a kernel adds its
  ``cost()`` bytes;
* **collectives** (``_WIRE_FACTOR``, the reference's table, kept here):
  each ``c10d`` all-gather, all-reduce, reduce-scatter, all-to-all and
  receive seen under the mode is charged its result's bytes by the
  factor of its kind and its group's size (a receive is the
  ``collective-permute``); per device, as in the reference;
* **loops**: none to scale.  The port's layers are a Python loop, so
  each layer's ops are seen; the reference's ``trip_counts`` has no
  counterpart (its place in a record holds ``kernel_launches``);
* **memory**: ``peak_live_bytes`` is the most bytes of live storages
  the program holds at once, the ones it was handed (``held``) and the
  ones it allocates, each storage counted once whatever its views, from
  its allocation to its release — the counterpart of
  ``temp_size_in_bytes`` plus the arguments.

On the card the kernels' ctypes launches bypass the dispatcher: there
only their ``launches`` counts see them.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from collections import defaultdict
from typing import Dict, Iterable, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..core.hopper import H100
from ..kernels import stt_gemm

#: bytes an element, by the reference's HLO type names
_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}

#: the torch dtypes of those names
HLO_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.float16: "f16", torch.bfloat16: "bf16",
    torch.int32: "s32", torch.float32: "f32", torch.int64: "s64",
    torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
    torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e5m2: "f8e5m2",
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: the reference's wire bytes a device: a result of ``b`` bytes over a
#: group of ``g`` (ring all-reduce = reduce-scatter + all-gather)
_WIRE_FACTOR = {
    "all-gather": lambda b, g: b * (g - 1) / g,
    "all-reduce": lambda b, g: 2.0 * b * (g - 1) / g,
    "reduce-scatter": lambda b, g: b * (g - 1),
    "all-to-all": lambda b, g: b * (g - 1) / g,
    "collective-permute": lambda b, g: float(b),
}

#: c10d op -> (kind, the argument index of its result)
_C10D = {
    "allgather_": ("all-gather", 0),
    "_allgather_base_": ("all-gather", 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 0),
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "reduce_scatter_": ("reduce-scatter", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0),
    "alltoall_": ("all-to-all", 0),
    "alltoall_base_": ("all-to-all", 0),
    "recv_": ("collective-permute", 0),
}

#: aten ops that move no data (the reference's ``_NO_TRAFFIC``: a
#: parameter, a constant, a bitcast, an allocation)
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "detach", "alias",
               "lift_fresh", "_local_scalar_dense", "set_", "resize_",
               "record_stream", "_has_compatible_shallow_copy_type",
               "is_same_size", "sym_size", "sym_stride", "sym_numel",
               "sym_storage_offset"}

_DOTS = {"mm", "bmm", "addmm", "baddbmm", "mv", "addmv", "dot", "addbmm"}
_CONVS = {"convolution", "_convolution", "conv1d", "conv2d"}


def dtype_bytes(dtype: torch.dtype) -> int:
    """Bytes an element, by the reference's table."""
    return _DTYPE_BYTES[HLO_NAMES[dtype]]


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * dtype_bytes(t.dtype)


@dataclasses.dataclass
class OpStats:
    """The reference's ``HloStats`` fields, plus the kernels' share, the
    wire bytes by link and the peak of live storage."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    wire_bytes: float = 0.0
    collective_counts: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    wire_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    dot_flops_by_name: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    kernel_launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    kernel_flops: float = 0.0
    kernel_bytes: float = 0.0
    #: wire bytes over groups within one node (``nvlink``) and across
    #: nodes (``network``)
    wire_by_link: Dict[str, float] = dataclasses.field(default_factory=dict)
    peak_live_bytes: int = 0

    @property
    def dot_flops(self) -> float:
        """The aten dots' operations (the kernels' excluded)."""
        return sum(self.dot_flops_by_name.values())

    def as_dict(self) -> Dict:
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "wire_bytes": self.wire_bytes,
                "collective_counts": dict(self.collective_counts),
                "wire_by_kind": dict(self.wire_by_kind),
                "dot_flops_by_name": dict(self.dot_flops_by_name),
                "kernel_launches": dict(self.kernel_launches),
                "kernel_flops": self.kernel_flops,
                "kernel_bytes": self.kernel_bytes,
                "wire_by_link": dict(self.wire_by_link),
                "peak_live_bytes": self.peak_live_bytes}


def _shape(t: torch.Tensor) -> str:
    return "x".join(str(d) for d in t.shape) or "()"


def _dot_flops(name: str, args) -> float:
    """2·|lhs|·|rhs free| of a dot (the bias of ``addmm`` & co. first)."""
    if name in ("addmm", "baddbmm", "addmv", "addbmm"):
        args = args[1:]
    lhs, rhs = args[0], args[1]
    free = 1 if rhs.dim() == 1 else rhs.shape[-1]
    return 2.0 * lhs.numel() * free


def _conv_flops(args, out: torch.Tensor) -> float:
    """2 multiply-adds an output element and kernel tap."""
    weight = args[1]
    return 2.0 * out.numel() * math.prod(weight.shape[1:])


def _link(ranks) -> str:
    """The link a group's collectives cross: NVLink where its ranks lie
    within one node of ``H100.node_gpus``, else the network."""
    return ("nvlink" if len({r // H100.node_gpus for r in ranks}) == 1
            else "network")


class OpAnalysis(TorchDispatchMode):
    """Count one rank's program (module docstring) while it runs inside
    the ``with`` block; :attr:`stats` holds the :class:`OpStats`.

    ``held``: the tensors the program is handed (their storages count in
    ``peak_live_bytes`` from the start, each once).  ``device``: the
    device a ``meta`` tensor stands for (``kernels.stt_gemm.modelling``:
    ``"cuda"``, the card's routes, or ``"cpu"``, the plain ones)."""

    def __init__(self, held: Iterable[torch.Tensor] = (),
                 device: str = "cuda"):
        super().__init__()
        self.stats = OpStats()
        self.device = device
        self._counts: Dict[str, int] = defaultdict(int)
        self._wire: Dict[str, float] = defaultdict(float)
        self._links: Dict[str, float] = defaultdict(float)
        self._dots: Dict[str, float] = defaultdict(float)
        self._launches: Dict[str, int] = defaultdict(int)
        self._live: Dict[int, weakref.ref] = {}
        self._live_bytes = 0
        self._held = [t for t in tree_flatten(list(held))[0]
                      if isinstance(t, torch.Tensor)]
        self._model = None

    # -- the block ----------------------------------------------------------
    def __enter__(self):
        self._model = stt_gemm.modelling(self.device)
        self._model.__enter__()
        stt_gemm.COST_SINKS.append(self._kernel)
        for t in self._held:
            self._track(t)
        self._held = []
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        stt_gemm.COST_SINKS.remove(self._kernel)
        self._model.__exit__(*exc)
        s = self.stats
        s.collective_counts = dict(self._counts)
        s.wire_by_kind = dict(self._wire)
        s.wire_by_link = dict(self._links)
        s.dot_flops_by_name = dict(self._dots)
        s.kernel_launches = dict(self._launches)
        return out

    # -- memory -------------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()

        def gone(_, key=key, n=n):
            if self._live.pop(key, None) is not None:
                self._live_bytes -= n
        self._live[key] = weakref.ref(st, gone)
        self._live_bytes += n
        if self._live_bytes > self.stats.peak_live_bytes:
            self.stats.peak_live_bytes = self._live_bytes

    # -- charges ------------------------------------------------------------
    def _kernel(self, name: str, flops: float, nbytes: float) -> None:
        s = self.stats
        self._launches[name] += 1
        s.kernel_flops += flops
        s.kernel_bytes += nbytes
        s.flops += flops
        s.hbm_bytes += nbytes

    def _collective(self, op: str, args) -> None:
        kind, at = _C10D[op]
        pg = next(a for a in args if isinstance(a, torch.ScriptObject))
        pg = dist.ProcessGroup.unbox(pg)
        g = pg.size()
        res = tree_flatten(args[at])[0]
        b = sum(tensor_bytes(t) for t in res if isinstance(t, torch.Tensor))
        w = _WIRE_FACTOR[kind](b, max(g, 1))
        s = self.stats
        s.wire_bytes += w
        self._counts[kind] += 1
        self._wire[kind] += w
        if g > 1:
            self._links[_link(dist.get_process_group_ranks(pg))] += w

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        flat_out = [t for t in tree_flatten(out)[0]
                    if isinstance(t, torch.Tensor)]
        for t in flat_out:
            self._track(t)
        if ns == "c10d":
            if name in _C10D:
                self._collective(name, args)
            return out
        if func.is_view or name in _NO_TRAFFIC:
            return out
        s = self.stats
        if name in _DOTS:
            f = _dot_flops(name, args)
            s.flops += f
            self._dots[f"aten.{name} " + " @ ".join(
                _shape(a) for a in args if isinstance(a, torch.Tensor))] += f
        elif name in _CONVS:
            f = _conv_flops(args, flat_out[0])
            s.flops += f
            self._dots[f"aten.{name} {_shape(args[0])} * "
                       f"{_shape(args[1])}"] += f
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        s.hbm_bytes += sum(tensor_bytes(t) for t in ins + flat_out)
        return out


def analyze(fn, *args, held: Optional[Iterable[torch.Tensor]] = None,
            device: str = "cuda", **kwargs):
    """``(fn(*args, **kwargs), OpStats)``: one call counted.  ``held``
    defaults to the tensors of ``args``."""
    mode = OpAnalysis(args if held is None else held, device=device)
    with mode:
        out = fn(*args, **kwargs)
    return out, mode.stats
