"""Epilogue ops fused into the GEMM templates' output-block flush.

The port of the reference's ``kernels/epilogue.py``: the same grammar,
the same validation, a torch ``apply_epilogue`` (the plain version of
what the CUDA flush computes) and the numpy mirror ``apply_epilogue_np``.

Spec grammar (hashable, usable as a cache-key component)::

    ("scale:0.125", "softmax")       # attention score epilogue
    ("bias", "gelu")                 # MLP hidden epilogue

* ``scale:<float>`` — multiply by a constant,
* ``bias``          — add a rank-1 bias over the last (n) axis,
* unary activations — ``relu`` / ``gelu`` / ``silu`` / ``tanh`` /
  ``exp``,
* ``softmax``       — row softmax over the last axis.  Only legal when
  one output block spans the *entire unpadded* n extent (``bn == n``);
  ``ops.stt_matmul`` enforces this.

``gelu`` is the tanh approximation, as the reference's
``jax.nn.gelu(approximate=True)``; torch's default is the erf form, so
the port passes ``approximate="tanh"``.

``OPCODES`` is the encoding the CUDA flush reads: one integer per op
plus one float parameter (the scale factor, else 0).
"""
from __future__ import annotations

import math
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

#: an ordered, hashable epilogue: tuple of op strings
EpilogueSpec = Tuple[str, ...]


def _softmax(x: torch.Tensor) -> torch.Tensor:
    m = torch.amax(x, dim=-1, keepdim=True)
    e = torch.exp(x - m)
    return e / torch.sum(e, dim=-1, keepdim=True)


_UNARY = {
    "relu": torch.relu,
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    "silu": lambda x: x * torch.sigmoid(x),
    "tanh": torch.tanh,
    "exp": torch.exp,
    "softmax": _softmax,
}

#: op name -> opcode of the CUDA flush (csrc/stt_gemm.cu, ``Op``)
OPCODES = {"scale": 0, "bias": 1, "relu": 2, "gelu": 3, "silu": 4,
           "tanh": 5, "exp": 6, "softmax": 7}

#: most ops one epilogue may carry on the CUDA path (``Epi::MAX_OPS``)
MAX_OPS = 8


def parse_op(op: str) -> Tuple[str, Optional[float]]:
    """``"name"`` or ``"name:param"`` -> (name, param).  Raises on ops
    outside the registry (the spec doubles as a cache-key component, so
    unknown strings must fail loudly, not silently no-op)."""
    name, _, param = op.partition(":")
    if name == "scale":
        try:
            return name, float(param)
        except ValueError:
            raise ValueError(f"scale epilogue needs a float parameter, "
                             f"got {op!r}") from None
    if param:
        raise ValueError(f"epilogue op {name!r} takes no parameter "
                         f"(got {op!r})")
    if name == "bias" or name in _UNARY:
        return name, None
    raise ValueError(f"unknown epilogue op {op!r}; known: "
                     f"{sorted(_UNARY) + ['bias', 'scale:<f>']}")


def validate_spec(spec: Iterable[str]) -> EpilogueSpec:
    """Normalize to a tuple and validate every op; at most one ``bias``
    (the templates stream exactly one bias operand)."""
    out = tuple(spec)
    for op in out:
        parse_op(op)
    if sum(1 for op in out if op == "bias") > 1:
        raise ValueError(f"epilogue {out} has more than one 'bias' op")
    return out


def needs_bias(spec: Iterable[str]) -> bool:
    return "bias" in tuple(spec)


def has_softmax(spec: Iterable[str]) -> bool:
    return "softmax" in tuple(spec)


def encode(spec: Iterable[str]) -> Tuple[Tuple[int, ...],
                                          Tuple[float, ...]]:
    """(opcodes, params) for the CUDA flush."""
    codes, params = [], []
    for op in spec:
        name, param = parse_op(op)
        codes.append(OPCODES[name])
        params.append(0.0 if param is None else float(param))
    if len(codes) > MAX_OPS:
        raise ValueError(f"epilogue {tuple(spec)} has more than {MAX_OPS} "
                         f"ops, the CUDA flush's limit")
    return tuple(codes), tuple(params)


def apply_epilogue(x: torch.Tensor, spec: Iterable[str], *,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply the spec to ``x`` (last axis = n), in ``x``'s dtype."""
    for op in spec:
        name, param = parse_op(op)
        if name == "scale":
            x = x * torch.tensor(param, dtype=x.dtype, device=x.device)
        elif name == "bias":
            if bias is None:
                raise ValueError("epilogue 'bias' needs a bias operand")
            x = x + bias.to(x.dtype)
        else:
            x = _UNARY[name](x)
    return x


# ---------------------------------------------------------------------------
# numpy mirror — the oracle's epilogue reference
# ---------------------------------------------------------------------------

def _np_gelu(x):
    # tanh approximation, as jax.nn.gelu(approximate=True)
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + np.tanh(c * (x + 0.044715 * x ** 3)))


def _np_softmax(x):
    m = np.max(x, axis=-1, keepdims=True)
    e = np.exp(x - m)
    return e / np.sum(e, axis=-1, keepdims=True)


_UNARY_NP = {
    "relu": lambda x: np.maximum(x, 0.0),
    "gelu": _np_gelu,
    "silu": lambda x: x / (1.0 + np.exp(-x)),
    "tanh": np.tanh,
    "exp": np.exp,
    "softmax": _np_softmax,
}


def apply_epilogue_np(x: np.ndarray, spec: Iterable[str], *,
                      bias: Optional[np.ndarray] = None) -> np.ndarray:
    """numpy mirror of :func:`apply_epilogue` (fp64 oracle)."""
    x = np.asarray(x, dtype=np.float64)
    for op in spec:
        name, param = parse_op(op)
        if name == "scale":
            x = x * param
        elif name == "bias":
            if bias is None:
                raise ValueError("epilogue 'bias' needs a bias operand")
            x = x + np.asarray(bias, dtype=np.float64)
        else:
            x = _UNARY_NP[name](x)
    return x
