"""Reference chains: AlgebraGraph constructors + the explicit-schedule
oracle.

The port of the reference's ``models/chains.py`` (which imports jax, so
this is a rewrite): the same graph constructors, and the oracles in
PyTorch — every gemm one fp32 product, scale/softmax/bias/gelu through
the port's ``kernels/epilogue.py``.

Layout conventions follow the paper's gemm (``C[m,n] += A[m,k]*B[n,k]``,
i.e. the B operand is stored (n, k) and used transposed): attention takes
``K`` as (Lkv, d) and ``Vt`` as (dv, Lkv); MLP weights are stored
(out_features, in_features).

The oracles keep tensors on their device and send array-likes to the
card unless ``device=`` says otherwise.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from ..core.algebra import get_algebra
from ..graph.ir import AlgebraGraph, GraphNode
from ..kernels import epilogue as epilogue_mod
from ..kernels.ops import resolve_device
from ..kernels.stt_gemm import _fp32_product


def _scale_op(d: int) -> str:
    return f"scale:{1.0 / math.sqrt(d)}"


# ---------------------------------------------------------------------------
# Graph constructors
# ---------------------------------------------------------------------------

def attention_graph(lq: int = 64, lkv: int = 64, d: int = 64,
                    dv: int = 64, prefix: str = "",
                    q_edge: str = "Q") -> AlgebraGraph:
    """Single-head attention as a graph:
    ``softmax(Q @ K.T / sqrt(d)) @ V`` with ``K`` (lkv, d) and ``Vt``
    (dv, lkv) in the paper's (n, k) operand layout."""
    p = prefix
    nodes = (
        GraphNode(name=f"{p}scores", inputs=(q_edge, f"{p}K"),
                  output=f"{p}s_raw", algebra=get_algebra(
                      "gemm", m=lq, n=lkv, k=d)),
        GraphNode(name=f"{p}scale", inputs=(f"{p}s_raw",),
                  output=f"{p}s_scaled", op=_scale_op(d)),
        GraphNode(name=f"{p}softmax", inputs=(f"{p}s_scaled",),
                  output=f"{p}probs", op="softmax"),
        GraphNode(name=f"{p}attend", inputs=(f"{p}probs", f"{p}Vt"),
                  output=f"{p}attn", algebra=get_algebra(
                      "gemm", m=lq, n=dv, k=lkv)),
    )
    return AlgebraGraph(nodes=nodes,
                        inputs=(q_edge, f"{p}K", f"{p}Vt"),
                        output=f"{p}attn")


def mlp_graph(l: int = 64, d: int = 64, f: int = 128,
              d_out: Optional[int] = None, prefix: str = "",
              x_edge: str = "x") -> AlgebraGraph:
    """gemm·bias·gelu·gemm: ``gelu(x @ W1.T + b1) @ W2.T`` with weights
    stored (out_features, in_features)."""
    p = prefix
    d_out = d if d_out is None else d_out
    nodes = (
        GraphNode(name=f"{p}up", inputs=(x_edge, f"{p}W1"),
                  output=f"{p}h_raw", algebra=get_algebra(
                      "gemm", m=l, n=f, k=d)),
        GraphNode(name=f"{p}bias1", inputs=(f"{p}h_raw", f"{p}b1"),
                  output=f"{p}h_biased", op="bias"),
        GraphNode(name=f"{p}act", inputs=(f"{p}h_biased",),
                  output=f"{p}h", op="gelu"),
        GraphNode(name=f"{p}down", inputs=(f"{p}h", f"{p}W2"),
                  output=f"{p}y", algebra=get_algebra(
                      "gemm", m=l, n=d_out, k=f)),
    )
    return AlgebraGraph(nodes=nodes,
                        inputs=(x_edge, f"{p}W1", f"{p}b1", f"{p}W2"),
                        output=f"{p}y")


def attention_mlp_graph(lq: int = 64, lkv: int = 64, d: int = 64,
                        dv: int = 64, f: int = 128,
                        d_out: Optional[int] = None) -> AlgebraGraph:
    """The 2-layer acceptance chain: attention feeding an MLP, six
    algebra nodes + four epilogue nodes in one DAG.  The attention
    output edge fuses straight into the MLP's up-projection lhs."""
    attn = attention_graph(lq, lkv, d, dv)
    mlp = mlp_graph(lq, dv, f, d_out, prefix="mlp_", x_edge="attn")
    return AlgebraGraph(nodes=attn.nodes + mlp.nodes,
                        inputs=attn.inputs + tuple(
                            e for e in mlp.inputs if e != "attn"),
                        output=mlp.output)


# ---------------------------------------------------------------------------
# Explicit-schedule oracles
# ---------------------------------------------------------------------------

def _tensors(*xs, device=None):
    dev = next((x.device for x in xs if isinstance(x, torch.Tensor)),
               None)
    dev = dev if dev is not None else resolve_device(device)
    return [torch.as_tensor(x, device=dev).to(torch.float32) for x in xs]


def attention_oracle(q, k, vt, device=None) -> torch.Tensor:
    q, k, vt = _tensors(q, k, vt, device=device)
    s = _fp32_product(q, k.T)
    probs = epilogue_mod.apply_epilogue(s, (_scale_op(q.shape[-1]),
                                            "softmax"))
    return _fp32_product(probs, vt.T)


def mlp_oracle(x, w1, b1, w2, device=None) -> torch.Tensor:
    x, w1, b1, w2 = _tensors(x, w1, b1, w2, device=device)
    h = epilogue_mod.apply_epilogue(_fp32_product(x, w1.T),
                                    ("bias", "gelu"), bias=b1)
    return _fp32_product(h, w2.T)


def attention_mlp_oracle(operands: Dict[str, object],
                         device=None) -> torch.Tensor:
    """Oracle over the operand dict of :func:`attention_mlp_graph`."""
    attn = attention_oracle(operands["Q"], operands["K"], operands["Vt"],
                            device=device)
    return mlp_oracle(attn, operands["mlp_W1"], operands["mlp_b1"],
                      operands["mlp_W2"])
