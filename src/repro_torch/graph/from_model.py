"""Whole-model graph export — the dense family's per-layer forward as an
:class:`~repro_torch.graph.ir.AlgebraGraph`.

:func:`transformer_layer_graph` emits the simplified single-head layer that
:func:`repro_torch.models.transformer.dense_layer_forward` computes, in the
paper's ``(out, in)`` weight storage:

    q  = x @ wq.T                  k  = x @ wk.T
    vt = wv_t @ x.T                            (values born transposed)
    p  = softmax(q @ k.T / sqrt(d))
    a  = p @ vt.T                              (vt lands on attend's rhs)
    r1 = a @ wo.T + x                          (residual folds into oproj)
    h  = gelu(r1 @ w1.T + b1)
    out = h @ w2.T + r1                        (standalone add; r1 tapped)

Under :func:`repro_torch.graph.planner.plan_graph` the eight algebra nodes merge
into ONE dag-kind group spanning attention and the MLP: the ``k`` and
``vt`` edges fuse on consumer rhs sides (zero materialised transposes),
``res1`` folds into ``oproj`` as a streamed residual, and ``r1`` — read by
both the MLP up-projection (in-group) and the final residual add
(out-of-group) — is exported as a tap, so the closing ``add`` reads it
from HBM without re-running attention.

PyTorch port: a copy of the reference's ``graph/from_model.py``; its
``layer_oracle`` runs the port's torch twin of ``dense_layer_forward``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

from ..configs.base import ModelConfig
from ..core.algebra import get_algebra
from .ir import AlgebraGraph, GraphNode

LAYER_INPUTS = ("x", "wq", "wk", "wv_t", "wo", "w1", "b1", "w2")


def transformer_layer_graph(l: int = 64, d: int = 64,
                            dv: Optional[int] = None,
                            f: Optional[int] = None) -> AlgebraGraph:
    """One dense-family layer (seq ``l``, model dim ``d``, value dim
    ``dv``, hidden ``f``) as an algebra graph with residual taps."""
    dv = d if dv is None else dv
    f = 2 * d if f is None else f
    scale = f"scale:{1.0 / math.sqrt(d)}"
    nodes = (
        GraphNode(name="qp", inputs=("x", "wq"), output="q",
                  algebra=get_algebra("gemm", m=l, n=d, k=d)),
        GraphNode(name="kp", inputs=("x", "wk"), output="k",
                  algebra=get_algebra("gemm", m=l, n=d, k=d)),
        GraphNode(name="vtp", inputs=("wv_t", "x"), output="vt",
                  algebra=get_algebra("gemm", m=dv, n=l, k=d)),
        GraphNode(name="scores", inputs=("q", "k"), output="s_raw",
                  algebra=get_algebra("gemm", m=l, n=l, k=d)),
        GraphNode(name="scale", inputs=("s_raw",), output="s_scaled",
                  op=scale),
        GraphNode(name="softmax", inputs=("s_scaled",), output="p",
                  op="softmax"),
        GraphNode(name="attend", inputs=("p", "vt"), output="a",
                  algebra=get_algebra("gemm", m=l, n=dv, k=l)),
        GraphNode(name="oproj", inputs=("a", "wo"), output="o",
                  algebra=get_algebra("gemm", m=l, n=d, k=dv)),
        GraphNode(name="res1", inputs=("o", "x"), output="r1", op="add"),
        GraphNode(name="up", inputs=("r1", "w1"), output="h_raw",
                  algebra=get_algebra("gemm", m=l, n=f, k=d)),
        GraphNode(name="bias1", inputs=("h_raw", "b1"), output="h_biased",
                  op="bias"),
        GraphNode(name="act", inputs=("h_biased",), output="h", op="gelu"),
        GraphNode(name="down", inputs=("h", "w2"), output="y",
                  algebra=get_algebra("gemm", m=l, n=d, k=f)),
        GraphNode(name="res2", inputs=("y", "r1"), output="out", op="add"),
    )
    return AlgebraGraph(nodes=nodes, inputs=LAYER_INPUTS, output="out")


def layer_graph_from_config(cfg: ModelConfig,
                            l: int = 64) -> AlgebraGraph:
    """Export one layer of a dense-family :class:`ModelConfig` (its
    ``d_model``/``d_ff``) at sequence length ``l``."""
    if cfg.family not in ("dense", "moe"):
        raise ValueError(
            f"only the dense family is graph-exportable, got {cfg.family!r}")
    return transformer_layer_graph(l=l, d=cfg.d_model, dv=cfg.d_model,
                                   f=cfg.d_ff)


def layer_oracle(operands: Dict[str, "object"], dtype: str = "float32"):
    """Run :func:`repro_torch.models.transformer.dense_layer_forward` on a
    graph-operand dict (edge name -> array), for bit-parity checks."""
    from ..models.transformer import dense_layer_forward

    return dense_layer_forward(*(operands[e] for e in LAYER_INPUTS),
                               dtype=dtype)
