"""The graph-expressible dense layer, in PyTorch.

The torch twin of the reference's
``models/transformer.dense_layer_forward`` (the rest of that module — the
full model forward — arrives with the models slice).
"""
from __future__ import annotations

import math

import torch

from ..compile.pipeline import torch_dtype
from ..kernels import epilogue as epilogue_mod
from ..kernels.ops import resolve_device
from ..kernels.stt_gemm import _fp32_product


def dense_layer_forward(x, wq, wk, wv_t, wo, w1, b1, w2,
                        dtype: str = "float32", device=None
                        ) -> torch.Tensor:
    """One simplified dense-family layer, stage for stage the graph
    :func:`repro_torch.graph.from_model.transformer_layer_graph` builds:
    single head, no RoPE/GQA/norms, weights in the paper's ``(out, in)``
    storage so every projection is ``X @ W.T``; ``wv_t`` holds the value
    projection pre-transposed ``(dv, d)``.  Each stage accumulates in
    fp32, applies its epilogue in fp32, then casts to ``dtype`` — the
    flush the fused megakernel and the sequential dispatcher perform.

    Tensors stay on their device; array-likes go to ``device`` (the card
    by default).  Returns the post-MLP residual stream ``(l, d)``.
    """
    dt = torch_dtype(dtype)
    f32 = torch.float32
    dev = (x.device if isinstance(x, torch.Tensor)
           else resolve_device(device))

    def t(a):
        return torch.as_tensor(a, device=dev)

    def proj(a, w, epi=(), bias=None):
        acc = _fp32_product(t(a).to(dt), t(w).to(dt).T)
        if epi:
            acc = epilogue_mod.apply_epilogue(acc, epi, bias=bias)
        return acc.to(dt)

    d = t(x).shape[-1]
    q = proj(x, wq)
    k = proj(x, wk)
    vt = proj(wv_t, x)                     # (dv, l): values, born transposed
    p = proj(q, k, epi=(f"scale:{1.0 / math.sqrt(d)}", "softmax"))
    a = proj(p, vt)                        # vt lands on the rhs: p @ vt.T
    o = proj(a, wo)
    r1 = (o.to(f32) + t(x).to(f32)).to(dt)
    h = proj(r1, w1, epi=("bias", "gelu"), bias=t(b1).to(f32))
    y = proj(h, w2)
    return (y.to(f32) + r1.to(f32)).to(dt)
