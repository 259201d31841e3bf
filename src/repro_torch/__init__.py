"""repro_torch — TensorLib (spatial accelerator generation) on PyTorch and
CUDA for the NVIDIA H100.

The PyTorch port of the JAX/Pallas package ``repro``, which stays the
reference.  The one front door:

    import repro_torch
    acc = repro_torch.generate("gemm", "output_stationary")  # on the card
    c = acc({"A": a, "B": b})

``repro_torch.generate`` runs classification -> plan -> compile and
returns a :class:`repro_torch.api.Accelerator` (or, for an
:class:`AlgebraGraph`, a ``GraphAccelerator`` whose merged groups run as
fused megakernels); ``repro_torch.search`` ranks the design space so
``generate(search=...)`` can consume it, and ``search_graph`` plans a
whole graph.  The
attribute hook below keeps ``import repro_torch`` light: torch is loaded
only when the front door is used.
"""
from typing import TYPE_CHECKING

__all__ = ["Accelerator", "AlgebraGraph", "GraphNode", "Sparsity",
           "generate", "search", "search_graph"]

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .api import Accelerator, generate
    from .core.algebra import Sparsity
    from .core.dse import search, search_graph
    from .graph.ir import AlgebraGraph, GraphNode


def __getattr__(name):
    if name in ("generate", "Accelerator"):
        from . import api
        return getattr(api, name)
    if name in ("search", "search_graph"):
        from .core import dse
        return getattr(dse, name)
    if name in ("AlgebraGraph", "GraphNode"):
        from .graph import ir
        return getattr(ir, name)
    if name == "Sparsity":
        from .core.algebra import Sparsity
        return Sparsity
    # plain submodule access (`import repro_torch; repro_torch.compile`)
    import importlib
    try:
        return importlib.import_module(f".{name}", __name__)
    except ModuleNotFoundError:
        raise AttributeError(
            f"module 'repro_torch' has no attribute {name!r}") from None
