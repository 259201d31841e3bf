"""TensorLib compile pipeline for the port: (TensorAlgebra, Dataflow) ->
executable.

Public API:
    lower                  — plan + lower + tile + cache -> CompiledKernel
    lower_group            — a merged graph group -> CompiledGroupKernel
    lower_form/LoweredForm — algebra lowering onto the batched-matmul
                             templates
    default_dataflow       — output-stationary STT over the first three loops
    cache_info / cache_clear / cache_resize — bounded-LRU compile cache
"""
from .lowering import LoweredForm, OperandSparsity, lower_form
from .pipeline import (CompiledGroupKernel, CompiledKernel,
                       DEFAULT_CACHE_CAPACITY, VALIDATE_MACS_LIMIT,
                       cache_clear, cache_info, cache_resize,
                       default_dataflow, lower, lower_group)

__all__ = [
    "CompiledGroupKernel", "CompiledKernel", "DEFAULT_CACHE_CAPACITY",
    "LoweredForm", "OperandSparsity", "VALIDATE_MACS_LIMIT", "cache_clear",
    "cache_info", "cache_resize", "default_dataflow", "lower",
    "lower_form", "lower_group",
]
