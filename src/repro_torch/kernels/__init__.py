"""Hand-written Hopper kernels for the hot spots, selected by STT plans.

Modules:
    stt_gemm  — GEMM templates (output/operand-stationary, reduction),
                CUDA kernels in ``csrc/stt_gemm.cu`` plus plain versions
    epilogue  — the flush's op grammar, torch and numpy
    ops       — public wrapper (padding, accumulation policy, dispatch)
    ref       — plain PyTorch oracles
    _build    — nvcc build and ctypes loading, at first use
"""
from . import epilogue, ops, ref, stt_gemm

__all__ = ["epilogue", "ops", "ref", "stt_gemm"]
