"""Hand-written Hopper kernels for the hot spots, selected by STT plans.

Modules:
    stt_gemm  — GEMM templates (output/operand-stationary, reduction),
                CUDA kernels in ``csrc/stt_gemm.cu`` plus plain versions
    bsr_gemm  — block-sparse GEMM, ``csrc/bsr_gemm.cu``
    fused_chain — merged-group megakernels (chain and DAG),
                ``csrc/fused_chain.cu``
    paged     — paged-cache gather, ``csrc/paged.cu``
    flash_attention — blockwise online-softmax attention,
                ``csrc/flash_attention.cu``
    ssd_scan  — Mamba-2 chunked SSD scan, ``csrc/ssd_scan.cu``
    epilogue  — the flush's op grammar, torch and numpy
    ops       — public wrappers (padding, accumulation policy, dispatch,
                attention, SSD)
    ref       — plain PyTorch oracles
    _build    — nvcc build and ctypes loading, at first use
"""
from . import (bsr_gemm, epilogue, flash_attention, fused_chain, ops, paged,
               ref, ssd_scan, stt_gemm)

__all__ = ["bsr_gemm", "epilogue", "flash_attention", "fused_chain", "ops",
           "paged", "ref", "ssd_scan", "stt_gemm"]
