"""Carry a reference accelerator's state across to the port.

``from_reference`` takes an ``Accelerator`` or ``CompiledKernel`` of the
JAX reference package by its attributes alone — the port never imports
the reference — and returns the port's equivalent with the same plan:
algebra (name, bounds, sparsity coordinates), dataflow (loop selection
and T), blocks, stationary operand, grid order, accumulation, epilogue
and dtype.  ``operands_to`` moves numpy operands onto a device.  The
parity tests use both so that the two packages run the same plan on the
same data.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .api import Accelerator
from .compile import lower
from .compile.pipeline import CompiledKernel
from .core.algebra import Sparsity, get_algebra
from .core.stt import apply_stt
from .core.tiling import ArrayConfig
from .kernels.ops import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _config(ref_cfg) -> ArrayConfig:
    return ArrayConfig(
        pe_dims=tuple(ref_cfg.pe_dims), freq_mhz=ref_cfg.freq_mhz,
        onchip_gbps=ref_cfg.onchip_gbps, elem_bytes=ref_cfg.elem_bytes,
        strip_budget_bytes=ref_cfg.vmem_budget_bytes)


def kernel_from_reference(ref, *, device=None,
                          validate: bool = False) -> CompiledKernel:
    """The port's CompiledKernel for a reference CompiledKernel."""
    ref_alg, ref_df = ref.algebra, ref.dataflow
    alg = get_algebra(ref_alg.name, **dict(zip(ref_alg.loops,
                                               ref_alg.bounds)))
    if ref_alg.sparsity:
        alg = alg.with_sparsity(**{
            name: Sparsity(tuple(sp.block), tuple(map(tuple, sp.coords)))
            for name, sp in ref_alg.sparsity})
    df = apply_stt(alg, tuple(ref_df.selected),
                   tuple(tuple(int(v) for v in row) for row in ref_df.T))
    dtype_name = getattr(ref.dtype, "name", str(ref.dtype))
    kernel = lower(alg, df, cfg=_config(ref.cfg), dtype=_DTYPES[dtype_name],
                   device=resolve_device(device), validate=validate,
                   blocks=tuple(ref.blocks), grid_order=ref.grid_order,
                   accum=ref.accum, epilogue=tuple(ref.epilogue),
                   bias_tensor=ref.bias_tensor)
    if kernel.stationary != ref.stationary:
        raise ValueError(f"the port pins operand {kernel.stationary} where "
                         f"the reference pins {ref.stationary}")
    return kernel


def from_reference(ref, *, device=None, validate: bool = False):
    """A reference ``Accelerator`` becomes a port ``Accelerator``; a
    reference ``CompiledKernel`` becomes a port ``CompiledKernel``."""
    if hasattr(ref, "kernel"):
        return Accelerator(kernel_from_reference(
            ref.kernel, device=device, validate=validate))
    return kernel_from_reference(ref, device=device, validate=validate)


def operands_to(operands: Mapping[str, object], device=None
                ) -> Dict[str, torch.Tensor]:
    """numpy (or array-like) operands -> tensors on ``device``."""
    dev = resolve_device(device)
    return {name: torch.as_tensor(np.asarray(v), device=dev)
            for name, v in operands.items()}
