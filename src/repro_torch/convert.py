"""Carry a reference accelerator's state across to the port.

``from_reference`` takes an ``Accelerator``, ``CompiledKernel``,
``AlgebraGraph`` or ``GraphAccelerator`` of the JAX reference package by
its attributes alone — the port never imports the reference — and
returns the port's equivalent: for a kernel the same plan (algebra with
its bounds and sparsity coordinates, dataflow selection and T, blocks,
stationary operand, grid order, accumulation, epilogue, dtype); for a
graph the same nodes and edges; for a graph accelerator the port's
build of that graph under the same array config, dtype and merge
setting, which plans to the same decisions.  ``operands_to`` moves numpy
operands (an algebra's tensor dict or a graph's edge dict) onto a
device.  The parity tests use these so that the two packages run the
same plan on the same data.  ``params_from_reference`` carries a
reference model's parameters (the nested dict of stacked numpy arrays
that ``jax.tree.map(np.asarray, split(init_params(key, cfg))[0])``
gives, for any family: the MoE's router and expert stacks, the encdec
encoder and cross layers, the vlm cross layers and gates) across to the
port's models, leaf for leaf; ``train_state_from_reference`` carries a
reference ``TrainState`` (parameters and AdamW state as numpy, 8-bit
moments included) across to the port's trainer, so that both packages
can train from one state.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .api import Accelerator
from .compile import lower
from .compile.pipeline import CompiledKernel, torch_dtype
from .core.algebra import Sparsity, TensorAlgebra, get_algebra
from .core.stt import apply_stt
from .core.tiling import ArrayConfig
from .graph import executor as graph_executor
from .graph.ir import AlgebraGraph, GraphNode
from .kernels.ops import resolve_device
from .optim import adamw
from .train.trainer import TrainState

def _config(ref_cfg) -> ArrayConfig:
    return ArrayConfig(
        pe_dims=tuple(ref_cfg.pe_dims), freq_mhz=ref_cfg.freq_mhz,
        onchip_gbps=ref_cfg.onchip_gbps, elem_bytes=ref_cfg.elem_bytes,
        strip_budget_bytes=ref_cfg.vmem_budget_bytes)


def algebra_from_reference(ref_alg) -> TensorAlgebra:
    """The port's registry algebra with a reference algebra's bounds and
    block-sparse patterns."""
    alg = get_algebra(ref_alg.name, **dict(zip(ref_alg.loops,
                                               ref_alg.bounds)))
    if ref_alg.sparsity:
        alg = alg.with_sparsity(**{
            name: Sparsity(tuple(sp.block), tuple(map(tuple, sp.coords)))
            for name, sp in ref_alg.sparsity})
    return alg


def kernel_from_reference(ref, *, device=None,
                          validate: bool = False) -> CompiledKernel:
    """The port's CompiledKernel for a reference CompiledKernel."""
    ref_df = ref.dataflow
    alg = algebra_from_reference(ref.algebra)
    df = apply_stt(alg, tuple(ref_df.selected),
                   tuple(tuple(int(v) for v in row) for row in ref_df.T))
    dtype_name = getattr(ref.dtype, "name", str(ref.dtype))
    kernel = lower(alg, df, cfg=_config(ref.cfg),
                   dtype=torch_dtype(dtype_name),
                   device=resolve_device(device), validate=validate,
                   blocks=tuple(ref.blocks), grid_order=ref.grid_order,
                   accum=ref.accum, epilogue=tuple(ref.epilogue),
                   bias_tensor=ref.bias_tensor)
    if kernel.stationary != ref.stationary:
        raise ValueError(f"the port pins operand {kernel.stationary} where "
                         f"the reference pins {ref.stationary}")
    return kernel


def graph_from_reference(ref_graph) -> AlgebraGraph:
    """The port's AlgebraGraph with a reference graph's nodes, edges,
    per-node dtypes, inputs and output."""
    nodes = tuple(
        GraphNode(name=n.name, inputs=tuple(n.inputs), output=n.output,
                  algebra=(None if n.algebra is None
                           else algebra_from_reference(n.algebra)),
                  op=n.op, dtype=n.dtype)
        for n in ref_graph.nodes)
    return AlgebraGraph(nodes=nodes, inputs=tuple(ref_graph.inputs),
                        output=ref_graph.output)


def graph_accelerator_from_reference(ref, *, device=None,
                                     validate: bool = False):
    """The port's GraphAccelerator for a reference GraphAccelerator: the
    same graph built under the same array config, dtype and merge
    setting (the port's planner makes the reference's decisions)."""
    dtype = getattr(ref.plan.dtype, "name", str(ref.plan.dtype))
    return graph_executor.build(
        graph_from_reference(ref.graph), cfg=_config(ref.plan.cfg),
        dtype=torch_dtype(dtype), merge=ref.merge_enabled,
        device=resolve_device(device), validate=validate)


def from_reference(ref, *, device=None, validate: bool = False):
    """A reference ``Accelerator`` becomes a port ``Accelerator``, a
    ``CompiledKernel`` a port ``CompiledKernel``, a ``GraphAccelerator``
    a port ``GraphAccelerator`` and an ``AlgebraGraph`` a port
    ``AlgebraGraph``."""
    if hasattr(ref, "group_kernels"):
        return graph_accelerator_from_reference(ref, device=device,
                                                validate=validate)
    if hasattr(ref, "topo_nodes"):
        return graph_from_reference(ref)
    if hasattr(ref, "kernel"):
        return Accelerator(kernel_from_reference(
            ref.kernel, device=device, validate=validate))
    return kernel_from_reference(ref, device=device, validate=validate)


def operands_to(operands: Mapping[str, object], device=None
                ) -> Dict[str, torch.Tensor]:
    """numpy (or array-like) operands — an algebra's tensor dict or a
    graph's edge dict — -> tensors on ``device``."""
    dev = resolve_device(device)
    return {name: torch.as_tensor(np.asarray(v), device=dev)
            for name, v in operands.items()}


def params_from_reference(tree: Mapping[str, Any], device=None
                          ) -> Dict[str, Any]:
    """A reference model's parameter tree (nested dicts of numpy arrays,
    same keys and layouts as the port's) -> the port's parameters on
    ``device``, copied."""
    dev = resolve_device(device)
    return {k: (params_from_reference(v, dev) if isinstance(v, Mapping)
                else torch.as_tensor(np.array(v), device=dev))
            for k, v in tree.items()}


def _moments_from_reference(tree, dev):
    if isinstance(tree, Mapping):
        return {k: _moments_from_reference(v, dev) for k, v in tree.items()}
    if hasattr(tree, "q") and hasattr(tree, "scale"):      # an 8-bit moment
        return adamw.Q8(torch.as_tensor(np.array(tree.q), device=dev),
                        torch.as_tensor(np.array(tree.scale), device=dev),
                        tuple(tree.shape))
    return torch.as_tensor(np.array(tree), device=dev)


def opt_state_from_reference(ref_opt, device=None) -> adamw.OptState:
    """A reference ``adamw.OptState`` (``jax.tree.map(np.asarray, ...)``
    of it: step, fp32 or Q8 moments) -> the port's, on ``device``."""
    dev = resolve_device(device)
    return adamw.OptState(
        torch.as_tensor(np.array(ref_opt.step), device=dev),
        _moments_from_reference(ref_opt.m, dev),
        _moments_from_reference(ref_opt.v, dev))


def train_state_from_reference(ref_state, device=None) -> TrainState:
    """A reference ``trainer.TrainState`` as numpy -> the port's."""
    return TrainState(params_from_reference(ref_state.params, device),
                      opt_state_from_reference(ref_state.opt, device))
