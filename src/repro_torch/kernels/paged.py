"""Paged-cache gather — the port of the reference's ``kernels/paged.py``.

The serving page pool (``repro_torch.serve.pages``) stores every
resident sequence's K/V as fixed-size pages in one shared pool
``(P, page, F)``; a per-slot page table maps slot ``c``'s logical page
``j`` to a physical page id.  Assembling the contiguous per-slot decode
view is a gather.  The reference's TPU kernel scalar-prefetches the
table into its BlockSpec index maps; the CUDA kernel
(``csrc/paged.cu``) cuts each (slot, logical page) into 32 KB runs, one
CTA a run, which reads its page id from the device table and copies the
run with 16-byte vectors, 8 loads in flight a thread before their
streaming stores.  Both are pure copies, so the kernel is bit-identical
to the plain version :func:`paged_gather_plain`.

:func:`paged_gather` runs the plain version on a CPU tensor and the
kernel on a CUDA tensor (or raises); ``launches`` counts kernel launches.
:func:`paged_scatter_token` is plain indexing on every device (the
reference's is no Pallas kernel either) and writes the pool in place.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .stt_gemm import _no_backward, _on_cpu, _stream, meta_launch

#: kernel launches since the last ``reset_launches``
launches = {"paged_gather": 0}


def reset_launches() -> None:
    launches["paged_gather"] = 0


def cost(pool_shape, table_shape, itemsize: int,
         distinct: Optional[int] = None) -> Tuple[float, float]:
    """(operations, bytes) of one gather, the count behind its bound:
    no operations; each of the ``distinct`` pages the table names read
    once (unknown, as on ``meta``: every entry's, at most the pool), the
    view written once and the int32 table read once."""
    p, page, f = pool_shape
    c, n = table_shape
    if distinct is None:
        distinct = min(c * n, p)
    page_bytes = page * f * itemsize
    return 0.0, float(distinct * page_bytes + c * n * page_bytes + 4 * c * n)


def _check(pool: torch.Tensor, page_table: torch.Tensor) -> None:
    if pool.dim() != 3 or page_table.dim() != 2:
        raise ValueError(f"paged_gather takes pool (P, page, F) and table "
                         f"(C, n), got {tuple(pool.shape)} and "
                         f"{tuple(page_table.shape)}")


def paged_gather_plain(pool: torch.Tensor, page_table: torch.Tensor
                       ) -> torch.Tensor:
    """pool (P, page, F) x page_table (C, n) -> view (C, n*page, F): the
    kernel's copy as one indexing operation."""
    _check(pool, page_table)
    _, page, f = pool.shape
    c, n = page_table.shape
    return pool[page_table.reshape(-1).long()].reshape(c, n * page, f)


def paged_gather(pool: torch.Tensor, page_table: torch.Tensor
                 ) -> torch.Tensor:
    """pool (P, page, F) x page_table (C, n) int32 -> view (C, n*page, F).

    Unmapped table entries must already point at a valid physical page
    (the pool reserves a scratch page); validity masking is the caller's
    job — attention masks by absolute position, so garbage rows
    contribute exactly zero.  On the card the table is an int32 device
    array and the pool contiguous; a page id outside the pool traps the
    kernel (the plain version raises).
    """
    if _on_cpu(pool, page_table):
        return paged_gather_plain(pool, page_table)
    _no_backward("the paged gather", "no slice: decoding never trains",
                 pool)
    _check(pool, page_table)
    if pool.device != page_table.device:
        raise ValueError(f"pool on {pool.device}, table on "
                         f"{page_table.device}")
    if page_table.dtype != torch.int32:
        raise ValueError(f"the gather kernel takes an int32 page table, got "
                         f"{page_table.dtype}")
    if not (pool.is_contiguous() and page_table.is_contiguous()):
        raise ValueError("the gather kernel takes a contiguous pool and "
                         "page table")
    p, page, f = pool.shape
    c, n = page_table.shape
    out = torch.empty((c, n * page, f), dtype=pool.dtype, device=pool.device)
    if out.numel() == 0:
        return out
    if pool.is_meta:
        meta_launch(launches, "paged_gather", *cost(
            pool.shape, page_table.shape, pool.element_size()))
        return out
    lib = _build.library("paged")
    _build.check(lib.paged_gather_launch(
        pool.data_ptr(), page_table.data_ptr(), out.data_ptr(), p, c, n,
        page * f, pool.element_size(), _stream()), "paged_gather_launch")
    launches["paged_gather"] += 1
    return out


def paged_scatter_token(pool: torch.Tensor, page_id: torch.Tensor,
                        offset: torch.Tensor, values: torch.Tensor
                        ) -> torch.Tensor:
    """Write one token row per slot back into the pool, in place.

    pool (P, page, F); page_id / offset (C,) int — the physical page and
    in-page offset each slot's write position resolves to; values (C, F).
    Slots that must not write are pointed at the pool's scratch page by
    the caller (exact no-op for live data).  Returns ``pool`` (the
    reference returns an updated copy; the port updates in place).
    """
    pool[page_id.long(), offset.long()] = values.to(pool.dtype)
    return pool
