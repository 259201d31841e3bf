"""Target-hardware model: NVIDIA H100 SXM constants and roofline terms.

The port's counterpart of the reference's ``core/tpu.py``.  Every
constant is the published figure for one **H100 SXM** card (NVIDIA's
data sheet and the Hopper architecture white paper, dense rates without
sparsity, at the full 700 W power limit):

    streaming multiprocessors : 132
    shared memory per block   : 227 KB (232,448 bytes)
    shared memory per SM      : 228 KB (233,472 bytes), 1 KB of it
                                reserved for each resident block
    L2 cache                  : 50 MB
    device memory             : 80 GB at 3.35 TB/s
    bf16 tensor-core peak     : 989 TFLOP/s
    fp32 peak (CUDA cores)    : 67 TFLOP/s

and of the network of an H100 SXM cluster (the DGX H100 data sheet):
NVLink 4 at 450 GB/s each way a GPU among the 8 GPUs of a node, and one
400 Gb/s link (50 GB/s) a GPU between nodes.

The fp32 CUDA-core peak is the one that bounds the port's fp32 GEMMs:
TF32 stays off so that fp32 results match the reference, and the
templates' kernels multiply on the CUDA cores.  A card run below 700 W
reaches less; results therefore carry the card's ``power.limit``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class HopperSpec:
    name: str = "H100 SXM"
    sms: int = 132
    smem_per_block_bytes: int = 232_448
    smem_per_sm_bytes: int = 233_472
    smem_reserved_per_block: int = 1_024
    l2_bytes: float = 50e6
    hbm_bytes: float = 80e9
    hbm_bw: float = 3.35e12                 # bytes/s
    peak_flops_bf16: float = 989e12         # FLOP/s, tensor cores
    peak_flops_fp32: float = 67e12          # FLOP/s, CUDA cores
    nvlink_bw: float = 450e9                # bytes/s each way, within a node
    network_bw: float = 50e9                # bytes/s a GPU, between nodes
    node_gpus: int = 8

    def peak_flops(self, dtype: str) -> float:
        """Peak rate for operations on inputs of ``dtype`` (a dtype name:
        ``float32`` runs on the CUDA cores since TF32 is off)."""
        return {"float32": self.peak_flops_fp32,
                "bfloat16": self.peak_flops_bf16}[dtype]


H100 = HopperSpec()


@dataclasses.dataclass
class RooflineTerms:
    """The roofline of one kernel call: the least time the card could
    take is the larger of its operations over the peak rate for their
    type and its bytes over the memory rate."""

    cell: str
    flops: float
    bytes: float
    dtype: str = "float32"
    spec: HopperSpec = dataclasses.field(default_factory=lambda: H100)

    @property
    def compute_s(self) -> float:
        return self.flops / self.spec.peak_flops(self.dtype)

    @property
    def memory_s(self) -> float:
        return self.bytes / self.spec.hbm_bw

    @property
    def bound_by(self) -> str:
        """``operations`` or ``bytes``: which term sets the bound."""
        return "operations" if self.compute_s >= self.memory_s else "bytes"

    @property
    def bound_s(self) -> float:
        """Least time (perfect overlap of the two terms)."""
        return max(self.compute_s, self.memory_s)


def gemm_roofline(cell: str, nb: int, m: int, n: int, k: int, *,
                  dtype: str = "float32", elem_bytes: int = 4,
                  a_batched: bool = True, b_batched: bool = True
                  ) -> RooflineTerms:
    """Roofline of ``C[b] = A[b|.] @ B[b|.]``: 2·nb·m·n·k operations;
    each input read once (an operand broadcast over the batch counts
    once) and the output written once."""
    a = (nb if a_batched else 1) * m * k
    b = (nb if b_batched else 1) * k * n
    c = nb * m * n
    return RooflineTerms(cell, 2.0 * nb * m * n * k,
                         float((a + b + c) * elem_bytes), dtype=dtype)


@dataclasses.dataclass
class CellRoofline:
    """The three-term roofline of one (arch x shape x mesh) cell from
    its per-device counts summed over ``chips`` (the counterpart of the
    reference's ``tpu.RooflineTerms``): operations at the bf16
    tensor-core peak, bytes at the memory rate, and wire bytes at the
    rate of the link they cross — ``network_bytes`` of them over groups
    that span nodes at ``network_bw``, the rest over NVLink.  These are
    predictions from data-sheet constants, not measurements."""

    cell: str
    chips: int
    flops: float
    bytes: float
    collective_bytes: float          # summed over all chips
    model_flops: float               # 6*N*D (train) or 2*N_active*D
    network_bytes: float = 0.0       # the part of collective_bytes
    spec: HopperSpec = dataclasses.field(default_factory=lambda: H100)

    @property
    def compute_s(self) -> float:
        return self.flops / (self.chips * self.spec.peak_flops_bf16)

    @property
    def memory_s(self) -> float:
        return self.bytes / (self.chips * self.spec.hbm_bw)

    @property
    def collective_s(self) -> float:
        fast = self.collective_bytes - self.network_bytes
        return (fast / (self.chips * self.spec.nvlink_bw)
                + self.network_bytes / (self.chips * self.spec.network_bw))

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """The larger of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """Model operations over counted operations (recompute and the
        whole-weight departures read below 1)."""
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Model operations over ``chips`` x peak x ``step_time_s``: the
        MFU the roofline allows."""
        denom = self.chips * self.spec.peak_flops_bf16 * self.step_time_s
        return self.model_flops / denom if denom else 0.0

    def as_dict(self) -> Dict:
        return {
            "cell": self.cell, "chips": self.chips,
            "hlo_flops": self.flops, "hlo_bytes": self.bytes,
            "collective_bytes": self.collective_bytes,
            "network_bytes": self.network_bytes,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time_s,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def dense_train_model_flops(n_params: float, tokens: float) -> float:
    """6*N*D: forward 2ND + backward 4ND."""
    return 6.0 * n_params * tokens


def decode_model_flops(n_active_params: float, tokens: float) -> float:
    """Forward only: 2*N_active a token."""
    return 2.0 * n_active_params * tokens
