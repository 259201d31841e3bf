"""Model configuration system.

One frozen dataclass covers all five architecture families (dense / moe /
ssm / hybrid / encdec / vlm); family-specific fields are zero/None when
unused.  Every assigned architecture gets a module in this package exposing
``CONFIG`` (the exact published dims) — see ``registry.get_config``.

``reduced()`` produces a same-family miniature for CPU smoke tests; the full
configs are only ever lowered via ShapeDtypeStruct in the dry-run.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False
    swa_window: Optional[int] = None  # sliding-window size; None = full attn
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = True

    # MoE
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25

    # SSM (Mamba-2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 64
    conv_kernel: int = 4

    # hybrid (zamba2-style): shared attention block every N ssm layers
    attn_every: int = 0

    # encoder-decoder (whisper-style)
    n_enc_layers: int = 0

    # vlm (llama-3.2-vision-style): cross-attn layer period + stub frontend
    cross_attn_every: int = 0
    frontend_tokens: int = 0         # image patches (1601) / audio frames (1500)

    # training-time knobs
    remat: bool = True               # activation checkpointing per layer
    sequence_parallel: bool = True   # shard residual activations over 'model'
    explicit_collectives: bool = False  # STT-scheduled shard_map collectives
    #   (beyond-paper optimization; False = GSPMD-auto baseline — §Perf)
    dtype: str = "bfloat16"          # compute dtype (params are fp32 masters)

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.family in ("ssm", "hybrid"):
            assert self.ssm_state > 0, self.name
        if self.family == "moe":
            assert self.n_experts > 0, self.name
        if self.family == "encdec":
            assert self.n_enc_layers > 0, self.name
        if self.family == "vlm":
            assert self.cross_attn_every > 0, self.name

    # -- derived dims --------------------------------------------------
    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the 524k-token decode cell?  True for SSM /
        hybrid / sliding-window archs (per the assignment's skip rule)."""
        return self.family in ("ssm", "hybrid") or self.swa_window is not None

    # -- parameter counting (used for MODEL_FLOPS) ----------------------
    def param_count(self) -> int:
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE counts top_k experts)."""
        return _param_count(self, active_only=True)

    # -- reduced config for CPU smoke tests -----------------------------
    def reduced(self) -> "ModelConfig":
        kw = dict(
            name=self.name + "-smoke",
            family=self.family,
            n_layers=min(self.n_layers, 4 if self.family in ("hybrid", "vlm")
                         else 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads
            else 4,
            d_ff=128,
            vocab=256,
            head_dim=16,
            qkv_bias=self.qkv_bias,
            swa_window=16 if self.swa_window else None,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 16),
            ssm_expand=self.ssm_expand,
            ssm_head_dim=16,
            ssm_groups=1,
            ssm_chunk=8,
            attn_every=2 if self.attn_every else 0,
            n_enc_layers=2 if self.n_enc_layers else 0,
            cross_attn_every=2 if self.cross_attn_every else 0,
            frontend_tokens=16 if self.frontend_tokens else 0,
            remat=False,
            sequence_parallel=False,
            dtype="float32",
        )
        return ModelConfig(**kw)


def _param_count(cfg: ModelConfig, active_only: bool) -> int:
    d, dff = cfg.d_model, cfg.d_ff
    embed = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)

    def attn_params(kv_dim):
        p = d * cfg.q_dim + 2 * d * kv_dim + cfg.q_dim * d
        if cfg.qkv_bias:
            p += cfg.q_dim + 2 * kv_dim
        return p

    def mlp_params():
        return 3 * d * dff  # SwiGLU: gate, up, down

    def moe_params():
        n_e = cfg.top_k if active_only else cfg.n_experts
        return d * cfg.n_experts + n_e * 3 * d * dff  # router + experts

    def ssm_params():
        di, n, g = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups
        # in_proj (x, z, B, C, dt) + conv + out_proj + A/D/dt_bias
        inp = d * (2 * di + 2 * g * n + cfg.ssm_heads)
        conv = cfg.conv_kernel * (di + 2 * g * n)
        return inp + conv + di * d + 3 * cfg.ssm_heads

    per_layer = 0
    if cfg.family == "dense":
        per_layer = attn_params(cfg.kv_dim) + mlp_params()
        total = embed + cfg.n_layers * per_layer
    elif cfg.family == "moe":
        per_layer = attn_params(cfg.kv_dim) + moe_params()
        total = embed + cfg.n_layers * per_layer
    elif cfg.family == "ssm":
        total = embed + cfg.n_layers * ssm_params()
    elif cfg.family == "hybrid":
        n_shared = 1
        total = (embed + cfg.n_layers * ssm_params()
                 + n_shared * (attn_params(cfg.kv_dim) + mlp_params()))
    elif cfg.family == "encdec":
        dec = cfg.n_layers * (2 * attn_params(cfg.kv_dim) + mlp_params())
        enc = cfg.n_enc_layers * (attn_params(cfg.kv_dim) + mlp_params())
        total = embed + enc + dec
    elif cfg.family == "vlm":
        n_cross = cfg.n_layers // cfg.cross_attn_every
        total = (embed + cfg.n_layers * (attn_params(cfg.kv_dim) + mlp_params())
                 + n_cross * attn_params(cfg.kv_dim))
    else:
        raise ValueError(cfg.family)
    # norms (2 per layer) + final norm
    total += (2 * cfg.n_layers + 1) * d
    return total


# ---------------------------------------------------------------------------
# Input shapes assigned to every LM arch (the 4 cells per arch)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def cells_for(cfg: ModelConfig) -> Tuple[str, ...]:
    """The shape cells this arch runs (long_500k only for sub-quadratic)."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        cells.append("long_500k")
    return tuple(cells)


# ---------------------------------------------------------------------------
# Serving workload mixes (open-loop load for the continuous-batching server)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServeMix:
    """One open-loop serving workload: mixed prompt/output length buckets
    sampled per request, Poisson arrivals at ``rate_rps`` (0 = burst: all
    requests arrive at t=0, which is what the CI smoke uses so wall time
    measures compute, not the arrival clock)."""

    name: str
    prompt_lens: Tuple[int, ...]   # sampled uniformly per request
    output_lens: Tuple[int, ...]
    requests: int
    rate_rps: float = 0.0

    @property
    def arrival(self) -> str:
        return "poisson" if self.rate_rps > 0 else "burst"

    def max_context(self) -> int:
        return max(self.prompt_lens) + max(self.output_lens)


SERVE_MIXES = {
    # CI smoke: tiny burst mix, long/short prompts and outputs interleaved
    # so static batching pays padding + drain and continuous does not.
    "smoke": ServeMix("smoke", prompt_lens=(8, 16, 24), output_lens=(4, 24),
                      requests=12),
    # benchmark default: open-loop Poisson with a wider spread
    "mixed": ServeMix("mixed", prompt_lens=(8, 16, 24, 40),
                      output_lens=(4, 8, 16, 32), requests=32,
                      rate_rps=8.0),
}
