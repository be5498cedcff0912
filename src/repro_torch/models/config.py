"""Unified model configuration covering all ten assigned architectures.

The reference's ``ModelConfig`` with the same fields and defaults; the
dtypes are torch dtypes, and ``param_dtype`` (like the other dtype
fields) also takes the names ``"bf16"`` / ``"f32"``, resolved when the
config is built."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional, Tuple

import torch


DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
          "f32": torch.float32, "float32": torch.float32}


def resolve_dtype(dt) -> torch.dtype:
    """A torch dtype, or its name (``"bf16"``, ``"float32"``, ...)."""
    if isinstance(dt, torch.dtype):
        return dt
    if dt in DTYPES:
        return DTYPES[dt]
    raise ValueError(f"unknown dtype {dt!r}; known: {sorted(DTYPES)}")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 => d_model // num_heads

    # --- layer plan ----------------------------------------------------
    # One char per layer; the plan is auto-compressed into scan groups.
    #   T full attention + MLP        E full attention + MoE
    #   L local (SWA) attn + MLP      G global attn + MLP
    #   W SWA attn + MoE              R RWKV6 block
    #   m mamba + MLP                 M mamba + MoE
    #   a full attn + MLP (jamba)     A full attn + MoE (jamba)
    layer_pattern: Optional[str] = None   # None => "T" * num_layers

    # --- attention variants ---------------------------------------------
    qk_norm: bool = False             # qwen3
    qkv_bias: bool = False            # qwen1.5
    sliding_window: int = 4096        # width for W layers (mixtral)
    local_window: int = 1024          # width for L layers (gemma3 locals)
    rope_theta: float = 10000.0

    mlp_gated: bool = True            # SwiGLU; False => 2-matrix GELU (granite)
    # hillclimb knob: cast f32 master weights to bf16 once per step (before
    # the layer scan) so FSDP all-gathers move bf16, halving gather bytes
    cast_params_once: bool = False

    # --- MoE --------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0                 # 0 => d_ff
    # hillclimb knob: "gather" (baseline) pulls (tokens*k, d) across EP
    # shards; "scatter" combines on the expert side first, so the EP
    # reduction moves a k-times-smaller (tokens, d) tensor (SPerf, cell C)
    moe_combine: str = "gather"
    # expert-buffer capacity factor; <= 0 means dropless (capacity = group
    # size, no token overflow).  Capped capacity trades tokens for memory —
    # fine for training, but dropped tokens make a token's output depend on
    # the rest of the batch, so serving/smoke configs run dropless.
    moe_capacity_factor: float = 1.25

    # --- SSM / RWKV -------------------------------------------------------
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    # hillclimb knob: project y inside the scan chunk loop so the
    # (B, S, d_inner, d_state) state tensor never reaches HBM (SPerf)
    mamba_fuse_proj: bool = False
    mamba_chunk: int = 128            # selective-scan chunk length
    rwkv_head_size: int = 64

    # --- modality frontend (stub per the brief) ---------------------------
    frontend: Optional[str] = None    # None | "audio" | "vision"

    norm_eps: float = 1e-6
    compute_dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32  # master weights; "bf16" for serving
    opt_dtype: Any = torch.float32    # AdamW moment dtype (bf16 for 235B-class)
    remat: str = "full"               # full | dots | none
    # memory-efficient attention chunking (queries, keys) -- hillclimb knobs
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    # hillclimb knob: batch-parallel attention -- gather q/k/v to batch-only
    # sharding once per layer instead of letting GSPMD replicate KV chunks
    # inside the scan (involuntary full remat for GQA kv_heads < tp width)
    attn_dp: bool = False
    loss_chunk: int = 512             # vocab-parallel CE sequence chunk
    scan_layers: bool = True

    def __post_init__(self):
        for name in ("compute_dtype", "param_dtype", "opt_dtype"):
            object.__setattr__(self, name, resolve_dtype(getattr(self, name)))
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.layer_pattern is None:
            object.__setattr__(self, "layer_pattern", "T" * self.num_layers)
        if self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)
        assert len(self.layer_pattern) == self.num_layers, \
            f"{self.name}: pattern len {len(self.layer_pattern)} != {self.num_layers}"

    def with_overrides(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) cell of the assigned grid."""
    name: str            # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


LM_SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)


def shape_cell(name: str) -> ShapeCell:
    for c in LM_SHAPES:
        if c.name == name:
            return c
    raise KeyError(name)


def is_subquadratic(cfg: ModelConfig) -> bool:
    """long_500k eligibility: SSM/hybrid/linear-attn or windowed-attention."""
    pat = cfg.layer_pattern
    has_full = any(c in pat for c in "TEGaA")
    has_sub = any(c in pat for c in "RmMLW")
    return has_sub and (not has_full or pat.count("G") <= pat.count("L"))
