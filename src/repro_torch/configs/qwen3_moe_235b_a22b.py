"""Qwen3-MoE-235B-A22B: 94L, d4096, 64H (GQA kv=4), expert d_ff=1536,
vocab 151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B; hf]"""
import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4, head_dim=128,
    d_ff=1536, vocab_size=151_936,
    layer_pattern="E" * 94,
    qk_norm=True, rope_theta=1_000_000.0,
    num_experts=128, num_experts_per_tok=8,
    opt_dtype=torch.bfloat16,   # 235B: the reference keeps AdamW moments in bf16
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=256,
    layer_pattern="E" * 2,
    qk_norm=True,
    num_experts=8, num_experts_per_tok=2, moe_capacity_factor=0.0,
    attn_q_chunk=16, attn_kv_chunk=16, loss_chunk=16,
)
