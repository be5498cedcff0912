"""Mixtral-8x22B: 56L, d6144, 48H (GQA kv=8), d_ff 16384, vocab 32768,
MoE 8 experts top-2, sliding-window attention.  [arXiv:2401.04088; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=16_384, vocab_size=32_768,
    layer_pattern="W" * 56, sliding_window=4096, rope_theta=1_000_000.0,
    num_experts=8, num_experts_per_tok=2,
)

SMOKE = ModelConfig(
    name="mixtral-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=256,
    layer_pattern="W" * 2, sliding_window=32,
    num_experts=4, num_experts_per_tok=2, moe_capacity_factor=0.0,
    attn_q_chunk=16, attn_kv_chunk=16, loss_chunk=16,
)
