"""Jamba-v0.1-52B: 32L, d4096, 32H (GQA kv=8), d_ff 14336, MoE 16e top-2,
Mamba:attention 7:1 interleave, MoE on every other layer.
[arXiv:2403.19887; hf]

Super-block of 8 (scanned 4x): mamba on 7 of 8 positions, attention at
position 4; MoE replaces the MLP on odd positions.
"""
from repro_torch.models.config import ModelConfig

_UNIT = "mMmMaMmM"                      # 1:7 attn:mamba, MoE every 2nd layer

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14_336, vocab_size=65_536,
    layer_pattern=_UNIT * 4,
    num_experts=16, num_experts_per_tok=2,
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
)

SMOKE = ModelConfig(
    name="jamba-smoke",
    num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    layer_pattern=_UNIT,
    num_experts=4, num_experts_per_tok=2, moe_capacity_factor=0.0,
    mamba_d_state=4, mamba_d_conv=2, mamba_expand=2,
    attn_q_chunk=16, attn_kv_chunk=16, loss_chunk=16,
)
