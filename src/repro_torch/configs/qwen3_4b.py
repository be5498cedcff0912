"""Qwen3-4B: 36L, d2560, 32H (GQA kv=8), d_ff 9728, vocab 151936, qk_norm.
[hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    num_layers=36, d_model=2560, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=9728, vocab_size=151_936,
    layer_pattern="T" * 36,
    qk_norm=True, rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen3-4b-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    layer_pattern="T" * 2,
    qk_norm=True,
    attn_q_chunk=16, attn_kv_chunk=16, loss_chunk=16,
)
