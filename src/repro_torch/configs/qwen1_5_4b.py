"""Qwen1.5-4B: 40L, d2560, 20H (MHA kv=20), d_ff 6912, vocab 151936,
QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    num_layers=40, d_model=2560, num_heads=20, num_kv_heads=20, head_dim=128,
    d_ff=6912, vocab_size=151_936,
    layer_pattern="T" * 40,
    qkv_bias=True,
)

SMOKE = ModelConfig(
    name="qwen1.5-4b-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
    layer_pattern="T" * 2,
    qkv_bias=True,
    attn_q_chunk=16, attn_kv_chunk=16, loss_chunk=16,
)
