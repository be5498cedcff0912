"""Granite-34B (code): 88L, d6144, 48H (MQA kv=1), d_ff 24576, vocab 49152,
llama-style blocks.  [arXiv:2405.04324; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    num_layers=88, d_model=6144, num_heads=48, num_kv_heads=1, head_dim=128,
    d_ff=24_576, vocab_size=49_152,
    layer_pattern="T" * 88,
    mlp_gated=False,      # GPT-BigCode-style 2-matrix MLP => 34B total
)

SMOKE = ModelConfig(
    name="granite-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=256,
    layer_pattern="T" * 2,
    attn_q_chunk=16, attn_kv_chunk=16, loss_chunk=16,
)
