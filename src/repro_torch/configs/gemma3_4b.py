"""Gemma3-4B: 34L, d2560, 8H (GQA kv=4), d_ff 10240, vocab 262144,
5:1 local:global attention, 128k context.  [hf:google/gemma-3-1b-pt;
unverified]"""
from repro_torch.models.config import ModelConfig

_PATTERN = ("LLLLLG" * 6)[:34]          # 5 locals per global, 34 layers

CONFIG = ModelConfig(
    name="gemma3-4b",
    num_layers=34, d_model=2560, num_heads=8, num_kv_heads=4, head_dim=256,
    d_ff=10_240, vocab_size=262_144,
    layer_pattern=_PATTERN, rope_theta=1_000_000.0, local_window=1024,
)

SMOKE = ModelConfig(
    name="gemma3-smoke",
    num_layers=12, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    layer_pattern=("LLLLLG" * 2), local_window=32,
    attn_q_chunk=16, attn_kv_chunk=16, loss_chunk=16,
)
