"""MusicGen-medium: 48L, d1536, 24H (MHA), d_ff 6144, vocab 2048 (EnCodec
tokens); decoder-only; audio frontend is a stub per the brief.
[arXiv:2306.05284; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24, head_dim=64,
    d_ff=6144, vocab_size=2048,
    layer_pattern="T" * 48,
    frontend="audio",
)

SMOKE = ModelConfig(
    name="musicgen-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=128,
    layer_pattern="T" * 2,
    frontend="audio",
    attn_q_chunk=16, attn_kv_chunk=16, loss_chunk=16,
)
