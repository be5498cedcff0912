"""RWKV-6 (Finch) 7B: 32L, d4096, attention-free, d_ff 14336, vocab 65536,
data-dependent decay.  [arXiv:2404.05892; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    num_layers=32, d_model=4096, num_heads=64, num_kv_heads=64,  # unused (attn-free)
    d_ff=14_336, vocab_size=65_536,
    layer_pattern="R" * 32, rwkv_head_size=64,
)

SMOKE = ModelConfig(
    name="rwkv6-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=256,
    layer_pattern="R" * 2, rwkv_head_size=16,
    attn_q_chunk=16, attn_kv_chunk=16, loss_chunk=16,
)
