"""InternVL2-76B backbone (InternLM2/Llama3-70B-class LM): 80L, d8192,
64H (GQA kv=8), d_ff 28672, vocab 128256; InternViT patch frontend is a stub
per the brief.  [arXiv:2404.16821; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=28_672, vocab_size=128_256,
    layer_pattern="T" * 80, rope_theta=500_000.0,
    frontend="vision",
)

SMOKE = ModelConfig(
    name="internvl2-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    layer_pattern="T" * 2,
    frontend="vision",
    attn_q_chunk=16, attn_kv_chunk=16, loss_chunk=16,
)
