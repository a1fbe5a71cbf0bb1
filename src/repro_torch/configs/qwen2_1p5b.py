"""qwen2-1.5b [dense] — GQA kv=2, QKV bias (arXiv:2407.10671).

28L d_model=1536, 12 heads / 2 kv heads (head_dim 128), d_ff=8960,
vocab=151936, tied embeddings, rope theta 1e6.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab=151936, qkv_bias=True, rope_theta=1e6,
    tie_embeddings=True, sp_residual=True,
)

SMOKE = ModelConfig(
    arch_id="qwen2-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, qkv_bias=True, tie_embeddings=True,
    logits_chunk=32,
)
