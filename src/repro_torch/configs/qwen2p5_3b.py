"""qwen2.5-3b [dense] — GQA kv=2, QKV bias (hf:Qwen/Qwen2.5-3B).

36L d_model=2048, 16 heads / 2 kv (head_dim 128), d_ff=11008,
vocab=151936, tied, rope theta 1e6.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, head_dim=128,
    d_ff=11008, vocab=151936, qkv_bias=True, rope_theta=1e6,
    tie_embeddings=True, fsdp=True, sp_residual=True,
)

SMOKE = ModelConfig(
    arch_id="qwen2.5-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, qkv_bias=True, tie_embeddings=True,
    logits_chunk=32,
)
