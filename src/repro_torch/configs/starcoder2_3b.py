"""starcoder2-3b [dense] — GQA kv=2, RoPE, sliding window, 2-matrix GELU MLP
(arXiv:2402.19173).

30L d_model=3072, 24 heads / 2 kv, d_ff=12288, vocab=49152, window 4096.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, d_ff=12288,
    vocab=49152, qkv_bias=True, rope_theta=999999.44,
    sliding_window=4096, act="gelu", mlp_gated=False,
    tie_embeddings=True, fsdp=True, sp_residual=True,
)

SMOKE = ModelConfig(
    arch_id="starcoder2-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, qkv_bias=True, sliding_window=32, act="gelu",
    mlp_gated=False, tie_embeddings=True, logits_chunk=32,
)
