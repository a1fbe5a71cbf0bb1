"""llama-3.2-vision-11b [vlm] — text backbone w/ gated cross-attn image
layers (hf:meta-llama/Llama-3.2-11B-Vision); vision tower is a STUB.

40 layers = 8 x (1 gated cross-attn + 4 self), d_model=4096, 32 heads /
8 kv, d_ff=14336, vocab=128256; image patch embeddings precomputed
(B, 1601, d_model).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=128256, rope_theta=500000.0,
    cross_every=4, n_img_tokens=1601, fsdp=True, sp_residual=True,
)

SMOKE = ModelConfig(
    arch_id="llama-vision-smoke", family="vlm",
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, cross_every=2, n_img_tokens=16,
    logits_chunk=32,
)
