"""mamba2-130m [ssm] — SSD, attention-free (arXiv:2405.21060).

24L d_model=768, vocab=50280, ssm_state=128; expand 2 -> d_inner 1536,
headdim 64 -> 24 SSD heads.  Runs long_500k (O(1)-state decode).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=12, n_kv_heads=12, d_ff=0,
    vocab=50280, tie_embeddings=True,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_conv=4,
    ssm_chunk=256, ssm_ngroups=1, fsdp=True,
)

SMOKE = ModelConfig(
    arch_id="mamba2-130m-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=256, tie_embeddings=True,
    ssm_state=16, ssm_expand=2, ssm_headdim=16, ssm_conv=4,
    ssm_chunk=16, ssm_ngroups=1, logits_chunk=32,
)
