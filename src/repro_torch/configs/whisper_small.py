"""whisper-small [audio] — enc-dec, conv frontend STUB (arXiv:2212.04356).

12 enc + 12 dec layers, d_model=768, 12 heads, d_ff=3072, vocab=51865.
input_specs feeds precomputed frame embeddings (B, 1500, 768); decoder uses
learned positions sized to the assigned 32k decode shape.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-small", family="audio",
    n_layers=12, n_enc_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865, enc_len=1500, max_seq=32768,
    act="gelu", mlp_gated=False, tie_embeddings=True, sp_residual=True,
)

SMOKE = ModelConfig(
    arch_id="whisper-smoke", family="audio",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, enc_len=32, max_seq=128,
    act="gelu", mlp_gated=False, tie_embeddings=True, logits_chunk=32,
)
