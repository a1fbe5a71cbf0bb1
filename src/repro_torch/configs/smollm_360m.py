"""smollm-360m [dense] — llama-arch small (hf:HuggingFaceTB/SmolLM-360M).

32L d_model=960, 15 heads / 5 kv heads, d_ff=2560, vocab=49152, tied.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, d_ff=2560,
    vocab=49152, tie_embeddings=True, sp_residual=True,
)

SMOKE = ModelConfig(
    arch_id="smollm-smoke", family="dense",
    n_layers=2, d_model=60, n_heads=3, n_kv_heads=1, d_ff=128,
    vocab=256, tie_embeddings=True, logits_chunk=32,
)
