"""olmoe-1b-7b [moe] — 64 experts top-8, 1B active / 7B total (arXiv:2409.02060).

16L d_model=2048, 16 heads (kv=16), expert FFN 1024, vocab=50304.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1024,
    vocab=50304,
    n_experts=64, n_shared_experts=0, top_k=8, d_expert=1024,
    capacity_factor=1.25, fsdp=True,
)

SMOKE = ModelConfig(
    arch_id="olmoe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32,
    vocab=256, n_experts=8, n_shared_experts=0, top_k=2, d_expert=32,
    logits_chunk=32, capacity_factor=8.0,
)
