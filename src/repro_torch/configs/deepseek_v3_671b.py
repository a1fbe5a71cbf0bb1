"""deepseek-v3-671b [moe] — MLA + 1 shared/256 routed top-8 experts + MTP
(arXiv:2412.19437).

61L d_model=7168, 128 heads (MLA: q_lora 1536, kv_lora 512, nope 128,
rope 64, v 128), routed-expert FFN 2048 (the assigned d_ff), dense FFN 18432
for the first 3 layers (published config), vocab=129280, MTP depth 1.
FSDP + EP: the only way 671B params fit 512 chips.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=18432, vocab=129280,
    n_experts=256, n_shared_experts=1, top_k=8, d_expert=2048,
    moe_layer_start=3, capacity_factor=1.25,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    mtp_depth=1, fsdp=True,
)

SMOKE = ModelConfig(
    arch_id="deepseek-v3-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256,
    n_experts=8, n_shared_experts=1, top_k=2, d_expert=32,
    moe_layer_start=1, use_mla=True, q_lora_rank=32, kv_lora_rank=16,
    qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    mtp_depth=1, logits_chunk=32, capacity_factor=8.0,
)
