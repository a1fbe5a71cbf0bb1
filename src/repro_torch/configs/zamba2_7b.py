"""zamba2-7b [hybrid] — Mamba2 backbone + ONE shared attention block reused
(arXiv:2411.15242).

81 mamba2 layers (d_model=3584, expand 2 -> d_inner 7168, headdim 64 ->
112 SSD heads, ssm_state=64) structured as 6 groups of 13 + tail of 3, with
the shared GQA(32h) attention+MLP block applied before each group (6 shared
invocations).  The published per-invocation LoRA deltas on the shared block
are simplified away (DESIGN.md §Arch-applicability).  Runs long_500k.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
    vocab=32000,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_conv=4,
    ssm_chunk=256, ssm_ngroups=1,
    hybrid_groups=6, hybrid_group_len=13, hybrid_tail=3,
    fsdp=True,
)

SMOKE = ModelConfig(
    arch_id="zamba2-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=256,
    ssm_state=16, ssm_expand=2, ssm_headdim=16, ssm_conv=4,
    ssm_chunk=16, ssm_ngroups=1,
    hybrid_groups=2, hybrid_group_len=2, hybrid_tail=1,
    logits_chunk=32,
)
