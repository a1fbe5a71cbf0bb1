"""Unified model configuration covering all assigned architecture families:
the port's own copy of ``repro/models/config.py``, field for field, with the
same ``param_count`` and ``active_param_count``.

One dataclass parameterizes: dense decoder LMs (llama/qwen/starcoder style),
MoE (olmoe, deepseek-v3 w/ MLA+MTP), SSM (mamba2 SSD), hybrid (zamba2),
encoder-decoder audio (whisper, stub frontend) and VLM (llama-3.2-vision,
stub vision tower).  Exact per-arch values live in
``repro_torch/configs/<id>.py``.  The dense, MoE (with and without MLA),
SSM and hybrid families run in the port so far (``repro_torch.models.
get_model`` refuses the audio and VLM families, ROADMAP A8); the fields of
those are kept so that every config is the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads

    # attention
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0      # 0 = full attention
    logit_softcap: float = 0.0

    # norms / activations / embeddings
    norm_eps: float = 1e-5
    act: str = "silu"            # silu | gelu
    mlp_gated: bool = True       # False -> 2-matrix MLP w/ bias (starcoder2, whisper)
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    capacity_factor: float = 1.25
    moe_layer_start: int = 0     # deepseek: first k layers use a dense FFN
    router_aux_coef: float = 0.001

    # MLA (deepseek-v3)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mtp_depth: int = 0           # multi-token-prediction extra blocks

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    ssm_ngroups: int = 1

    # hybrid (zamba2): shared attention block applied before each scan group
    hybrid_groups: int = 0       # number of (shared-attn + mamba-group) segments
    hybrid_group_len: int = 0    # mamba layers per segment
    hybrid_tail: int = 0         # trailing mamba layers after the last segment

    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    enc_len: int = 0             # precomputed frame count from the stub frontend
    max_seq: int = 0             # learned-position capacity (audio family only)

    # vlm (llama-3.2-vision): one gated cross-attn layer per `cross_every`
    # self-attn layers; image patch embeddings come precomputed (stub tower)
    cross_every: int = 0
    n_img_tokens: int = 0

    # numerics / compile scalability
    dtype: str = "bfloat16"
    remat: bool = True
    logits_chunk: int = 1024     # sequence chunking of the softmax-xent
    scan_layers: bool = True

    # distribution hints (consumed by the reference's parallel/sharding.py)
    fsdp: bool = False           # additionally shard params over the data axis
    # sequence-parallel SSM: mamba blocks are per-token apart from the O(1)
    # state recurrence, so shard the residual's seq axis over 'model' with
    # REPLICATED (fsdp-only) mamba weights — removes the 2-AR/layer Megatron
    # pattern entirely (§Perf iteration Z1)
    ssm_seq_parallel: bool = True
    # sequence-parallel residual stream for attention archs (SPerf V1):
    # pins the remat/scan carry seq-sharded over 'model', shrinking the
    # saved activation stacks by model_size at the price of per-layer
    # (all-gather, reduce-scatter) pairs around attention/MLP
    sp_residual: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # --- derived sizes -----------------------------------------------------
    @property
    def d_inner(self) -> int:    # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def active_param_count(self) -> int:
        """Params touched per token: MoE counts top_k + shared experts only
        (MODEL_FLOPS = 6 * N_active * D for the roofline's useful-FLOPs line)."""
        if not self.n_experts:
            return self.param_count()
        active = dataclasses.replace(
            self,
            n_experts=self.top_k,
            # router still sees all experts; its params are negligible
        )
        return active.param_count()

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS in the roofline)."""
        d, f, V = self.d_model, self.d_ff, self.vocab
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense",):
            attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim \
                 + self.n_heads * self.head_dim * d
            mlp = (3 if self.mlp_gated else 2) * d * f
            return emb + self.n_layers * (attn + mlp) + d
        if self.family == "moe" and not self.use_mla:
            attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim \
                 + self.n_heads * self.head_dim * d
            moe = self.n_experts * 3 * d * self.d_expert + d * self.n_experts \
                + self.n_shared_experts * 3 * d * self.d_expert
            return emb + self.n_layers * (attn + moe) + d
        if self.use_mla:
            H = self.n_heads
            attn = d * self.q_lora_rank \
                 + self.q_lora_rank * H * (self.qk_nope_dim + self.qk_rope_dim) \
                 + d * (self.kv_lora_rank + self.qk_rope_dim) \
                 + self.kv_lora_rank * H * (self.qk_nope_dim + self.v_head_dim) \
                 + H * self.v_head_dim * d
            dense_ffn = 3 * d * f
            moe = self.n_experts * 3 * d * self.d_expert + d * self.n_experts \
                + self.n_shared_experts * 3 * d * self.d_expert
            n_moe = self.n_layers - self.moe_layer_start
            total = emb + self.moe_layer_start * (attn + dense_ffn) \
                  + n_moe * (attn + moe) + d
            if self.mtp_depth:
                total += self.mtp_depth * (attn + moe + 2 * d)
            return total
        if self.family == "ssm":
            din, N, H = self.d_inner, self.ssm_state, self.ssm_heads
            G = self.ssm_ngroups
            blk = d * (2 * din + 2 * G * N + H) \
                + self.ssm_conv * (din + 2 * G * N) \
                + din * d + 2 * H + din
            return emb + self.n_layers * blk + d
        if self.family == "hybrid":
            din, N, H = self.d_inner, self.ssm_state, self.ssm_heads
            G = self.ssm_ngroups
            blk = d * (2 * din + 2 * G * N + H) \
                + self.ssm_conv * (din + 2 * G * N) \
                + din * d + 2 * H + din
            attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim \
                 + self.n_heads * self.head_dim * d + 3 * d * f
            n_mamba = self.hybrid_groups * self.hybrid_group_len + self.hybrid_tail
            return emb + n_mamba * blk + attn + d
        if self.family == "audio":
            attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim \
                 + self.n_heads * self.head_dim * d
            mlp = 2 * d * f  # whisper MLP is 2-matrix gelu
            enc = self.n_enc_layers * (attn + mlp)
            dec = self.n_layers * (2 * attn + mlp)
            return emb + enc + dec + d
        if self.family == "vlm":
            attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim \
                 + self.n_heads * self.head_dim * d
            mlp = 3 * d * f
            n_cross = self.n_layers // (self.cross_every + 1) if self.cross_every else 0
            n_self = self.n_layers - n_cross
            return emb + n_self * (attn + mlp) + n_cross * (attn + mlp + d) + d
        raise ValueError(self.family)
