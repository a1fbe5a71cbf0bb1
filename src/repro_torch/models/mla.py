"""Multi-head Latent Attention (MLA), DeepSeek-V3 (arXiv:2412.19437): the
port of ``repro/models/mla.py`` as plain functions on tensors.

Q and KV both pass through low-rank latents; only the (kv_lora + rope_dim)
latent per token is cached for decode.  Decode uses the *absorbed* form:
q is projected into the KV-latent space, so the scores are taken against
the cached latent and the per-head K/V expansion never materializes.
Train and prefill use the expanded form, one causal
``layers.gqa_attention`` call with K = H (Dqk = nope + rope, Dv = v).

Each form is written operation for operation as the reference writes it,
so the two agree only up to rounding in bfloat16: the expanded form
rounds ``k_nope = ckv @ wkv_b`` and scales q before its product; the
absorbed form rounds ``q_abs = q_nope · w_uk`` in the model dtype, takes
both score products in float32 and scales their sum.  Its float32
products need TF32 off on the card, PyTorch's default for matmul (the
package's ``__init__`` sets it off again).

The absorbed decode keeps the reference's sharding pins
(``parallel.hints.constrain`` of q, q_abs, the scores and the latent
context); on the port's single controller a pin returns its argument
itself.
"""
from __future__ import annotations

import math

import torch

from ..parallel import hints
from .layers import dense_init, gqa_attention, rmsnorm, rope

__all__ = ["mla_init", "mla_apply", "mla_prefill_cache", "mla_decode"]


def mla_init(gen: torch.Generator, cfg, dtype) -> dict:
    """The reference's leaves on the generator's device: the projections in
    ``dtype`` (``wo`` scaled 1/sqrt(H dv)), ``q_ln`` and ``kv_ln`` float32
    ones."""
    d, H = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dev = gen.device
    return {
        "wq_a": dense_init(gen, d, qr, dtype),
        "q_ln": torch.ones((qr,), dtype=torch.float32, device=dev),
        "wq_b": dense_init(gen, qr, H * (dn + dr), dtype),
        "wkv_a": dense_init(gen, d, kvr + dr, dtype),
        "kv_ln": torch.ones((kvr,), dtype=torch.float32, device=dev),
        "wkv_b": dense_init(gen, kvr, H * (dn + dv), dtype),
        "wo": dense_init(gen, H * dv, d, dtype, scale=1.0 / math.sqrt(H * dv)),
    }


def _q_proj(p, x, cfg):
    B, S, _ = x.shape
    H, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    cq = rmsnorm(x @ p["wq_a"], p["q_ln"], cfg.norm_eps)
    q = (cq @ p["wq_b"]).reshape(B, S, H, dn + dr)
    return q[..., :dn], q[..., dn:]                     # (B,S,H,dn), (B,S,H,dr)


def _kv_latent(p, x, cfg):
    kvr = cfg.kv_lora_rank
    ckv_full = x @ p["wkv_a"]                           # (B, S, kvr+dr)
    ckv = rmsnorm(ckv_full[..., :kvr], p["kv_ln"], cfg.norm_eps)
    k_rope = ckv_full[..., kvr:][:, :, None, :]         # (B, S, 1, dr)
    return ckv, k_rope


def _positions(x, positions):
    return positions if positions is not None else torch.arange(x.shape[1], device=x.device)


def mla_apply(p, x, cfg, *, positions=None):
    """Full-sequence MLA (train / prefill), causal. x (B, S, d) -> (B, S, d).

    The expanded form: concat(nope, rope) per head, ``k_rope`` broadcast
    over the heads, one causal ``gqa_attention`` call (Dqk != Dv)."""
    B, S, _ = x.shape
    H, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    pos = _positions(x, positions)

    q_nope, q_rope = _q_proj(p, x, cfg)
    q_rope = rope(q_rope, pos, cfg.rope_theta)
    ckv, k_rope = _kv_latent(p, x, cfg)
    k_rope = rope(k_rope, pos, cfg.rope_theta)          # (B, S, 1, dr)

    kv = (ckv @ p["wkv_b"]).reshape(B, S, H, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]

    q = torch.cat([q_nope, q_rope], dim=-1)                         # (B,S,H,dn+dr)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, dr)], dim=-1)
    out = gqa_attention(q, k, v, causal=True)                       # Dv != Dqk
    return out.reshape(B, S, H * dv) @ p["wo"]


def mla_prefill_cache(p, x, cfg, *, positions=None):
    """The decode cache: the normalized latent, then the roped k_rope,
    (B, S, kvr + dr)."""
    ckv, k_rope = _kv_latent(p, x, cfg)
    k_rope = rope(k_rope, _positions(x, positions), cfg.rope_theta)[:, :, 0, :]
    return torch.cat([ckv, k_rope], dim=-1)


def mla_decode(p, x, cfg, cache, pos: int):
    """Absorbed-form single-token decode. x (B, 1, d); cache (B, S, kvr + dr),
    written in place at ``pos`` (the reference's donated cache).  Returns
    (out (B, 1, d), cache).

    scores_h = q_nope_h^T W_UK_h ckv + q_rope_h^T k_rope   per head h,
    out_h    = W_UV_h^T (probs @ ckv)"""
    B = x.shape[0]
    H, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    f32 = torch.float32

    q_nope, q_rope = _q_proj(p, x, cfg)                 # (B,1,H,dn), (B,1,H,dr)
    q_nope = hints.constrain(q_nope, ("dp", None, None, None))
    q_rope = hints.constrain(q_rope, ("dp", None, None, None))
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_rope = rope(q_rope, posv, cfg.rope_theta)

    ckv_new, k_rope_new = _kv_latent(p, x, cfg)         # (B,1,kvr), (B,1,1,dr)
    k_rope_new = rope(k_rope_new, posv, cfg.rope_theta)[:, :, 0, :]
    cache[:, pos:pos + 1] = torch.cat([ckv_new, k_rope_new], dim=-1).to(cache.dtype)

    ckv_c, k_rope_c = cache[..., :kvr], cache[..., kvr:]      # (B,S,kvr), (B,S,dr)
    wkv_b = p["wkv_b"].reshape(kvr, H, dn + dv)
    w_uk, w_uv = wkv_b[..., :dn], wkv_b[..., dn:]             # (kvr,H,dn),(kvr,H,dv)

    q_abs = torch.einsum("bqhd,khd->bqhk", q_nope, w_uk)      # (B,1,H,kvr), x's dtype
    q_abs = hints.constrain(q_abs, ("dp", None, None, None))
    scale = 1.0 / math.sqrt(dn + dr)
    logits = (
        torch.einsum("bqhk,bsk->bhqs", q_abs.to(f32), ckv_c.to(f32))
        + torch.einsum("bqhd,bsd->bhqs", q_rope.to(f32), k_rope_c.to(f32))
    ) * scale
    logits = hints.constrain(logits, ("dp", None, None, "model"))     # S-local
    spos = torch.arange(cache.shape[1], device=x.device)
    # a Python fill value: no host-to-device copy, so the step can be graphed
    logits = logits.masked_fill((spos > pos)[None, None, None, :], -1e30)
    probs = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bhqs,bsk->bqhk", probs, ckv_c.to(f32))           # latent ctx
    ctx = hints.constrain(ctx, ("dp", None, None, None))
    out = torch.einsum("bqhk,khd->bqhd", ctx.to(x.dtype), w_uv)          # (B,1,H,dv)
    return out.reshape(B, 1, H * dv) @ p["wo"], cache
