"""Shared layer library: norms, RoPE, GQA attention (+cache), MLPs.  The
port of ``repro/models/layers.py``, function for function, as plain
functions on tensors.

Conventions (the reference's):
* parameters are mappings of leaf name -> tensor (``nn.ParameterDict`` in
  the model); weights are ``(d_in, d_out)``, so ``x @ w`` rounds as the
  reference's product does;
* activations flow in cfg.dtype (bf16); softmax/norm internals in f32;
* attention shapes: q (B, Sq, H, D), k/v (B, Skv, K, D) with H % K == 0.

Both attention routes are written out in plain PyTorch, as the reference
writes them in ``jnp``: no fused attention operator stands in for them.
The projections and MLP products are plain products, as in the reference
(which leaves them to XLA): ``@``.  The reference's layer library holds
no sharding pin; its callers' pins (``parallel.hints.constrain``) stand in
:mod:`.lm`, :mod:`.mla`, :mod:`.ssm` and :mod:`.encdec`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = [
    "dense_init", "norm_init", "rmsnorm", "layernorm", "rope",
    "gqa_attention", "attn_init", "attn_apply", "attn_decode",
    "mlp_init", "mlp_apply", "update_cache",
    "FLASH_MIN_SQ", "Q_CHUNK", "KV_CHUNK",
]


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """N(0, 1) * scale drawn in float32 (default scale 1/sqrt(d_in)), then
    cast, on the generator's device."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32, device=gen.device)
    return (w * scale).to(dtype)


def norm_init(d: int, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


def rmsnorm(x, w, eps: float = 1e-5):
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def layernorm(x, w, b, eps: float = 1e-5):
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * w.to(x.dtype) + b.to(x.dtype)


def rope(x, positions, theta: float):
    """Rotary embedding over the full head dim. x: (B, S, H, D); positions
    (S,) or (B, S).  Angles in float32; the bf16 x float32 products are
    promoted, then cast back."""
    B, S, H, D = x.shape
    half = D // 2
    freqs = torch.exp(
        -torch.arange(0, half, dtype=torch.float32, device=x.device)
        * (math.log(theta) / half)
    )  # (half,)
    pos = positions.to(device=x.device, dtype=torch.float32)
    if pos.ndim == 1:
        ang = pos[None, :, None] * freqs[None, None, :]
    else:
        ang = pos[:, :, None] * freqs[None, None, :]
    ang = ang[:, :, None, :]                                   # (1 or B, S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


FLASH_MIN_SQ = 2048     # full-seq paths switch to chunked attention above this
Q_CHUNK = 512
KV_CHUNK = 1024


def _mask_logits(logits, q_start, kv_start, causal, window, kv_valid_len):
    """logits (..., qc, kc); positions are chunk offsets (ints or 0-d
    tensors); masked entries are -1e30, not -inf."""
    qc, kc = logits.shape[-2], logits.shape[-1]
    qpos = q_start + torch.arange(qc, device=logits.device, dtype=torch.int32)[:, None]
    spos = kv_start + torch.arange(kc, device=logits.device, dtype=torch.int32)[None, :]
    mask = None
    if causal:
        mask = spos <= qpos
        if window > 0:
            mask = mask & (spos > qpos - window)
    if kv_valid_len is not None:
        valid = (spos < kv_valid_len).expand(qc, kc)
        mask = valid if mask is None else (mask & valid)
    if mask is not None:
        # a Python fill value: a tensor made from it on the card would be a
        # blocking host-to-device copy on every call
        logits = logits.masked_fill(~mask, -1e30)
    return logits


def _attention_simple(qg, k, v, *, causal, window, q_offset, kv_valid_len, softcap):
    B, Sq, K, G, D = qg.shape
    scale = 1.0 / math.sqrt(D)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32) * scale,
                          k.to(torch.float32))
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    logits = _mask_logits(logits, q_offset, 0, causal, window, kv_valid_len)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)


def _attention_flash(qg, k, v, *, causal, window, kv_valid_len, softcap,
                     q_chunk=Q_CHUNK, kv_chunk=KV_CHUNK):
    """Chunked online-softmax attention: never materializes the (Sq, Skv)
    score matrix.  A loop over q chunks (static causal/window chunk
    skipping) with a loop over kv chunks carrying the running (max, denom,
    acc) in float32, the reference's ``lax.scan``.  Requires q_offset == 0
    (full-sequence paths only)."""
    B, Sq, K, G, D = qg.shape
    Skv = k.shape[1]
    Dv = v.shape[-1]
    scale = 1.0 / math.sqrt(D)

    # pad kv to a chunk multiple; padded keys masked via kv_valid_len
    pad = (-Skv) % kv_chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        if kv_valid_len is None:
            kv_valid_len = Skv
    n_q = Sq // q_chunk

    outs = []
    for iq in range(n_q):
        q_i = qg[:, iq * q_chunk:(iq + 1) * q_chunk].to(torch.float32) * scale
        q_lo = iq * q_chunk
        # static kv range intersecting the causal/window band of this q chunk
        kv_hi = min(k.shape[1], q_lo + q_chunk) if causal else k.shape[1]
        kv_lo = 0
        if causal and window > 0:
            kv_lo = max(0, (q_lo - window + 1) // kv_chunk * kv_chunk)
        n_kv = -(-(kv_hi - kv_lo) // kv_chunk)
        m = torch.full((B, K, G, q_chunk), -math.inf, dtype=torch.float32, device=qg.device)
        l = torch.zeros((B, K, G, q_chunk), dtype=torch.float32, device=qg.device)
        acc = torch.zeros((B, K, G, q_chunk, Dv), dtype=torch.float32, device=qg.device)
        for jkv in range(n_kv):
            kv_start = kv_lo + jkv * kv_chunk
            k_c = k[:, kv_start:kv_start + kv_chunk]
            v_c = v[:, kv_start:kv_start + kv_chunk]
            s = torch.einsum("bqkgd,bskd->bkgqs", q_i, k_c.to(torch.float32))
            if softcap > 0.0:
                s = softcap * torch.tanh(s / softcap)
            s = _mask_logits(s, q_lo, kv_start, causal, window, kv_valid_len)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            pv = torch.einsum("bkgqs,bskd->bkgqd", p, v_c.to(torch.float32))
            acc = acc * corr[..., None] + pv
            m = m_new
        out_i = acc / torch.clamp(l, min=1e-30)[..., None]        # (B,K,G,qc,Dv)
        outs.append(out_i.permute(0, 3, 1, 2, 4))
    return torch.cat(outs, dim=1).to(v.dtype)


def gqa_attention(q, k, v, *, causal: bool, window: int = 0, q_offset=0,
                  kv_valid_len=None, softcap: float = 0.0):
    """Grouped-query attention. q (B,Sq,H,D), k/v (B,Skv,K,D) -> (B,Sq,H,Dv).

    q_offset: absolute position of q[0] (for causal masking of decode steps
    against a cache).  kv_valid_len: mask out cache positions >= this
    length.  Takes the chunked online-softmax route for long full sequences
    (Sq >= FLASH_MIN_SQ, Sq % Q_CHUNK == 0, q_offset the int 0)."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, D)
    use_flash = (
        Sq >= FLASH_MIN_SQ
        and Sq % Q_CHUNK == 0
        and isinstance(q_offset, int) and q_offset == 0
    )
    if use_flash:
        out = _attention_flash(qg, k, v, causal=causal, window=window,
                               kv_valid_len=kv_valid_len, softcap=softcap)
    else:
        out = _attention_simple(qg, k, v, causal=causal, window=window,
                                q_offset=q_offset, kv_valid_len=kv_valid_len,
                                softcap=softcap)
    return out.reshape(B, Sq, H, v.shape[-1])


# --------------------------------------------------------------------------
# Standard GQA attention layer
# --------------------------------------------------------------------------


def attn_init(gen: torch.Generator, cfg, dtype, *, cross: bool = False,
              d_kv_in: Optional[int] = None) -> dict:
    d, H, K, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    d_kv_in = d_kv_in or d
    p = {
        "wq": dense_init(gen, d, H * Dh, dtype),
        "wk": dense_init(gen, d_kv_in, K * Dh, dtype),
        "wv": dense_init(gen, d_kv_in, K * Dh, dtype),
        "wo": dense_init(gen, H * Dh, d, dtype, scale=1.0 / math.sqrt(H * Dh)),
    }
    if cfg.qkv_bias and not cross:
        for name, width in (("bq", H * Dh), ("bk", K * Dh), ("bv", K * Dh)):
            p[name] = torch.zeros((width,), dtype=dtype, device=gen.device)
    return p


def _project_qkv(p, x, kv_x, cfg):
    B, S, _ = x.shape
    H, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = kv_x @ p["wk"]
    v = kv_x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, Dh)
    k = k.reshape(B, kv_x.shape[1], K, Dh)
    v = v.reshape(B, kv_x.shape[1], K, Dh)
    return q, k, v


def attn_apply(p, x, cfg, *, positions=None, causal: bool = True, kv_x=None,
               use_rope: bool = True, return_kv: bool = False):
    """Full-sequence attention (train / prefill). kv_x != None -> cross-attn."""
    kv_src = kv_x if kv_x is not None else x
    q, k, v = _project_qkv(p, x, kv_src, cfg)
    if use_rope:
        pos = positions if positions is not None else torch.arange(x.shape[1], device=x.device)
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos if kv_x is None else torch.arange(kv_src.shape[1], device=x.device),
                 cfg.rope_theta)
    out = gqa_attention(q, k, v, causal=causal, window=cfg.sliding_window,
                        softcap=cfg.logit_softcap)
    out = out.reshape(*x.shape[:2], -1) @ p["wo"]
    if return_kv:
        return out, (k, v)
    return out


def update_cache(cache, new, pos):
    """Write ``new`` (B, 1, K, D) into ``cache`` (B, S, K, D) at position
    ``pos``, in place (the port's form of the reference's donated cache);
    returns the cache."""
    cache[:, pos:pos + 1] = new.to(cache.dtype)
    return cache


def attn_decode(p, x, cfg, cache_k, cache_v, pos: int, *, use_rope: bool = True,
                cross: bool = False):
    """Single-token decode. x (B, 1, d); cache (B, S, K, D), written in place
    at ``pos``. Returns (out, cache_k, cache_v)."""
    B = x.shape[0]
    H, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(B, 1, H, Dh)
    if cross:
        # cross-attn: cache holds the (fixed) encoder KV; no update, no rope
        out = gqa_attention(q, cache_k, cache_v, causal=False)
        return out.reshape(B, 1, -1) @ p["wo"], cache_k, cache_v
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    k = k.reshape(B, 1, K, Dh)
    v = v.reshape(B, 1, K, Dh)
    if use_rope:
        posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        q = rope(q, posv, cfg.rope_theta)
        k = rope(k, posv, cfg.rope_theta)
    cache_k = update_cache(cache_k, k, pos)
    cache_v = update_cache(cache_v, v, pos)
    out = gqa_attention(q, cache_k, cache_v, causal=True, window=cfg.sliding_window,
                        q_offset=pos, kv_valid_len=pos + 1, softcap=cfg.logit_softcap)
    return out.reshape(B, 1, -1) @ p["wo"], cache_k, cache_v


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, d: int, f: int, dtype, *, gated: bool = True) -> dict:
    if gated:
        return {
            "wg": dense_init(gen, d, f, dtype),
            "wu": dense_init(gen, d, f, dtype),
            "wd": dense_init(gen, f, d, dtype, scale=1.0 / math.sqrt(f)),
        }
    return {
        "w1": dense_init(gen, d, f, dtype),
        "b1": torch.zeros((f,), dtype=dtype, device=gen.device),
        "w2": dense_init(gen, f, d, dtype, scale=1.0 / math.sqrt(f)),
        "b2": torch.zeros((d,), dtype=dtype, device=gen.device),
    }


def _act(x, act: str):
    # jax.nn.gelu's default is the tanh approximation
    return F.silu(x) if act == "silu" else F.gelu(x, approximate="tanh")


def mlp_apply(p, x, act: str = "silu"):
    if "wg" in p:
        g = _act(x @ p["wg"], act)
        return (g * (x @ p["wu"])) @ p["wd"]
    h = F.gelu(x @ p["w1"] + p["b1"], approximate="tanh")
    return h @ p["w2"] + p["b2"]
