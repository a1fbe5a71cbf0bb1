"""Mercer-feature linear attention: the paper's kernel expansion applied to
attention.  The port of ``repro/models/mercer_attention.py``, pure tensor
code.

Softmax attention weights are a Gaussian kernel in disguise:

    exp(q·k) = e^{|q|²/2} · exp(-|q-k|²/2) · e^{|k|²/2}

and the e^{|q|²/2} factor cancels in the softmax normalization.  Replacing
the Gaussian kernel with its truncated Mercer expansion (paper Eqs. 5-6,
tensor-product over head dims with a total-degree index set) makes
attention LINEAR in sequence length:

    out(q) = φ(q)ᵀ S_v / φ(q)ᵀ s_1,
    S_v = Σ_k λ·φ(k) e^{|k|²/2} v_kᵀ   (running prefix sums when causal)

Features use degree ≤ 2 (constant + per-dim linear + pairwise terms):
M = 1 + d + d(d+1)/2 features per head, O(S·M·d) in all, no S×S matrix.
Inputs are norm-clamped, since the truncation degrades for large |q|, |k|.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["mercer_features_deg2", "mercer_linear_attention"]


def _normalize(x, target_norm: float):
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x * (target_norm / torch.clamp(n, min=1e-6))


def mercer_features_deg2(x):
    """Degree-≤2 tensor-product expansion of exp(-|x-y|²/2) features:
        φ(x) = e^{-|x|²/2} · [1, x_j, x_i x_j / √(1+δ_ij)]
    (the n≤3 Mercer tensor product truncated at total degree 2).  Returns
    (..., M) with M = 1 + d + d(d+1)/2."""
    d = x.shape[-1]
    env = torch.exp(-0.5 * torch.sum(x * x, dim=-1, keepdim=True))
    ones = torch.ones_like(env)
    outer = x[..., :, None] * x[..., None, :]
    iu = np.triu_indices(d)
    scale = torch.as_tensor(np.where(iu[0] == iu[1], 1.0, np.sqrt(2.0)), dtype=x.dtype,
                            device=x.device)
    r2 = math.sqrt(2.0)
    iu0 = torch.as_tensor(iu[0], device=x.device)
    iu1 = torch.as_tensor(iu[1], device=x.device)
    # the reference's sequence of scalings, kept for its rounding
    quad = outer[..., iu0, iu1] * scale / r2 * r2
    quad = quad / r2  # 1/sqrt(2!) Taylor factor, off-diag x sqrt2
    feats = torch.cat([ones, x, quad], dim=-1)
    return feats * env


def mercer_linear_attention(q, k, v, *, causal: bool = True, target_norm: float = 1.0):
    """q,k (B,S,H,D), v (B,S,H,Dv) -> (B,S,H,Dv) in O(S·M) (no S×S matrix).

    Inputs are norm-clamped to keep the degree-2 truncation accurate."""
    q = _normalize(q.to(torch.float32), target_norm)
    k = _normalize(k.to(torch.float32), target_norm)
    fq = mercer_features_deg2(q)                      # (B,S,H,M)
    fk = mercer_features_deg2(k)
    # e^{|k|^2/2} with normalized k is constant and cancels; keep general
    kw = torch.exp(0.5 * torch.sum(k * k, dim=-1, keepdim=True))
    fk = fk * kw
    v32 = v.to(torch.float32)
    if causal:
        Sv = torch.cumsum(fk[..., :, None] * v32[..., None, :], dim=1)   # (B,S,H,M,Dv)
        s1 = torch.cumsum(fk, dim=1)                                     # (B,S,H,M)
        num = torch.einsum("bshm,bshmd->bshd", fq, Sv)
        den = torch.einsum("bshm,bshm->bsh", fq, s1)
    else:
        Sv = torch.einsum("bshm,bshd->bhmd", fk, v32)
        s1 = torch.sum(fk, dim=1)                                        # (B,H,M)
        num = torch.einsum("bshm,bhmd->bshd", fq, Sv)
        den = torch.einsum("bshm,bhm->bsh", fq, s1)
    return (num / torch.clamp(den[..., None], min=1e-9)).to(v.dtype)
