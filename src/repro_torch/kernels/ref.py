"""Plain oracles for the kernels (independent implementations).

Counterpart of ``repro/kernels/ref.py``: written in the most direct form
(the Hermite gather as a one-hot matmul, the fused fit by materializing
Phi) so a kernel bug cannot hide behind code it shares with its oracle.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "ref_phi", "ref_scaled_gram", "ref_diag_quad", "ref_fused_fit_moments",
    "one_hot_selection", "phi_consts",
]


def phi_consts(eps: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """(p, 3) table of [beta, delta2, z_scale=rho*beta] per input dimension."""
    beta = (1.0 + (2.0 * eps / rho) ** 2) ** 0.25
    delta2 = 0.5 * rho**2 * (beta**2 - 1.0)
    return torch.stack([beta, delta2, rho * beta], dim=-1).to(torch.float32)


def one_hot_selection(idx: np.ndarray, n_max: int) -> np.ndarray:
    """(p*n_max, M) one-hot matrix S with S[j*n_max + d, m] = [idx[m, j] == d]."""
    M, p = idx.shape
    S = np.zeros((p * n_max, M), np.float32)
    for j in range(p):
        S[j * n_max + idx[:, j], np.arange(M)] = 1.0
    return S


def ref_phi(Xt: torch.Tensor, consts: torch.Tensor, S: torch.Tensor,
            n_max: int) -> torch.Tensor:
    """Oracle for the Hermite features: (p, N), (p, 3), (p*n_max, M) -> (N, M)."""
    p, N = Xt.shape
    out = torch.ones((N, S.shape[1]), dtype=torch.float32, device=Xt.device)
    for j in range(p):
        beta, delta2, zscale = consts[j, 0], consts[j, 1], consts[j, 2]
        x = Xt[j]
        z = zscale * x
        psis = [torch.sqrt(beta) * torch.ones_like(z)]
        if n_max > 1:
            psis.append(z * float(np.sqrt(2.0)) * psis[0])
        for i in range(2, n_max):
            psis.append(z * float(np.sqrt(2.0 / i)) * psis[-1]
                        - float(np.sqrt((i - 1.0) / i)) * psis[-2])
        feats = torch.stack(psis, dim=-1) * torch.exp(-delta2 * x * x)[:, None]
        out = out * (feats @ S[j * n_max:(j + 1) * n_max])
    return out


def ref_scaled_gram(Phi: torch.Tensor, d: torch.Tensor, sig2) -> torch.Tensor:
    """I + D (Phi^T Phi) D / sig2."""
    M = Phi.shape[1]
    d = d.reshape(-1)
    G = Phi.T @ Phi
    return torch.eye(M, dtype=torch.float32, device=Phi.device) \
        + d[:, None] * G * d[None, :] / sig2


def ref_fused_fit_moments(X, y, consts, S, d, sig2, n_max: int, scale=True):
    """Oracle for the streaming fused fit: materializes Phi (the very thing
    the kernel avoids), then reduces.  Returns (B, b) or (G, b)."""
    Phi = ref_phi(X.T, consts, S, n_max)
    b = Phi.T @ y
    if not scale:
        return Phi.T @ Phi, b
    return ref_scaled_gram(Phi, d, sig2), b


def ref_diag_quad(A: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """diag(A C A^T), shape (N,)."""
    return torch.einsum("nk,kl,nl->n", A, C, A)
