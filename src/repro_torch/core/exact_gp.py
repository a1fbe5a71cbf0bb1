"""Plain (exact) Gaussian-process regression, paper Eqs. 3-4: the O(N^3)
oracle FAGP is held against.  Counterpart of ``repro/core/exact_gp.py``:
zero-mean GP with the ARD SE (default) or Matern-5/2 kernel, Cholesky
solve of (K + sigma^2 I)."""
from __future__ import annotations

import dataclasses
import math

import torch

from .mercer import k_matern52_ard, k_se_ard

__all__ = ["ExactGPState", "KERNELS", "fit", "predict", "mean_var", "nlml"]

KERNELS = {"se": k_se_ard, "matern52": k_matern52_ard}


@dataclasses.dataclass(frozen=True, eq=False)
class ExactGPState:
    X: torch.Tensor       # (N, p) train inputs
    chol: torch.Tensor    # (N, N) lower Cholesky of K + sigma^2 I
    alpha: torch.Tensor   # (N,)   (K + sigma^2 I)^{-1} y
    eps: torch.Tensor
    noise: torch.Tensor
    kernel: str = "se"


def _solve(chol, y):
    return torch.cholesky_solve(y[:, None], chol)[:, 0]


def fit(X, y, eps, noise, kernel: str = "se") -> ExactGPState:
    N = X.shape[0]
    K = KERNELS[kernel](X, X, eps)
    Ky = K + (noise**2) * torch.eye(N, dtype=K.dtype, device=K.device)
    chol = torch.linalg.cholesky(Ky)
    return ExactGPState(X=X, chol=chol, alpha=_solve(chol, y), eps=eps,
                        noise=noise, kernel=kernel)


def predict(state: ExactGPState, Xs):
    """Posterior mean (N*,) and covariance (N*, N*)."""
    k = KERNELS[state.kernel]
    Ks = k(Xs, state.X, state.eps)
    mu = Ks @ state.alpha
    V = torch.linalg.solve_triangular(state.chol, Ks.T, upper=False)
    return mu, k(Xs, Xs, state.eps) - V.T @ V


def mean_var(state: ExactGPState, Xs):
    """Posterior mean and marginal variance (both kernels have unit prior
    variance)."""
    k = KERNELS[state.kernel]
    Ks = k(Xs, state.X, state.eps)
    mu = Ks @ state.alpha
    V = torch.linalg.solve_triangular(state.chol, Ks.T, upper=False)
    return mu, torch.clamp(1.0 - torch.sum(V * V, dim=0), min=0.0)


def nlml(X, y, eps, noise, kernel: str = "se") -> torch.Tensor:
    """Exact negative log marginal likelihood."""
    N = X.shape[0]
    K = KERNELS[kernel](X, X, eps)
    Ky = K + (noise**2) * torch.eye(N, dtype=K.dtype, device=K.device)
    chol = torch.linalg.cholesky(Ky)
    alpha = _solve(chol, y)
    return (0.5 * torch.dot(y, alpha) + torch.sum(torch.log(torch.diagonal(chol)))
            + 0.5 * N * math.log(2.0 * math.pi))
