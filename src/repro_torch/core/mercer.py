"""Mercer eigen-decomposition of the squared-exponential (SE) kernel.

Counterpart of ``repro/core/mercer.py`` (paper Eqs. 13-20, with the
``delta^2 = rho^2 / 2 (beta^2 - 1)`` correction recorded there):

    beta    = (1 + (2 eps / rho)^2)^(1/4)                      (Eq. 14)
    delta^2 = rho^2 / 2 * (beta^2 - 1)
    phi_i(x)  = gamma_i exp(-delta^2 x^2) H_{i-1}(rho beta x)  (Eq. 15)
    lambda_i  = sqrt(rho^2 / (rho^2 + delta^2 + eps^2))
                * (eps^2 / (rho^2 + delta^2 + eps^2))^(i-1)    (Eq. 16)

Tensor products over multi-indices give the p-dimensional (ARD) system
(Eqs. 17-20).  The index sets are numpy (static structure, identical to the
JAX package's); everything else is float32 torch.  ``hermite_psi_rows`` is
the one home of the gamma-scaled Hermite recurrence in this package: the
plain tile builder of the kernels (``kernels/hermite_phi.py``) calls it,
and the CUDA kernels (``kernels/csrc/expansion.cuh``) spell out the same
recurrence with the same constants.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import numpy as np
import torch

from ..device import resolve_device

__all__ = [
    "SEKernelParams",
    "mercer_constants",
    "log_eigenvalues_1d",
    "eigenvalues_1d",
    "log_eigenvalues_nd",
    "eigenvalues_nd",
    "hermite_coefficients",
    "hermite_psi_rows",
    "eigenfunctions_1d",
    "full_grid",
    "total_degree",
    "hyperbolic_cross",
    "make_index_set",
    "phi_nd",
    "k_se_ard",
    "k_matern52_ard",
]

IndexSetKind = Literal["full", "total_degree", "hyperbolic_cross"]


@dataclasses.dataclass(frozen=True, eq=False)
class SEKernelParams:
    """ARD squared-exponential kernel + Mercer-expansion hyperparameters.

    eps:   per-dimension inverse length scales, (p,). Paper's eps_j.
    rho:   per-dimension global scale factors, (p,). Paper's rho_j;
           controls eigenvalue decay speed.
    noise: observation noise std sigma_n (scalar).

    A heterogeneous ``GPBank`` stacks one set per slot: eps and rho
    (C, p), noise (C,).
    """

    eps: torch.Tensor
    rho: torch.Tensor
    noise: torch.Tensor

    @property
    def p(self) -> int:
        return self.eps.shape[-1]

    @staticmethod
    def create(eps, rho, noise=1e-2, *, device=None) -> "SEKernelParams":
        """float32 leaves on ``device`` (default "cuda"), rho broadcast to
        eps's shape."""
        dev = resolve_device(device)

        def f32(x):
            if not isinstance(x, torch.Tensor):
                x = np.array(x, dtype=np.float32)
            return torch.as_tensor(x, dtype=torch.float32, device=dev)

        eps = torch.atleast_1d(f32(eps))
        rho = torch.broadcast_to(f32(rho), eps.shape).clone()
        return SEKernelParams(eps=eps, rho=rho, noise=f32(noise))


def mercer_constants(eps: torch.Tensor, rho: torch.Tensor):
    """Paper Eq. 14 constants: (beta, delta2), broadcast over eps/rho."""
    beta = (1.0 + (2.0 * eps / rho) ** 2) ** 0.25
    delta2 = 0.5 * rho**2 * (beta**2 - 1.0)
    return beta, delta2


def log_eigenvalues_1d(n: int, eps: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """log of the Eq. 16 eigenvalues (they underflow f32 near i ~ 40, so
    every consumer works in log space).  Returns (n,)."""
    _, delta2 = mercer_constants(eps, rho)
    denom = rho**2 + delta2 + eps**2
    i = torch.arange(n, dtype=torch.float32, device=eps.device)
    return 0.5 * (torch.log(rho**2) - torch.log(denom)) + i * (
        torch.log(eps**2) - torch.log(denom)
    )


def log_eigenvalues_nd(idx: torch.Tensor, eps: torch.Tensor,
                       rho: torch.Tensor) -> torch.Tensor:
    """log lambda_n = sum_j log lambda_{n_j}  (Eq. 20).  idx (M, p) -> (M,);
    with per-slot eps and rho (C, p), the (C, M) rows of every slot."""
    if eps.ndim == 2:   # (p, C, 1): dimension j of every slot at once
        eps, rho = eps.T[..., None], rho.T[..., None]
    out = None
    for j in range(idx.shape[1]):
        _, delta2 = mercer_constants(eps[j], rho[j])
        denom = rho[j] ** 2 + delta2 + eps[j] ** 2
        i = idx[:, j].to(torch.float32)
        term = 0.5 * (torch.log(rho[j] ** 2) - torch.log(denom)) + i * (
            torch.log(eps[j] ** 2) - torch.log(denom)
        )
        out = term if out is None else out + term
    return out


def eigenvalues_1d(n: int, eps: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """Paper Eq. 16: the first ``n`` SE-kernel eigenvalues for one dimension."""
    return torch.exp(log_eigenvalues_1d(n, eps, rho))


def eigenvalues_nd(idx: torch.Tensor, eps: torch.Tensor,
                   rho: torch.Tensor) -> torch.Tensor:
    """lambda_n = prod_j lambda_{n_j}  (Eq. 20).  idx (M, p) -> (M,)."""
    return torch.exp(log_eigenvalues_nd(idx, eps, rho))


def hermite_coefficients(n: int) -> np.ndarray:
    """(2, n) float32 table of the recurrence constants: row 0 holds
    sqrt(2 / i), row 1 sqrt((i - 1) / i), each rounded once from float64
    (entries 0 and 1 of row 1 are unused).  The CUDA kernels compute the
    same values the same way, so the two implementations cannot drift."""
    i = np.arange(n, dtype=np.float64)
    i[0] = 1.0
    a = np.sqrt(2.0 / i)
    b = np.sqrt((i - 1.0) / i)
    return np.stack([a, b]).astype(np.float32)


def hermite_psi_rows(z: torch.Tensor, beta: torch.Tensor, n: int) -> list:
    """THE single home of the gamma-scaled Hermite recurrence.

    With z = rho*beta*x and psi_i = gamma_i H_{i-1}(z):

        psi_1     = sqrt(beta)
        psi_2     = sqrt(2) z psi_1
        psi_{i+1} = z sqrt(2/i) psi_i - sqrt((i-1)/i) psi_{i-1}

    Returns the list [psi_1 .. psi_n] shaped like ``z``, without the
    Gaussian envelope.

    A step rounds once, as the kernels' fused multiply-add does: z sqrt(2/i)
    is rounded to z's dtype, then its product with psi_i and the difference
    are formed in float64 (the product of two float32 values is exact there)
    and rounded back.  Rounding the product first, then the difference,
    leaves psi near a zero of H_{i-1}, where the step cancels, outside the
    kernels' gate.  The step stays differentiable.
    """
    coef = hermite_coefficients(max(n, 2))
    psi_prev = torch.sqrt(beta) * torch.ones_like(z)
    rows = [psi_prev]
    if n > 1:
        psi_cur = z * float(np.float32(np.sqrt(2.0))) * psi_prev
        rows.append(psi_cur)
        for i in range(2, n):
            zc = z * float(coef[0, i])
            nxt = (zc.double() * psi_cur.double()
                   - (float(coef[1, i]) * psi_prev).double()).to(zc.dtype)
            psi_prev, psi_cur = psi_cur, nxt
            rows.append(nxt)
    return rows


def eigenfunctions_1d(x: torch.Tensor, n: int, eps: torch.Tensor,
                      rho: torch.Tensor) -> torch.Tensor:
    """Paper Eq. 15 for one input dimension: x (...,) -> (..., n)."""
    beta, delta2 = mercer_constants(eps, rho)
    z = rho * beta * x
    envelope = torch.exp(-delta2 * x * x)
    psis = torch.stack(hermite_psi_rows(z, beta, n), dim=-1)
    return psis * envelope[..., None]


# ---------------------------------------------------------------------------
# Multi-index sets (numpy: static structure, identical to the JAX package)
# ---------------------------------------------------------------------------


def full_grid(n: int, p: int) -> np.ndarray:
    """Paper Eq. 18: all n^p combinations. (M, p) int32, degrees 0-based."""
    grids = np.meshgrid(*[np.arange(n)] * p, indexing="ij")
    return np.stack([g.reshape(-1) for g in grids], axis=-1).astype(np.int32)


def total_degree(n: int, p: int, degree: Optional[int] = None) -> np.ndarray:
    """Multi-indices with sum of (0-based) degrees <= degree."""
    if degree is None:
        degree = n - 1
    idx = full_grid(min(n, degree + 1), p)
    return np.ascontiguousarray(idx[idx.sum(axis=1) <= degree])


def hyperbolic_cross(n: int, p: int, degree: Optional[int] = None) -> np.ndarray:
    """Multi-indices with prod of (1-based) degrees <= degree."""
    if degree is None:
        degree = n
    idx = full_grid(min(n, degree), p)
    return np.ascontiguousarray(idx[np.prod(idx + 1, axis=1) <= degree])


def make_index_set(kind: IndexSetKind, n: int, p: int,
                   degree: Optional[int] = None) -> np.ndarray:
    if kind == "full":
        return full_grid(n, p)
    if kind == "total_degree":
        return total_degree(n, p, degree)
    if kind == "hyperbolic_cross":
        return hyperbolic_cross(n, p, degree)
    raise ValueError(f"unknown index set kind: {kind!r}")


# ---------------------------------------------------------------------------
# N-dimensional eigensystem and exact kernels
# ---------------------------------------------------------------------------


def phi_nd(X: torch.Tensor, idx: torch.Tensor, eps: torch.Tensor,
           rho: torch.Tensor, n_max: int) -> torch.Tensor:
    """Phi_(X) (Eq. 19): (N, p) -> (N, M), Phi[a, m] = prod_j
    phi_{idx[m, j]}(X[a, j]).  The plain reference path; the CUDA kernels
    fuse the same computation."""
    idx = idx.to(torch.long)
    out = None
    for j in range(X.shape[1]):
        f_j = eigenfunctions_1d(X[:, j], n_max, eps[j], rho[j])  # (N, n_max)
        sel = f_j[:, idx[:, j]]
        out = sel if out is None else out * sel
    return out


def k_se_ard(X: torch.Tensor, X2: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """Exact ARD SE kernel (Eq. 17): exp(-sum_j eps_j^2 (x_j - x'_j)^2)."""
    d = X[:, None, :] - X2[None, :, :]
    return torch.exp(-torch.sum((eps**2) * d * d, dim=-1))


def k_matern52_ard(X: torch.Tensor, X2: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """Exact ARD Matern-5/2 kernel in the SE lengthscale convention
    (l = 1 / (sqrt(2) eps)): r^2 = 2 sum_j eps_j^2 (x_j - x'_j)^2,
    k(r) = (1 + sqrt(5) r + 5 r^2 / 3) exp(-sqrt(5) r)."""
    d = X[:, None, :] - X2[None, :, :]
    r2 = 2.0 * torch.sum((eps**2) * d * d, dim=-1)
    r = torch.sqrt(torch.clamp(r2, min=1e-30))
    s5r = float(np.sqrt(5.0)) * r
    return (1.0 + s5r + (5.0 / 3.0) * r2) * torch.exp(-s5r)
