"""KernelExpansion: the pluggable kernel decomposition.

Counterpart of ``repro/core/expansions.py``.  An expansion supplies the
static (M, w) index table (its row count is the feature count M), the log
weights consumed by the scaled solve, a plain feature map (N, M), the
exact kernel it decomposes, and its feature map in the form the CUDA
kernels take (:class:`~repro_torch.kernels.hermite_phi.TileArgs`).

Registered: ``hermite`` (the paper's Hermite-Mercer eigen-expansion of the
SE kernel), ``rff_se`` and ``rff_matern52`` (random Fourier features;
M = 2R paired cos/sin columns, base draws stored eps-free on the spec).
The RFF draws use the same numpy generator as the JAX package, so one seed
gives bit-identical ``omega`` in both packages.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..kernels.hermite_phi import TileArgs
from ..kernels.ref import phi_consts
from . import mercer

__all__ = [
    "KernelExpansion",
    "HermiteMercerExpansion",
    "RandomFourierExpansion",
    "register_expansion",
    "get_expansion",
    "available_expansions",
]

# the JAX package's Pallas kernels unroll the Hermite recurrence up to this
# depth and refuse deeper specs; the port keeps the same refusal so a spec
# carries across unchanged
_PALLAS_MAX_N = 64


class KernelExpansion:
    """Protocol (duck-typed base) for a pluggable kernel decomposition;
    ``spec`` is a :class:`repro_torch.core.fagp.GPSpec`."""

    name: str = "?"

    def validate(self, spec) -> None:
        """Raise ValueError when the spec is malformed for this expansion."""

    def indices(self, spec, p: Optional[int] = None) -> np.ndarray:
        raise NotImplementedError

    def draw_spec_data(self, p: int, num_features: int, seed: int):
        """Random data leaves (``GPSpec.omega``) as a float32 numpy array,
        or None for deterministic expansions."""
        return None

    def log_eigenvalues(self, idx: torch.Tensor, spec) -> torch.Tensor:
        raise NotImplementedError

    def features(self, X: torch.Tensor, idx: torch.Tensor, spec) -> torch.Tensor:
        raise NotImplementedError

    def exact_kernel(self, Xa: torch.Tensor, Xb: torch.Tensor, spec) -> torch.Tensor:
        raise NotImplementedError

    def pallas_supports(self, spec) -> Optional[str]:
        """None when the kernel path can run this spec, else a reason."""
        return None

    def tile_args(self, spec, idx: torch.Tensor) -> TileArgs:
        """The feature map in the form the kernels take."""
        raise NotImplementedError

    def slot_tile_args(self, spec, idx: torch.Tensor, eps: torch.Tensor,
                       rho: torch.Tensor) -> TileArgs:
        """A stacked tile: slot s's map under (eps[s], rho[s]) (C, p) and
        the spec's structure, each slot's map the one ``tile_args`` builds
        for that spec."""
        raise NotImplementedError


class HermiteMercerExpansion(KernelExpansion):
    """Tensor-product Hermite eigenfunctions of the ARD SE kernel (paper
    Eqs. 13-20), truncated by a multi-index set; math in ``core/mercer.py``."""

    name = "hermite"

    def validate(self, spec) -> None:
        if spec.n < 1:
            raise ValueError(f"hermite expansion needs n >= 1, got {spec.n}")
        if spec.index_set not in ("full", "total_degree", "hyperbolic_cross"):
            raise ValueError(f"unknown index set {spec.index_set!r}")

    def indices(self, spec, p: Optional[int] = None) -> np.ndarray:
        return mercer.make_index_set(spec.index_set, spec.n, p or spec.p, spec.degree)

    def log_eigenvalues(self, idx, spec):
        return mercer.log_eigenvalues_nd(idx, spec.eps, spec.rho)

    def features(self, X, idx, spec):
        return mercer.phi_nd(X, idx, spec.eps, spec.rho, spec.n)

    def exact_kernel(self, Xa, Xb, spec):
        return mercer.k_se_ard(Xa, Xb, spec.eps)

    def pallas_supports(self, spec) -> Optional[str]:
        if spec.n > _PALLAS_MAX_N:
            return (
                f"n={spec.n} exceeds the Hermite recurrence depth the "
                f"kernels are built for (max {_PALLAS_MAX_N}); use "
                f"backend='jnp'"
            )
        return None

    def tile_args(self, spec, idx):
        dev = spec.eps.device
        return TileArgs(
            kind="hermite", n_max=spec.n, M=int(idx.shape[0]),
            consts=phi_consts(spec.eps, spec.rho).contiguous(),
            coef=torch.from_numpy(mercer.hermite_coefficients(max(spec.n, 2))).to(dev),
            idx=idx.to(device=dev, dtype=torch.int32).contiguous(),
        )

    def slot_tile_args(self, spec, idx, eps, rho):
        return dataclasses.replace(self.tile_args(spec, idx),
                                   consts=phi_consts(eps, rho).contiguous())


class RandomFourierExpansion(KernelExpansion):
    """Random Fourier features of a stationary kernel: M = 2R cos/sin
    columns, flat weights 1/R, spectral base draws on ``GPSpec.omega``
    scaled by sqrt(2) * eps inside the feature map.  ``kernel`` is 'se'
    (Gaussian frequencies) or 'matern52' (multivariate-t, 5 dof)."""

    def __init__(self, kernel: str):
        if kernel not in ("se", "matern52"):
            raise ValueError(f"unknown RFF kernel family {kernel!r}")
        self.kernel = kernel
        self.name = f"rff_{kernel}"

    def validate(self, spec) -> None:
        if spec.omega is None:
            raise ValueError(
                f"{self.name} needs spectral base draws on the spec; build "
                f"it with GPSpec.create(..., expansion={self.name!r}, "
                f"num_features=R, seed=...) or GPSpec.create_rff(...)"
            )
        if tuple(spec.omega.shape) != (spec.omega.shape[0], spec.p):
            raise ValueError(
                f"{self.name}: omega must be (R, p={spec.p}), got "
                f"{tuple(spec.omega.shape)}"
            )

    def indices(self, spec, p: Optional[int] = None) -> np.ndarray:
        self.validate(spec)
        return np.arange(2 * spec.omega.shape[0], dtype=np.int32).reshape(-1, 1)

    def draw_spec_data(self, p: int, num_features: int, seed: int):
        rng = np.random.default_rng(seed)
        z = rng.standard_normal((num_features, p))
        if self.kernel == "matern52":
            g = rng.chisquare(5.0, size=(num_features, 1))
            z = z * np.sqrt(5.0 / g)
        return z.astype(np.float32)

    def log_eigenvalues(self, idx, spec):
        M = idx.shape[0]
        return torch.full((M,), -math.log(M / 2.0), dtype=torch.float32,
                          device=spec.eps.device)

    def _scaled_freqs(self, spec, eps=None) -> torch.Tensor:
        """(R, p) frequencies sqrt(2) * eps (.) omega (the one place the
        lengthscale scaling is applied); per-slot eps (C, p) gives
        (C, R, p)."""
        eps = spec.eps if eps is None else eps
        return float(np.float32(np.sqrt(2.0))) * eps[..., None, :] * spec.omega

    def features(self, X, idx, spec):
        Z = X @ self._scaled_freqs(spec).T
        return torch.cat([torch.cos(Z), torch.sin(Z)], dim=1)

    def exact_kernel(self, Xa, Xb, spec):
        if self.kernel == "se":
            return mercer.k_se_ard(Xa, Xb, spec.eps)
        return mercer.k_matern52_ard(Xa, Xb, spec.eps)

    def tile_args(self, spec, idx):
        return self._tile(self._scaled_freqs(spec).mT)

    def slot_tile_args(self, spec, idx, eps, rho):
        return self._tile(self._scaled_freqs(spec, eps).mT)

    @staticmethod
    def _tile(Wt: torch.Tensor) -> TileArgs:
        """The [W; phase] table from W^T (p, R), or (C, p, R) per slot."""
        R = Wt.shape[-1]
        dev = Wt.device
        phase = torch.cat([
            torch.zeros((1, R), dtype=torch.float32, device=dev),
            torch.full((1, R), -0.5 * math.pi, dtype=torch.float32, device=dev),
        ], dim=1).expand(Wt.shape[:-2] + (1, 2 * R))
        table = torch.cat([torch.cat([Wt, Wt], dim=-1), phase], dim=-2)
        return TileArgs(kind="rff", n_max=1, M=2 * R, table=table.contiguous())


_EXPANSIONS: dict = {}


def register_expansion(expansion: KernelExpansion) -> None:
    _EXPANSIONS[expansion.name] = expansion


def get_expansion(name: str) -> KernelExpansion:
    try:
        return _EXPANSIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown kernel expansion {name!r}; registered: "
            f"{available_expansions()}"
        ) from None


def available_expansions() -> list:
    return sorted(_EXPANSIONS)


register_expansion(HermiteMercerExpansion())
register_expansion(RandomFourierExpansion("se"))
register_expansion(RandomFourierExpansion("matern52"))
