"""Plain tile builder for the random-Fourier-feature (RFF) expansions.

Counterpart of ``repro/kernels/rff_phi.py``.  Feature m of a row x is

    phi_m(x) = cos(x . W[:, m] + phase_m),   phase_m = 0 (cos half) or
    -pi/2 (sin half, cos(z - pi/2) = sin(z)),

read from the (p + 1, M) table [W; phase] that
``core/expansions.py::RandomFourierExpansion.tile_table`` builds (W carries
the sqrt(2) * eps lengthscale scaling).  The CUDA kernels evaluate the same
element as p FMAs and one ``cosf`` (``csrc/expansion.cuh::rff_feature``).
"""
from __future__ import annotations

import torch

__all__ = ["rff_tile"]


def rff_tile(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(TN, p) rows and the (p + 1, M) table -> (TN, M) features."""
    p = x.shape[1]
    return torch.cos(x @ table[:p] + table[p:p + 1])
