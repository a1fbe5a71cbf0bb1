"""Expansion features Phi(X) (N, M): the plain tile builders and the CUDA
kernel that replaces the TPU kernel
``repro/kernels/hermite_phi.py::hermite_phi_kernel``.

A kernel of this package receives an expansion's feature map as a
:class:`TileArgs`: the Hermite-Mercer map as its (p, 3) constants, the
(2, n) recurrence coefficients and the (M, p) int32 multi-index table; the
random-Fourier map as its (p + 1, M) [W; phase] table.  The TPU kernel took
a one-hot (p*n, M) selection matrix and gathered with its matrix unit; on
the H100 the gather is a shared-memory read through the index table
(``csrc/expansion.cuh``).

CUDA kernel: ``csrc/phi_features.cu``.  Bound on the H100: the (N, M)
float32 write (7.5 MB per 128-row serving microbatch at M = 14,641, a few
microseconds), so in practice the launch; the design keeps the write
coalesced and evaluates each row's Hermite values once per block.  Its
plain version, :func:`phi_features_plain`, is what a CPU tensor runs.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from ..core.mercer import hermite_psi_rows
from . import _build
from .rff_phi import rff_tile

__all__ = ["TileArgs", "phi_tile", "plain_tile", "phi_features_plain",
           "phi_features_cuda", "COUNTER"]

COUNTER = _build.LaunchCounter("phi_features")
KINDS = {"hermite": 0, "rff": 1}


@dataclasses.dataclass(frozen=True)
class TileArgs:
    """An expansion's feature map in the form the kernels take.

    kind:   "hermite" or "rff".
    n_max:  Hermite recurrence depth (1 for RFF).
    M:      number of features.
    consts: (p, 3) float32 [beta, delta2, rho*beta] (Hermite).
    coef:   (2, n_max) float32 recurrence coefficients (Hermite).
    idx:    (M, p) int32 multi-indices (Hermite).
    table:  (p + 1, M) float32 [W; phase] (RFF).
    """

    kind: str
    n_max: int
    M: int
    consts: Optional[torch.Tensor] = None
    coef: Optional[torch.Tensor] = None
    idx: Optional[torch.Tensor] = None
    table: Optional[torch.Tensor] = None

    def tensors(self) -> list:
        return [t for t in (self.consts, self.coef, self.idx, self.table)
                if t is not None]


def phi_tile(x: torch.Tensor, consts: torch.Tensor, idx: torch.Tensor,
             n_max: int) -> torch.Tensor:
    """(TN, p) rows -> (TN, M) Hermite-Mercer features: per dimension the
    scaled recurrence (``core/mercer.py::hermite_psi_rows``, its one home)
    times exp(-delta2 x^2), gathered through the index table and multiplied
    across dimensions in order j = 0..p-1."""
    idx = idx.to(torch.long)
    out = None
    for j in range(x.shape[1]):
        beta, delta2, zscale = consts[j, 0], consts[j, 1], consts[j, 2]
        xj = x[:, j]
        env = torch.exp(-delta2 * xj * xj)
        feats = torch.stack(hermite_psi_rows(zscale * xj, beta, n_max), dim=1)
        sel = (feats * env[:, None])[:, idx[:, j]]
        out = sel if out is None else out * sel
    return out


def plain_tile(x: torch.Tensor, tile: TileArgs) -> torch.Tensor:
    """The plain feature map of ``tile`` on rows ``x``."""
    if tile.kind == "hermite":
        return phi_tile(x, tile.consts, tile.idx, tile.n_max)
    return rff_tile(x, tile.table)


def phi_features_plain(X: torch.Tensor, tile: TileArgs) -> torch.Tensor:
    """Plain version of the features kernel: (N, p) -> (N, M)."""
    return plain_tile(X, tile)


def phi_features_cuda(X: torch.Tensor, tile: TileArgs) -> torch.Tensor:
    """Launch ``csrc/phi_features.cu`` on X's stream: (N, p) -> (N, M)."""
    N, p = X.shape
    out = torch.empty((N, tile.M), dtype=torch.float32, device=X.device)
    if N == 0 or tile.M == 0:
        return out
    lib = _build.library("phi_features")
    fn = lib.repro_phi_features
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    stream = torch.cuda.current_stream(X.device).cuda_stream
    rc = fn(_build.ptr(X), N, p, tile.M, KINDS[tile.kind], tile.n_max,
            _build.ptr(tile.consts), _build.ptr(tile.coef), _build.ptr(tile.idx),
            _build.ptr(tile.table), _build.ptr(out), ctypes.c_void_p(stream))
    _build.check_launch(rc, "phi_features")
    COUNTER.add()
    return out
