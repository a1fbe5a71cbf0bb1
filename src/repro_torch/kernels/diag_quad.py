"""Diagonal of a quadratic form, var_i = a_i^T C a_i, without the N x N
matrix.  The CUDA kernel replaces the TPU kernel
``repro/kernels/diag_quad.py::diag_quad_kernel``.

CUDA kernel: ``csrc/diag_quad.cu``.  Bound on the H100: float32 operations
(2 N M^2 per call; 0.82 ms for a 128-row microbatch at M = 14,641, ahead of
the 0.26 ms read of C).  The A C product is computed inside the kernel in
64 x 64 tiles streamed through shared memory; the column axis fills the
card, and a second small kernel sums the per-tile partials in a fixed
order.  Its plain version, :func:`diag_quad_plain`, is what a CPU tensor
runs.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["diag_quad_plain", "diag_quad_cuda", "COUNTER"]

COUNTER = _build.LaunchCounter("diag_quad")
_TILE = 64  # column tile of csrc/diag_quad.cu


def diag_quad_plain(A: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Plain version: sum_l (A C)_il A_il -> (N,)."""
    return torch.sum((A @ C) * A, dim=1)


def diag_quad_cuda(A: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/diag_quad.cu`` on A's stream -> (N,)."""
    N, M = A.shape
    out = torch.empty((N,), dtype=torch.float32, device=A.device)
    if N == 0:
        return out
    if M == 0:
        return out.zero_()
    tiles = (M + _TILE - 1) // _TILE
    partial = torch.empty((tiles, N), dtype=torch.float32, device=A.device)
    lib = _build.library("diag_quad")
    fn = lib.repro_diag_quad
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    stream = torch.cuda.current_stream(A.device).cuda_stream
    rc = fn(_build.ptr(A), _build.ptr(C), N, M, _build.ptr(partial), _build.ptr(out),
            ctypes.c_void_p(stream))
    _build.check_launch(rc, "diag_quad")
    COUNTER.add()
    return out
